"""Device compute ops: the ODE right-hand side as one fused XLA
computation, its per-variable accumulation strategies, the fused
multi-step Pallas chunk kernel for GPUs, the one function that chooses
between kernel and scan path, and the NumPy oracle transcription of the
reference kernel used as the test ground truth."""

from odesat_tpu.ops.fused_pallas import fused_supported, make_fused_chunk
from odesat_tpu.ops.rhs import (
    accumulate_dv_gather,
    accumulate_dv_onehot,
    accumulate_dv_segment,
    build_onehot,
    clause_values,
    compute_derivatives,
    top2_min,
)
from odesat_tpu.ops.select import resolve_strategy

__all__ = [
    "accumulate_dv_gather",
    "accumulate_dv_onehot",
    "accumulate_dv_segment",
    "build_onehot",
    "clause_values",
    "compute_derivatives",
    "fused_supported",
    "make_fused_chunk",
    "resolve_strategy",
    "top2_min",
]
