"""The one place that chooses between the fused kernel and the scan path.

``dv_strategy`` names how the per-variable derivative is accumulated:

* ``"auto"``: the fused Pallas kernel (ops/fused_pallas.py) when a GPU
  is present and the formula and config suit it, else the XLA scan path
  with ``segment_sum`` for wide occurrence tables (``max_occ > 32``) and
  ``gather`` otherwise;
* ``"fused"``: the kernel, or a clear error when it cannot run here;
* ``"gather"``, ``"segment_sum"``, ``"onehot"``: the scan path with that
  accumulator.

A kernel never falls back to the Pallas interpreter: an explicit kernel
request on a host without a GPU raises. Only tests interpret kernels,
by calling them with ``interpret=True``.
"""

from __future__ import annotations

import jax

SCAN_STRATEGIES = ("gather", "segment_sum", "onehot")
STRATEGIES = ("auto", "fused") + SCAN_STRATEGIES


def gpu_available() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"


def require_gpu(what: str) -> None:
    if not gpu_available():
        raise ValueError(
            f"{what} runs a GPU kernel, and JAX found no GPU here (backend "
            f"{jax.default_backend()!r}); use dv_strategy='auto' or a scan "
            "strategy (gather, segment_sum, onehot)"
        )


def scan_strategy(fa) -> str:
    """The scan path's accumulator for ``auto``: wide occurrence tables
    make the variable-major gather pay N*D >> nnz, so they scatter-add."""
    return "segment_sum" if fa.max_occ > 32 else "gather"


def kernel_eligible(fa, ode) -> bool:
    """Build-free check that the fused kernel can run this formula and
    config (not whether a GPU is present)."""
    from odesat_tpu.ops.fused_pallas import fused_supported

    return (
        ode.dtype == "float32"
        and not (ode.dt_mode == "shared" and ode.step_size is None)
        and fused_supported(fa)
    )


def resolve_strategy(fa, ode, clause_sharded: bool = False) -> str:
    """Resolve ``ode.dv_strategy`` to ``"fused"`` or a scan accumulator.

    ``clause_sharded``: the step runs under a clause mesh axis, where
    the whole-chunk kernel cannot reduce dv across devices mid-step."""
    strategy = ode.dv_strategy
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown dv_strategy {strategy!r}; expected one of {STRATEGIES}")
    if strategy == "fused":
        if clause_sharded:
            raise ValueError(
                "dv_strategy='fused' does not support a clause mesh axis; "
                "use dv_strategy='auto' or a trajectory-only mesh"
            )
        require_gpu("dv_strategy='fused'")
        return "fused"
    if strategy == "auto":
        if not clause_sharded and gpu_available() and kernel_eligible(fa, ode):
            return "fused"
        return scan_strategy(fa)
    return strategy
