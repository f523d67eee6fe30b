"""The fused kernel compiled for the card (no interpreter): parity with
the scan path and the runner's path choice. These tests need a CUDA GPU
and skip elsewhere; on a card run

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import jax
import numpy as np
import pytest

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.generate import random_ksat

pytestmark = pytest.mark.gpu


def _fa():
    _, normalized = normalize_cnf_variables(random_ksat(100, 420, k=3, seed=4))
    return compile_formula(normalized)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_compiled_kernel_matches_scan(gpu, mode):
    from odesat_tpu.ops.fused_pallas import make_fused_chunk

    fa = _fa()
    ode = ODEConfig(step_size=0.01 if mode == "fixed" else None, dv_strategy="gather")
    state = init_state(fa, 1000, jax.random.PRNGKey(1), ode)
    ref = make_chunk_runner(fa, 0.01, ode, 8, donate=False)(state, formula_device(fa))
    out = make_fused_chunk(fa, 0.01, ode, 8)(state)
    for name in ("v", "xs", "xl", "dt"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-5
        )
    np.testing.assert_array_equal(np.asarray(out.done), np.asarray(ref.done))


def test_auto_picks_the_kernel_on_a_gpu(gpu):
    fa = _fa()
    runner = make_chunk_runner(fa, 0.01, ODEConfig(step_size=0.01), 4)
    assert getattr(runner, "_core", None) is not None
