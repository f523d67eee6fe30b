"""Shape-cached kernel reuse: two *different* formulas with identical
shape signatures must share one jitted kernel yet produce their own
correct dynamics (the incidence rides as arguments — a regression here
means something got baked as a compile-time constant again)."""

import jax
import numpy as np

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
import pytest

from odesat_tpu.models.ode import formula_device, init_state, make_step_fn
from odesat_tpu.ops.fused_pallas import _JIT_CACHE as FUSED_CACHE
from odesat_tpu.ops.fused_pallas import make_fused_chunk
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.generate import random_ksat


def _two_same_shape_formulas(seed_a=21, seed_b=22, n=24, m=64):
    fas = []
    for seed in (seed_a, seed_b):
        _, norm = normalize_cnf_variables(random_ksat(n, m, k=3, seed=seed))
        fas.append(compile_formula(norm))
    a, b = fas
    assert a.lit_var.shape == b.lit_var.shape
    assert (a.lit_var != b.lit_var).any()  # genuinely different formulas
    return a, b


def _scan_ref(fa, ode, state, steps, zeta=0.05):
    step = make_step_fn(fa, zeta, ode)
    dev = formula_device(fa)
    for _ in range(steps):
        state = step(state, dev)
    return state


def test_fused_cache_not_stale_across_formulas():
    fa_a, fa_b = _two_same_shape_formulas()
    ode = ODEConfig(step_size=0.02, dv_strategy="gather")
    n_before = len(FUSED_CACHE)
    fn_a = make_fused_chunk(fa_a, 0.05, ode, 8, interpret=True)
    fn_b = make_fused_chunk(fa_b, 0.05, ode, 8, interpret=True)
    assert len(FUSED_CACHE) == n_before + 1  # one shared jitted kernel

    state = init_state(fa_a, 8, jax.random.PRNGKey(0), ode)
    out_a = fn_a(state)
    out_b = fn_b(state)
    ref_a = _scan_ref(fa_a, ode, state, 8)
    ref_b = _scan_ref(fa_b, ode, state, 8)
    np.testing.assert_allclose(np.asarray(out_a.v), np.asarray(ref_a.v), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out_b.v), np.asarray(ref_b.v), rtol=2e-4, atol=2e-5)
    assert np.abs(np.asarray(out_a.v) - np.asarray(out_b.v)).max() > 1e-3


@pytest.mark.parametrize(
    "change",
    [
        dict(zeta=0.06),
        dict(chunk_steps=9),
        dict(ode=ODEConfig(step_size=0.02, rigidity="reference")),
        dict(ode=ODEConfig(step_size=0.02, matmul_dtype="bfloat16")),
        dict(ode=ODEConfig(tolerance=1e-3)),
    ],
    ids=["zeta", "chunk", "rigidity", "bf16", "adaptive"],
)
def test_fused_cache_keys_on_what_the_program_bakes_in(change):
    """zeta, the chunk length, the rigidity, the dot dtype and the
    integrator are compile-time constants of the kernel: changing any of
    them must build a new program, and the same arguments must hit."""
    fa, _ = _two_same_shape_formulas(seed_a=51, seed_b=52)
    args = dict(zeta=0.05, ode=ODEConfig(step_size=0.02), chunk_steps=8)
    first = make_fused_chunk(fa, args["zeta"], args["ode"], args["chunk_steps"], interpret=True)
    again = make_fused_chunk(fa, args["zeta"], args["ode"], args["chunk_steps"], interpret=True)
    assert again._core is first._core
    args.update(change)
    other = make_fused_chunk(fa, args["zeta"], args["ode"], args["chunk_steps"], interpret=True)
    assert other._core is not first._core


def test_fused_dp_program_shared_across_formulas(interpret_kernel):
    """On a trajectory-only mesh the sharded fused program is cached per
    (kernel shape, mesh): a second same-shaped formula reuses it and
    still gets its own dynamics."""
    from odesat_tpu.parallel import sharded as sh
    from odesat_tpu.parallel.mesh import make_mesh

    fa_a, fa_b = _two_same_shape_formulas(seed_a=61, seed_b=62)
    ode = ODEConfig(step_size=0.02)
    mesh = make_mesh(8, 1)
    n0 = len(sh._SHARDED_PROGRAM_CACHE)
    run_a = sh.make_sharded_chunk_runner(fa_a, 0.05, ode, 6, mesh)
    run_b = sh.make_sharded_chunk_runner(fa_b, 0.05, ode, 6, mesh)
    assert len(sh._SHARDED_PROGRAM_CACHE) == n0 + 1
    state = init_state(fa_a, 16, jax.random.PRNGKey(3), ode)
    dev_a = formula_device(fa_a)
    out_b = run_b(jax.tree.map(lambda x: x.copy(), state), formula_device(fa_b))
    out_a = run_a(jax.tree.map(lambda x: x.copy(), state), dev_a)
    ref_b = _scan_ref(fa_b, ode, state, 6)
    np.testing.assert_allclose(np.asarray(out_b.v), np.asarray(ref_b.v), rtol=2e-4, atol=2e-5)
    assert np.abs(np.asarray(out_a.v) - np.asarray(out_b.v)).max() > 1e-3
