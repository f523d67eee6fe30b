"""Fused multi-step Pallas chunk kernel (Triton route) vs the lax.scan
path and the NumPy oracle: states must agree after a whole chunk, for
both integrators and both rigidities (interpret mode on CPU), and the
kernel must lower for CUDA with the precision it promises."""

import jax
import numpy as np
import pytest

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
from odesat_tpu.models.ode import formula_device, init_state, make_step_fn
from odesat_tpu.ops.fused_pallas import fused_supported, make_fused_chunk
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.generate import random_ksat

TOL = dict(rtol=2e-4, atol=2e-5)


def _fixture(seed=0, n_vars=30, n_clauses=80, **compile_kw):
    formula = random_ksat(n_vars, n_clauses, k=3, seed=seed)
    _, normalized = normalize_cnf_variables(formula)
    return compile_formula(normalized, **compile_kw)


def _scan(fa, ode, state, steps, zeta):
    step = make_step_fn(fa, zeta, ode)
    dev = formula_device(fa)
    for _ in range(steps):
        state = step(state, dev)
    return state


def _assert_states_close(out, ref, tol=TOL, dt=False):
    for name in ("v", "xs", "xl") + (("dt",) if dt else ()):
        np.testing.assert_allclose(np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)), **tol)
    np.testing.assert_array_equal(np.asarray(out.done), np.asarray(ref.done))


@pytest.mark.parametrize("n_clauses", [80, 300])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_chunk_matches_scan(mode, seed, n_clauses):
    """The kernel walks the clause axis in 32-clause tiles: 4 tiles for
    80 clauses (padded to 128), 12 for 300 (padded to 384), so the
    per-tile xs/xl writes and the dv accumulation across tiles are
    exercised."""
    fa = _fixture(seed, n_clauses=n_clauses)
    assert fused_supported(fa)
    ode = ODEConfig(
        step_size=0.02 if mode == "fixed" else None,
        tolerance=1e-3,
        dv_strategy="gather",
    )
    zeta = 0.05
    state0 = init_state(fa, 8, jax.random.PRNGKey(seed), ode)

    steps = 12
    ref = _scan(fa, ode, state0, steps, zeta)
    fused = make_fused_chunk(fa, zeta, ode, steps, interpret=True)
    _assert_states_close(fused(state0), ref, dt=mode == "adaptive")


@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_fused_chunk_matches_oracle(mode, rigidity):
    """The kernel against the scalar-loop NumPy transcription of the
    reference (ops/oracle.py, f64), one trajectory padded to a block."""
    from tests.test_integrators import _oracle_adaptive, _oracle_fixed
    from tests.conftest import random_formula

    rng = np.random.default_rng(29)
    formula = random_formula(rng, 12, 28, max_width=3, min_width=2)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized, clause_pad=8, var_pad=8)  # Mp=32, Np=16
    v0 = rng.uniform(-1, 1, size=fa.n_vars_padded).astype(np.float32)
    zeta, steps = 0.01, 8
    ode = ODEConfig(step_size=0.05 if mode == "fixed" else None, tolerance=1e-3, rigidity=rigidity)
    state0 = init_state(fa, 1, jax.random.PRNGKey(0), ode, v0=v0)
    out = make_fused_chunk(fa, zeta, ode, steps, interpret=True)(state0)
    v64 = v0.astype(np.float64)
    if mode == "fixed":
        v_o, xs_o, xl_o = _oracle_fixed(normalized, fa, v64, 0.05, steps, zeta, rigidity)
    else:
        v_o, xs_o, xl_o, dt_o = _oracle_adaptive(normalized, fa, v64, 1e-3, steps, zeta, rigidity)
        np.testing.assert_allclose(float(out.dt[0]), dt_o, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out.v)[0], v_o, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.xs)[0], xs_o, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.xl)[0], xl_o, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_fused_bf16_stays_within_bound(mode):
    """bf16 dot operands round v to 8 mantissa bits, so the kernel only
    tracks the f32 scan path loosely: a few steps stay within 2e-2."""
    fa = _fixture(2)
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None, matmul_dtype="bfloat16")
    state0 = init_state(fa, 8, jax.random.PRNGKey(2), ode)
    ref = _scan(fa, ODEConfig(step_size=ode.step_size, dv_strategy="gather"), state0, 4, 0.05)
    out = make_fused_chunk(fa, 0.05, ode, 4, interpret=True)(state0)
    np.testing.assert_allclose(np.asarray(out.v), np.asarray(ref.v), atol=2e-2)
    np.testing.assert_allclose(np.asarray(out.xs), np.asarray(ref.xs), atol=2e-2)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_fused_freeze_preserves_solution(mode):
    """A solved trajectory entering a fused chunk must come out unchanged
    (up to idempotent clamps)."""
    fa = _fixture(3, n_vars=30, n_clauses=40)
    ode = ODEConfig(step_size=0.05 if mode == "fixed" else None)
    state = init_state(fa, 16, jax.random.PRNGKey(3), ode)

    fused = make_fused_chunk(fa, 0.05, ode, 60, interpret=True)
    out1 = fused(state)
    done1 = np.asarray(out1.done)
    assert done1.any(), "fixture must solve some trajectory within 60 steps"
    out2 = fused(out1)
    np.testing.assert_array_equal(np.asarray(out2.v)[done1], np.asarray(out1.v)[done1])
    np.testing.assert_array_equal(np.asarray(out2.dt)[done1], np.asarray(out1.dt)[done1])


@pytest.mark.parametrize("B", [1, 5, 17, 100])
def test_fused_odd_batch_sizes(B):
    """Batches that are not a multiple of the block are padded internally
    with frozen rows."""
    fa = _fixture(6)
    ode = ODEConfig(step_size=0.02)
    state = init_state(fa, B, jax.random.PRNGKey(6), ode)
    fused = make_fused_chunk(fa, 0.05, ode, 5, interpret=True)
    out = fused(state)
    assert out.v.shape == (B, fa.n_vars_padded)
    ref = _scan(fa, ODEConfig(step_size=0.02, dv_strategy="gather"), state, 5, 0.05)
    _assert_states_close(out, ref)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_fused_width_buckets_and_odd_vars(mode):
    """Mixed clause widths in width buckets (a clause axis of 3 x 128)
    and a variable axis padded to 24, which the wrapper pads to 32."""
    from tests.conftest import random_formula

    rng = np.random.default_rng(8)
    formula = random_formula(rng, 20, 300, max_width=4, min_width=2)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized, bucket=True, min_bucket=64, var_pad=8)
    assert len(fa.bucket_slices) > 1 and fa.n_vars_padded == 24
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None, dv_strategy="gather")
    state0 = init_state(fa, 8, jax.random.PRNGKey(8), ode)
    ref = _scan(fa, ode, state0, 6, 0.05)
    out = make_fused_chunk(fa, 0.05, ode, 6, interpret=True)(state0)
    _assert_states_close(out, ref, dt=mode == "adaptive")


def test_fused_explicit_runner_without_gpu_raises():
    """An explicit kernel request on a host without a GPU raises; it
    never falls back to the interpreter."""
    from odesat_tpu.models.ode import make_chunk_runner

    fa = _fixture(4)
    ode = ODEConfig(step_size=0.02, dv_strategy="fused")
    with pytest.raises(ValueError, match="no GPU"):
        make_chunk_runner(fa, 0.05, ode, 10)
    with pytest.raises(ValueError, match="no GPU"):
        make_fused_chunk(fa, 0.05, ode, 10)  # interpret defaults to False


def test_fused_rejects_float64():
    """f64 runs must not silently downcast through the f32 kernel
    (reference is f64 throughout, src/system.rs:6-11)."""
    fa = _fixture()
    with pytest.raises(ValueError, match="float64"):
        make_fused_chunk(fa, 0.001, ODEConfig(step_size=0.01, dtype="float64"), 4, interpret=True)


def test_fused_rejects_shared_dt():
    fa = _fixture()
    ode = ODEConfig(dt_mode="shared", dv_strategy="fused")
    with pytest.raises(ValueError, match="shared"):
        make_fused_chunk(fa, 0.001, ode, 4, interpret=True)


def test_fused_rejects_unit_clauses():
    from odesat_tpu.cnf.formula import CNFFormula, Literal

    fa = compile_formula(CNFFormula([(Literal(0),), (Literal(0, True), Literal(1))], 2))
    assert not fused_supported(fa)
    with pytest.raises(ValueError, match="unit clauses"):
        make_fused_chunk(fa, 0.001, ODEConfig(step_size=0.01), 4, interpret=True)


@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_fused_exact_zero_clause_values(rigidity):
    """v pinned at exactly +-1 makes satisfied literals' clause values
    exactly 0.0 — the only state where the reference-mode gate
    (valk == c, src/system.rs:73) actually fires, and the edge the
    A1/A2 contribution forms (where(is_min, A2 + b*valk, A1) and the
    gated b*valk; ops/fused_pallas.py) must keep f32-exact vs the scan
    path."""
    import jax.numpy as jnp

    fa = _fixture(5)
    ode = ODEConfig(step_size=0.02, rigidity=rigidity)
    state0 = init_state(fa, 8, jax.random.PRNGKey(5), ode)
    v = np.asarray(state0.v).copy()
    # pin every other variable to an exact +-1 so some clauses hold a
    # zero-value literal while others stay unsatisfied
    v[:, 0::2] = np.where(v[:, 0::2] >= 0, 1.0, -1.0)
    state0 = state0._replace(v=jnp.asarray(v))

    steps = 8
    ref = _scan(fa, ode, state0, steps, 0.05)
    out = make_fused_chunk(fa, 0.05, ode, steps, interpret=True)(state0)
    _assert_states_close(out, ref)


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_fused_lowers_for_cuda_through_triton(mode, matmul_dtype):
    """The kernel lowers for CUDA through the Triton route on a host
    without a GPU (the card's compiler then takes the Triton IR). f32
    dots ask for IEEE input precision — never TF32 — and bf16 dots take
    bf16 operands."""
    from odesat_tpu.ops import fused_pallas, select

    fa = _fixture(7)
    ode = ODEConfig(step_size=0.01 if mode == "fixed" else None, matmul_dtype=matmul_dtype)
    orig = select.gpu_available
    try:
        select.gpu_available = lambda: True
        kernel = fused_pallas.make_fused_chunk(fa, 0.001, ode, 4)
    finally:
        select.gpu_available = orig
    state = init_state(fa, 64, jax.random.PRNGKey(0), ode)
    text = kernel._core.trace(state, *kernel._extra).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "odesat_fused_chunk" in text
    # every dot takes bf16 operands (never f32, which Triton would run as
    # TF32 at default precision); f32 mode sums three bf16 parts per dot
    jaxpr = str(jax.make_jaxpr(kernel._core)(state, *kernel._extra))
    dots = [line for line in jaxpr.splitlines() if "dot_general[" in line]
    passes = (1 if mode == "fixed" else 2) * (3 if matmul_dtype == "float32" else 1)
    assert len(dots) == 2 * fa.max_width * passes  # forward + transposed per slot
    assert "Precision.HIGH" not in jaxpr
