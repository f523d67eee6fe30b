"""Integrator semantics vs an oracle transcription of the reference loops
(fixed: src/system.rs:141-154; adaptive step doubling: src/system.rs:111-139)."""

import jax
import numpy as np
import pytest

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
from odesat_tpu.models.ode import ODEState, formula_device, init_state, make_step_fn
from odesat_tpu.constants import DT_INIT, DT_MAX, DT_MIN
from odesat_tpu.ops.oracle import (
    compute_derivatives_oracle,
    max_error_oracle,
    update_state_oracle,
)
from odesat_tpu.utils.config import ODEConfig
from tests.conftest import random_formula


def _fixture(seed=11, n_vars=10, n_clauses=25):
    rng = np.random.default_rng(seed)
    formula = random_formula(rng, n_vars, n_clauses, max_width=3, min_width=2)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized, dtype=np.float64, clause_pad=8, var_pad=8)
    v0 = rng.uniform(-1, 1, size=fa.n_vars_padded)
    return normalized, fa, v0


def _oracle_fixed(normalized, fa, v0, dt, steps, zeta, rigidity):
    v = v0.copy()
    xs = np.asarray(fa.xs_init, dtype=np.float64).copy()
    xl = np.ones(fa.n_clauses_padded)
    M = fa.n_clauses
    for _ in range(steps):
        dv, dxs, dxl, allsat = compute_derivatives_oracle(v, xs, xl, normalized, zeta, rigidity)
        # padded tail never changes (oracle only writes real slots)
        v, xs, xl = update_state_oracle(v, xs, xl, dv, dxs, dxl, dt, M)
        if allsat:
            break
    return v, xs, xl


def _oracle_adaptive(normalized, fa, v0, tol, steps, zeta, rigidity):
    v = v0.copy()
    xs = np.asarray(fa.xs_init, dtype=np.float64).copy()
    xl = np.ones(fa.n_clauses_padded)
    dt = DT_INIT
    M = fa.n_clauses
    for _ in range(steps):
        dv, dxs, dxl, allsat = compute_derivatives_oracle(v, xs, xl, normalized, zeta, rigidity)
        if allsat:
            break
        fv, fxs, fxl = update_state_oracle(v, xs, xl, dv, dxs, dxl, dt, M)
        hv, hxs, hxl = update_state_oracle(v, xs, xl, dv, dxs, dxl, 0.5 * dt, M)
        dv2, dxs2, dxl2, _ = compute_derivatives_oracle(hv, hxs, hxl, normalized, zeta, rigidity)
        v, xs, xl = update_state_oracle(hv, hxs, hxl, dv2, dxs2, dxl2, 0.5 * dt, M)
        err = max_error_oracle((fv, fxs, fxl), (v, xs, xl))
        dt = min(max(dt * np.sqrt(tol / err) if err > 0 else DT_MAX, DT_MIN), DT_MAX)
    return v, xs, xl, dt


def _run_jax(fa, v0, ode, steps, zeta):
    step = make_step_fn(fa, zeta, ode)
    dev = formula_device(fa, dtype=np.float64)
    key = jax.random.PRNGKey(0)
    state = init_state(fa, 1, key, ode, v0=v0)

    def body(carry, _):
        return step(carry, dev), None

    out, _ = jax.lax.scan(body, state, None, length=steps)
    return out


def test_fixed_step_matches_oracle():
    normalized, fa, v0 = _fixture()
    zeta, dt, steps = 0.01, 0.05, 40
    ode = ODEConfig(step_size=dt, dtype="float64", rigidity="reference")

    v_o, xs_o, xl_o = _oracle_fixed(normalized, fa, v0, dt, steps, zeta, "reference")
    out = _run_jax(fa, v0, ode, steps, zeta)
    np.testing.assert_allclose(np.asarray(out.v)[0], v_o, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.xs)[0], xs_o, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.xl)[0], xl_o, rtol=1e-8, atol=1e-12)


def test_adaptive_step_matches_oracle():
    normalized, fa, v0 = _fixture(seed=13)
    zeta, tol, steps = 0.01, 1e-3, 25
    ode = ODEConfig(tolerance=tol, dtype="float64", rigidity="reference")

    v_o, xs_o, xl_o, dt_o = _oracle_adaptive(normalized, fa, v0, tol, steps, zeta, "reference")
    out = _run_jax(fa, v0, ode, steps, zeta)
    np.testing.assert_allclose(np.asarray(out.v)[0], v_o, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.xs)[0], xs_o, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.xl)[0], xl_o, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(out.dt[0]), dt_o, rtol=1e-6)


def test_done_trajectories_freeze():
    """Once a trajectory reaches allsat its state must not change
    (early-exit freeze inside the chunk)."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal

    # trivially satisfiable: x0 ∨ x1 with v already in the satisfied corner
    formula = CNFFormula([(Literal(0), Literal(1))], 2)
    fa = compile_formula(formula, dtype=np.float64, clause_pad=8, var_pad=8)
    v0 = np.zeros(fa.n_vars_padded)
    v0[:2] = [1.0, 1.0]  # clause value 0 => c = 0 < gamma => allsat
    ode = ODEConfig(step_size=0.05, dtype="float64")
    out = _run_jax(fa, v0, ode, steps=10, zeta=0.001)
    assert bool(out.done[0])
    # the detecting step still applies one update (reference applies
    # update_state before the break, src/system.rs:141-154), after which
    # the trajectory freezes; v stays in the satisfying corner
    assert np.asarray(out.v)[0, 0] > 0 and np.asarray(out.v)[0, 1] > 0


def test_shared_dt_mode_couples_batch():
    """dt_mode='shared' reproduces the reference inter mode's single
    adaptive dt (src/system.rs:262-272,314 rendered as one batch-max):
    after any number of steps every trajectory carries the same dt, and
    it equals the dt driven by the batch-max error."""
    normalized, fa, _ = _fixture(seed=3)
    ode_shared = ODEConfig(tolerance=1e-3, dt_mode="shared")
    ode_per = ODEConfig(tolerance=1e-3)
    dev = formula_device(fa)
    state0 = init_state(fa, 6, jax.random.PRNGKey(5), ode_shared)

    step_shared = make_step_fn(fa, 0.001, ode_shared)
    step_per = make_step_fn(fa, 0.001, ode_per)

    s = state0
    for _ in range(5):
        s = step_shared(s, dev)
    dts = np.asarray(s.dt)
    assert np.allclose(dts, dts[0]), "shared mode must carry one dt"

    p = state0
    for _ in range(5):
        p = step_per(p, dev)
    # per-trajectory dts genuinely diverge on this fixture (guards the
    # test against a vacuous pass)
    assert not np.allclose(np.asarray(p.dt), np.asarray(p.dt)[0])
    # the shared dt is governed by the batch max error => it is the min
    # of what per-trajectory adaptation would give after the first step
    s1 = step_shared(state0, dev)
    p1 = step_per(state0, dev)
    np.testing.assert_allclose(np.asarray(s1.dt)[0], np.asarray(p1.dt).min(), rtol=1e-6)


def _layout_formula(layout, seed):
    """Uniform 3-SAT, mixed widths in several width buckets, a
    locally-structured instance, unit clauses."""
    from odesat_tpu.utils.generate import random_local_ksat

    rng = np.random.default_rng(seed)
    if layout == "uniform":
        return random_formula(rng, 12, 30, max_width=3, min_width=3), {}
    if layout == "buckets":
        return random_formula(rng, 14, 40, max_width=5, min_width=2), dict(
            bucket=True, min_bucket=8
        )
    if layout == "locality":
        return random_local_ksat(24, 60, k=3, locality=6, seed=seed), {}
    return random_formula(rng, 10, 24, max_width=3, min_width=1), {}


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("strategy", ["gather", "segment_sum"])
@pytest.mark.parametrize("layout", ["uniform", "buckets", "locality", "unit"])
def test_scan_matches_oracle_across_layouts(layout, strategy, mode):
    """The scan path (the plain reference the fused kernel is checked
    against) matches the scalar-loop oracle in f64 on every layout the
    compiler produces. Bucketed layouts permute the clause axis, so the
    clause memories are compared as sorted values;
    v depends on all of them after a few steps."""
    formula, compile_kw = _layout_formula(layout, seed=17)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized, dtype=np.float64, clause_pad=8, var_pad=8, **compile_kw)
    if layout == "buckets":
        assert len(fa.bucket_slices) > 1
    if layout == "unit":
        assert fa.min_width == 1
    rng = np.random.default_rng(5)
    v0 = rng.uniform(-1, 1, size=fa.n_vars_padded)
    zeta, steps = 0.01, 12
    ode = ODEConfig(
        step_size=0.05 if mode == "fixed" else None, tolerance=1e-3, dtype="float64",
        rigidity="reference", dv_strategy=strategy,
    )
    # the oracle walks the source formula's clauses in index order
    if mode == "fixed":
        v_o, xs_o, xl_o = _oracle_fixed(normalized, _unpermuted(fa, normalized), v0, 0.05,
                                        steps, zeta, "reference")
    else:
        v_o, xs_o, xl_o, _ = _oracle_adaptive(normalized, _unpermuted(fa, normalized), v0,
                                              1e-3, steps, zeta, "reference")
    out = _run_jax(fa, v0, ode, steps, zeta)
    M = normalized.num_clauses
    np.testing.assert_allclose(np.asarray(out.v)[0], v_o, rtol=1e-7, atol=1e-10)
    real = np.asarray(fa.clause_mask) > 0
    np.testing.assert_allclose(np.sort(np.asarray(out.xs)[0][real]), np.sort(xs_o[:M]),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.sort(np.asarray(out.xl)[0][real]), np.sort(xl_o[:M]),
                               rtol=1e-7, atol=1e-10)


def _unpermuted(fa, normalized):
    """A stand-in for ``fa`` in clause-index order, as the oracle helpers
    index it (xs_init per source clause, padded to the same length)."""
    from types import SimpleNamespace

    M = normalized.num_clauses
    xs_init = np.ones(fa.n_clauses_padded)
    xs_init[:M] = [1.0 if any(lit.is_negated for lit in c) else -1.0 for c in normalized.clauses]
    return SimpleNamespace(
        xs_init=xs_init, n_clauses_padded=fa.n_clauses_padded, n_clauses=M,
    )
