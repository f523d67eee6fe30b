"""The load-robust TTS protocol's exact-step resolution (utils/tts.py).

The final-chunk bisection must return exactly the step at which the
first trajectory's done flag latches — validated against a chunk=1
ground-truth replay of the same trajectories."""

import jax
import numpy as np
import pytest

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.tts import _pow2_ladder, solve_exact, tts_breakdown


def _ground_truth_steps(fa, ode, batch, key, budget):
    """First step at which done.any(), by single-step replay."""
    runner = make_chunk_runner(fa, ode.resolve_zeta(fa.density), ode, 1, donate=False)
    dev = formula_device(fa)
    state = init_state(fa, batch, key, ode)
    for step in range(1, budget + 1):
        state = runner(state, dev)
        if np.asarray(state.done).any():
            return step
    return None


def _fa(data_dir, name="easy.cnf"):
    formula = parse_dimacs_file(f"{data_dir}/{name}")
    _, norm = normalize_cnf_variables(formula)
    return compile_formula(norm), norm


@pytest.mark.parametrize("chunk", [64, 48])  # power-of-two and not
def test_exact_steps_match_single_step_replay(data_dir, chunk):
    fa, _ = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    key = jax.random.PRNGKey(3)
    truth = _ground_truth_steps(fa, ode, 8, key, budget=1024)
    assert truth is not None, "fixture must solve within the test budget"
    res = solve_exact(fa, ode, 8, key, chunk, 1024)
    assert res.solved
    assert res.steps == truth
    assert res.chunks == -(-truth // chunk)  # solve chunks only, no probes


def test_exact_steps_first_chunk_and_first_step(data_dir):
    fa, _ = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    # huge chunk: the whole solve happens inside chunk 1 and the answer
    # must still be sub-chunk exact
    key = jax.random.PRNGKey(3)
    truth = _ground_truth_steps(fa, ode, 8, key, budget=1024)
    res = solve_exact(fa, ode, 8, key, 1024, 1024)
    assert res.solved and res.steps == truth and res.chunks == 1


def test_unsolved_returns_budget(data_dir):
    fa, _ = _fa(data_dir)
    ode = ODEConfig(step_size=1e-6)  # dt too small to reach allsat
    res = solve_exact(fa, ode, 4, jax.random.PRNGKey(0), 16, budget=48)
    assert not res.solved
    assert res.steps == 48
    assert res.chunks == 3


def test_readout_matches_production_path(data_dir):
    """The bisection readout must equal simulate_batch's frozen state for
    the same trajectory: done latches freeze v per step, so the post-latch
    readout is invariant to chunk boundaries. (Oracle verification is NOT
    asserted: like the reference, one update is applied on the allsat
    detection step — src/system.rs:151-154 — so a sign can flip between
    detection and readout; CLI batch mode handles that with its
    oracle-gated exit.)"""
    from odesat_tpu.models.ode import simulate_batch
    from odesat_tpu.utils.config import SolverConfig

    fa, norm = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    res = solve_exact(fa, ode, 8, jax.random.PRNGKey(3), 64, 1024, readout=True)
    assert res.solved and res.assignment is not None
    cfg = SolverConfig(ode=ODEConfig(step_size=0.05, steps=1024),
                       batch_size=8, chunk_steps=64)
    sim = simulate_batch(norm, cfg, key=jax.random.PRNGKey(3))
    assert sim.done[res.solved_index]
    np.testing.assert_array_equal(res.assignment,
                                  sim.assignment[res.solved_index])


def test_runner_cache_shared_across_instances(data_dir):
    fa, _ = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    cache: dict = {}
    r1 = solve_exact(fa, ode, 8, jax.random.PRNGKey(3), 64, 1024, runner_cache=cache)
    n_compiled = len(cache)
    r2 = solve_exact(fa, ode, 8, jax.random.PRNGKey(3), 64, 1024, runner_cache=cache)
    assert r1.steps == r2.steps  # deterministic per seed
    assert len(cache) == n_compiled  # second instance reuses every runner


def test_runner_cache_keyed_by_formula_not_shape(interpret_kernel):
    """Two same-shaped but DIFFERENT formulas sharing one runner_cache
    must each be solved against their own formula. Regression test: the
    cache was keyed on chunk length alone, and the Pallas chunk runners
    bake the formula CONTENT (incidence planes) at build time — every
    instance after the first was silently solved against instance 0
    (caught in round 4 when the uf250 TTS 'distribution' turned out to
    be 20 inits of seed 0). The scan path reads the formula from `dev`
    per call and cannot reproduce this, so the fused kernel (interpret
    mode) is forced; the second formula is UNSAT, where a stale
    first-formula runner latches a bogus 'solved'."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal

    def pair(a, b):
        return (Literal(0, a), Literal(1, b))

    sat = CNFFormula([pair(False, False)] * 4, 2)  # all (x0 v x1)
    unsat = CNFFormula(
        [pair(False, False), pair(False, True), pair(True, False),
         pair(True, True)], 2,
    )
    ode = ODEConfig(step_size=0.05, dv_strategy="fused")
    cache: dict = {}
    first = solve_exact(compile_formula(sat), ode, 8, jax.random.PRNGKey(1),
                        32, 512, runner_cache=cache)
    assert first.solved
    second = solve_exact(compile_formula(unsat), ode, 8, jax.random.PRNGKey(1),
                         32, 512, runner_cache=cache)
    assert not second.solved  # a stale sat-runner would latch 'solved'


def test_evict_formula_drops_only_that_instance(data_dir):
    """A shared cache pins every formula it has seen (ADVICE r4):
    evict_formula must drop exactly the retired instance's runners so a
    long multi-instance sweep doesn't grow memory without bound."""
    from odesat_tpu.utils.tts import evict_formula

    fa1, _ = _fa(data_dir)
    fa2, _ = _fa(data_dir, "small.cnf")
    ode = ODEConfig(step_size=0.05)
    cache: dict = {}
    solve_exact(fa1, ode, 8, jax.random.PRNGKey(3), 64, 1024, runner_cache=cache)
    solve_exact(fa2, ode, 8, jax.random.PRNGKey(3), 64, 1024, runner_cache=cache)
    assert {k[0] for k in cache} == {id(fa1), id(fa2)}
    n2 = sum(1 for k in cache if k[0] == id(fa2))
    evict_formula(cache, fa1)
    assert {k[0] for k in cache} == {id(fa2)}
    assert sum(1 for k in cache if k[0] == id(fa2)) == n2
    evict_formula(cache, fa2)
    assert not cache


def test_pow2_ladder_composes_every_offset():
    for chunk in (1, 2, 3, 48, 64, 100):
        sizes = _pow2_ladder(chunk)
        assert all(s & (s - 1) == 0 for s in sizes)
        assert sizes == sorted(sizes, reverse=True)
        # greedy subsets reach every offset 0..chunk-1
        reachable = {0}
        for s in sizes:
            reachable |= {r + s for r in reachable}
        assert set(range(chunk)) <= reachable


def test_breakdown_arithmetic():
    bd = tts_breakdown(steps=100, chunks=2, batch=10, kernel_rate=1000.0,
                       dispatch_s=0.01, wall_s=1.5)
    assert bd["compute_s"] == pytest.approx(1.0)
    assert bd["dispatch_s"] == pytest.approx(0.02)
    assert bd["residual_s"] == pytest.approx(0.48)


def test_exact_steps_device_path_matches_host_path(data_dir, interpret_kernel):
    """solve_exact's device-loop fast path (one dispatch + deterministic
    replay + bisection) must report the same exact step count and
    solved trajectory as the host-paced chunk loop — the fused kernel in
    interpret mode, so the shape-shared while program engages."""
    fa, _ = _fa(data_dir)
    key = jax.random.PRNGKey(3)
    fused = ODEConfig(step_size=0.05, dv_strategy="fused")
    scan = ODEConfig(step_size=0.05, dv_strategy="gather")  # scan: host path
    dev_res = solve_exact(fa, fused, 8, key, 64, 1024, readout=True)
    host_res = solve_exact(fa, scan, 8, key, 64, 1024, readout=True)
    assert dev_res.solved and host_res.solved
    # same kernels modulo strategy: trajectories may differ between
    # fused and scan numerics, so compare the device path against its
    # own ground truth instead of the scan path's steps
    truth = None
    from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
    runner = make_chunk_runner(fa, fused.resolve_zeta(fa.density), fused, 1,
                               donate=False)
    dv = formula_device(fa)
    st = init_state(fa, 8, key, fused)
    for step in range(1, 1025):
        st = runner(st, dv)
        if np.asarray(st.done).any():
            truth = step
            break
    assert truth is not None
    assert dev_res.steps == truth
    assert dev_res.chunks == 1  # one timed dispatch
    # the host path on the scan numerics still self-checks via its own test
    assert host_res.chunks == -(-host_res.steps // 64)


def test_exact_steps_device_path_budget_exhaustion(interpret_kernel):
    """UNSAT under the device path: full budget reported, unsolved, and
    the sub-chunk budget tail still runs (budget not divisible)."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal

    def pair(a, b):
        return (Literal(0, a), Literal(1, b))

    unsat = CNFFormula(
        [pair(False, False), pair(False, True), pair(True, False),
         pair(True, True)], 2,
    )
    fa = compile_formula(unsat)
    ode = ODEConfig(step_size=0.05, dv_strategy="fused")
    res = solve_exact(fa, ode, 8, jax.random.PRNGKey(0), 64, 200)
    assert not res.solved and res.steps == 200
    assert res.chunks == 2  # one device dispatch + the 8-step tail
