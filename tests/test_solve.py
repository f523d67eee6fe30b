"""End-to-end solves on the bundled fixtures (SURVEY.md §4 integration
tier): small.cnf and easy.cnf yield verified SAT; hard.cnf (UNSAT,
hard.cnf:9) exhausts its budget with verdict false."""

import os

import jax
import numpy as np
import pytest

from odesat_tpu.cnf import (
    compile_formula,
    evaluate_cnf,
    map_values_by_indices,
    normalize_cnf_variables,
    parse_dimacs_file,
)
from odesat_tpu.models.ode import simulate_batch
from odesat_tpu.preprocess import preprocess_formula, reconstruct_witness
from odesat_tpu.utils.config import ODEConfig, SolverConfig


def _solve_pipeline(path, config, preprocess=True, ratio=7.0):
    """The reference solve pipeline (src/main.rs:143-204)."""
    formula = parse_dimacs_file(path)
    if preprocess:
        reduced, trace = preprocess_formula(formula, ratio)
    else:
        reduced, trace = formula, None
    var_mapping, normalized = normalize_cnf_variables(reduced)
    result = simulate_batch(normalized, config)
    mapped = map_values_by_indices(var_mapping, result.best_assignment())
    if trace is not None:
        reconstruct_witness(mapped, trace)
    return evaluate_cnf(mapped, formula), result


def test_solve_small(data_dir):
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=2000),
        batch_size=4,
        seed=0,
        chunk_steps=128,
    )
    ok, result = _solve_pipeline(os.path.join(data_dir, "small.cnf"), config)
    assert ok, "small.cnf must verify SAT"


def test_solve_easy_preprocessed(data_dir):
    config = SolverConfig(
        ode=ODEConfig(steps=4000),  # adaptive
        batch_size=8,
        seed=1,
        chunk_steps=256,
    )
    ok, result = _solve_pipeline(os.path.join(data_dir, "easy.cnf"), config)
    assert ok, "easy.cnf must verify SAT after preprocessing"
    assert result.any_solved


def test_hard_budget_exhaustion(data_dir):
    """hard.cnf is UNSAT: the solver must run out its budget and the
    verdict must be false (reference behavior on an UNSAT input)."""
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=300),
        batch_size=2,
        seed=2,
        chunk_steps=128,
    )
    ok, result = _solve_pipeline(
        os.path.join(data_dir, "hard.cnf"), config, preprocess=False
    )
    assert not ok
    assert result.steps == 300
    assert result.solved_index is None


def test_batch_restarts_and_inter_parity(data_dir):
    """batch (parallel restarts, stop_on='all') and inter (stop_on='any')
    both find verified solutions on small.cnf."""
    path = os.path.join(data_dir, "small.cnf")
    formula = parse_dimacs_file(path)
    var_mapping, normalized = normalize_cnf_variables(formula)

    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=1000), batch_size=16, seed=3, chunk_steps=128
    )
    inter = simulate_batch(normalized, config, stop_on="any")
    assert inter.any_solved
    mapped = map_values_by_indices(var_mapping, inter.best_assignment())
    assert evaluate_cnf(mapped, formula)

    batch = simulate_batch(normalized, config, stop_on="all")
    assert batch.done.sum() >= 1
    mapped = map_values_by_indices(var_mapping, batch.best_assignment())
    assert evaluate_cnf(mapped, formula)


def test_seed_reproducibility(data_dir):
    path = os.path.join(data_dir, "small.cnf")
    formula = parse_dimacs_file(path)
    _, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=200), batch_size=4, seed=42)
    r1 = simulate_batch(normalized, config)
    r2 = simulate_batch(normalized, config)
    np.testing.assert_array_equal(r1.assignment, r2.assignment)
    assert r1.steps == r2.steps


def test_wall_clock_budget_stops_unbounded_run(data_dir):
    """hard.cnf is UNSAT; with no step budget the run would be unbounded —
    the wall-clock budget must stop it (SURVEY.md §5 failure detection)."""
    import time

    from odesat_tpu.cnf import normalize_cnf_variables, parse_dimacs_file

    formula = parse_dimacs_file(os.path.join(data_dir, "hard.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01),  # steps=None -> unbounded
        batch_size=4,
        seed=0,
        chunk_steps=64,
        wall_clock_budget_s=2.0,
    )
    t0 = time.perf_counter()
    result = simulate_batch(normalized, config)
    assert time.perf_counter() - t0 < 60.0  # budget + one chunk + compile
    assert not result.any_solved


def test_log_every_chunks_emits_progress(data_dir, caplog):
    from odesat_tpu.cnf import normalize_cnf_variables, parse_dimacs_file

    formula = parse_dimacs_file(os.path.join(data_dir, "hard.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=256),
        batch_size=4,
        seed=0,
        chunk_steps=64,
        log_every_chunks=1,
    )
    import logging

    with caplog.at_level(logging.INFO, logger="odesat_tpu"):
        simulate_batch(normalized, config)
    assert any("steps" in rec.message for rec in caplog.records)


def test_full_pipeline_matches_brute_force_oracle():
    """Property: on random tiny formulas, the full pipeline (preprocess ->
    normalize -> solve -> witness reconstruction -> verify) finds a
    verifying assignment exactly when one exists (brute-force oracle);
    UNSAT instances must never produce a 'true' verdict."""
    import numpy as np

    from odesat_tpu.cnf import (
        evaluate_cnf,
        map_values_by_indices,
        normalize_cnf_variables,
    )
    from odesat_tpu.preprocess import preprocess_formula, reconstruct_witness
    from tests.conftest import brute_force_sat, random_formula

    rng = np.random.default_rng(3)
    sat_checked = unsat_checked = 0
    for trial in range(12):
        formula = random_formula(rng, n_vars=8, n_clauses=18, max_width=3, min_width=2)
        oracle = brute_force_sat(formula)
        reduced, trace = preprocess_formula(formula, 7.0)
        if any(len(c) == 0 for c in reduced.clauses):
            continue  # preprocessing cannot emit empty clauses, but guard
        var_mapping, normalized = normalize_cnf_variables(reduced)
        cfg = SolverConfig(
            ode=ODEConfig(step_size=0.02, steps=4000), batch_size=64, seed=trial
        )
        result = simulate_batch(normalized, cfg)
        assignment = map_values_by_indices(var_mapping, result.best_assignment())
        reconstruct_witness(assignment, trace)
        verified = evaluate_cnf(assignment, formula)
        if oracle is None:
            assert not verified, f"trial {trial}: verified 'SAT' on an UNSAT formula"
            unsat_checked += 1
        else:
            assert verified, f"trial {trial}: failed to solve a SAT formula"
            sat_checked += 1
    assert sat_checked >= 3 and unsat_checked >= 1  # both branches exercised

def test_device_loop_early_exit_granularity(data_dir, monkeypatch):
    """Small batches run many chunks per dispatch inside an on-device
    while_loop (models/ode.make_multi_chunk_runner); the done
    short-circuit keeps the early-exit window at ONE inner chunk, so a
    fast solve reports steps at chunk granularity, far below the
    nominal per-dispatch slice. A wall-clock budget would silently
    disable the device loop (budgets are host-paced), so this test sets
    none — and spies on the constructor to prove the loop actually ran."""
    import odesat_tpu.models.ode as ode_mod
    from odesat_tpu.cnf import normalize_cnf_variables, parse_dimacs_file
    from odesat_tpu.models.ode import simulate_batch

    calls = []
    orig = ode_mod.make_multi_chunk_runner

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    monkeypatch.setattr(ode_mod, "make_multi_chunk_runner", spy)

    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01),  # unbounded budget
        batch_size=4,
        seed=0,
        chunk_steps=64,
    )
    result = simulate_batch(normalized, config, stop_on="any")
    assert calls, "on-device multi-chunk loop was never built"
    assert result.any_solved
    assert result.steps % 64 == 0
    assert result.steps < 262144  # exited early within the first dispatch


def test_multi_chunk_runner_exact_accounting(data_dir):
    """make_multi_chunk_runner's steps_advanced must equal chunks
    actually run x chunk_steps, the short-circuit must stop at the first
    done chunk, and the state must match iterating the plain chunk
    runner the same number of times."""
    import jax.numpy as jnp

    from odesat_tpu.cnf import (
        compile_formula,
        normalize_cnf_variables,
        parse_dimacs_file,
    )
    from odesat_tpu.models.ode import (
        formula_device,
        init_state,
        make_chunk_runner,
        make_multi_chunk_runner,
    )

    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    ode = ODEConfig(step_size=0.01)
    zeta = ode.resolve_zeta(fa.density)
    dev = formula_device(fa)
    state0 = init_state(fa, 4, jax.random.PRNGKey(0), ode)

    fresh = lambda: jax.tree.map(lambda x: jnp.array(np.asarray(x)), state0)  # noqa: E731
    multi = make_multi_chunk_runner(fa, zeta, ode, 64, 32, stop_on="any")
    out, steps = multi(fresh(), dev)  # donates its input — use a copy
    n = int(steps) // 64
    assert int(steps) == n * 64
    assert 1 <= n <= 32
    if n < 32:  # short-circuited: done must hold at exit
        assert bool(np.asarray(out.done).any())

    chunk = make_chunk_runner(fa, zeta, ode, 64, donate=False)
    ref = fresh()
    for _ in range(n):
        ref = chunk(ref, dev)
    np.testing.assert_array_equal(np.asarray(out.v), np.asarray(ref.v))
    np.testing.assert_array_equal(np.asarray(out.done), np.asarray(ref.done))


def test_multi_chunk_runner_shares_core_program_across_instances(interpret_kernel):
    """When the chunk runner exposes a shape-cached core (the fused
    Pallas kernel via ops/kernelctx.wrap_chunk_runner), the multi-chunk
    while program must (a) be built ONCE per static shape — the
    incidence planes ride as jit arguments, so a second same-shaped
    formula reuses the compiled program — and (b) still solve each
    instance against ITS OWN formula (a closure-traced wrapper would
    bake instance 0's planes in as constants: the round-4 TTS cache bug,
    one level down). Fused kernel in interpret mode."""
    import jax.numpy as jnp

    from odesat_tpu.cnf import compile_formula
    from odesat_tpu.cnf.formula import CNFFormula, Literal
    from odesat_tpu.models import ode as ode_mod
    from odesat_tpu.models.ode import (
        formula_device,
        init_state,
        make_multi_chunk_runner,
    )

    def pair(a, b):
        return (Literal(0, a), Literal(1, b))

    sat = CNFFormula([pair(False, False)] * 4, 2)  # all (x0 v x1): SAT
    unsat = CNFFormula(
        [pair(False, False), pair(False, True), pair(True, False),
         pair(True, True)], 2,
    )
    ode = ODEConfig(step_size=0.05, dv_strategy="fused")
    zeta = ode.resolve_zeta(0.0)

    fa1 = compile_formula(sat)
    fa2 = compile_formula(unsat)
    n_programs0 = len(ode_mod._MULTI_CORE_CACHE)
    m1 = make_multi_chunk_runner(fa1, zeta, ode, 16, 8, stop_on="any")
    m2 = make_multi_chunk_runner(fa2, zeta, ode, 16, 8, stop_on="any")
    assert len(ode_mod._MULTI_CORE_CACHE) == n_programs0 + 1  # shared program

    out1, steps1 = m1(init_state(fa1, 8, jax.random.PRNGKey(1), ode),
                      formula_device(fa1))
    out2, steps2 = m2(init_state(fa2, 8, jax.random.PRNGKey(1), ode),
                      formula_device(fa2))
    assert bool(jnp.any(out1.done))        # SAT instance converges fast
    assert not bool(jnp.any(out2.done))    # UNSAT can never latch done
    assert int(steps2) == 16 * 8           # ran the full dispatch


def test_multi_chunk_runner_adaptive_core(data_dir, interpret_kernel):
    """The device loop must compose with the ADAPTIVE fused kernel too
    (two RHS passes + per-trajectory dt inside the core): exact
    accounting and state parity with the plain chunk runner."""
    import jax.numpy as jnp

    from odesat_tpu.cnf import (
        compile_formula,
        normalize_cnf_variables,
        parse_dimacs_file,
    )
    from odesat_tpu.models.ode import (
        formula_device,
        init_state,
        make_chunk_runner,
        make_multi_chunk_runner,
    )

    formula = parse_dimacs_file(os.path.join(data_dir, "easy.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    ode = ODEConfig(tolerance=1e-3, dv_strategy="fused")  # adaptive
    zeta = ode.resolve_zeta(fa.density)
    dev = formula_device(fa)
    state0 = init_state(fa, 4, jax.random.PRNGKey(7), ode)
    fresh = lambda: jax.tree.map(lambda x: jnp.array(np.asarray(x)), state0)  # noqa: E731

    multi = make_multi_chunk_runner(fa, zeta, ode, 32, 16, core_only=True)
    assert multi is not None
    out, steps = multi(fresh(), dev)
    n = int(steps) // 32
    assert int(steps) == n * 32 and 1 <= n <= 16

    chunk = make_chunk_runner(fa, zeta, ode, 32, donate=False)
    ref = fresh()
    for _ in range(n):
        ref = chunk(ref, dev)
    np.testing.assert_array_equal(np.asarray(out.v), np.asarray(ref.v))
    np.testing.assert_array_equal(np.asarray(out.dt), np.asarray(ref.dt))
    np.testing.assert_array_equal(np.asarray(out.done), np.asarray(ref.done))
