"""Stochastic engine tests (reference: src/stoch.rs)."""

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
from odesat_tpu.models.stoch import init_stoch_state, make_stoch_step, search
from odesat_tpu.utils.config import ODEConfig, SolverConfig


def test_stoch_solves_small(data_dir):
    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    var_mapping, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(
        ode=ODEConfig(steps=2000), batch_size=8, seed=0, chunk_steps=128
    )
    result = search(normalized, config)
    assert result.solved_index is not None
    mapped = map_values_by_indices(var_mapping, result.best_assignment())
    assert evaluate_cnf(mapped, formula)


def test_stoch_weight_update_semantics():
    """Satisfied clause: xl -> max(xl-1, 1); unsatisfied: xl + 20
    (src/stoch.rs:47-51)."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal

    # clause0 = (x0) satisfied by v0=True at start? start is all-false ->
    # clause (x0) unsatisfied, clause (-x1) satisfied
    formula = CNFFormula([(Literal(0),), (Literal(1, True),)], 2)
    fa = compile_formula(formula, clause_pad=8, var_pad=8)
    step = make_stoch_step(fa)
    state = init_stoch_state(fa, 1, jax.random.PRNGKey(0))
    out = step(state)
    xl = np.asarray(out.xl)[0]
    assert xl[0] == 21  # unsatisfied: 1 + 20
    assert xl[1] == 1  # satisfied: max(1-1, 1)


def test_stoch_flip_probability():
    """A variable whose clauses are all unsatisfied flips with probability
    ~1 (unsat == total); one with all satisfied never flips."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal

    formula = CNFFormula([(Literal(0),), (Literal(1, True),)], 2)
    fa = compile_formula(formula, clause_pad=8, var_pad=8)
    step = make_stoch_step(fa)
    flips0 = 0
    flips1 = 0
    trials = 200
    state = init_stoch_state(fa, trials, jax.random.PRNGKey(1))
    out = step(state)
    v = np.asarray(out.v)
    flips0 = int(v[:, 0].sum())  # x0 was False, flip -> True
    flips1 = int(v[:, 1].sum())  # x1 False and its clause satisfied -> stays
    assert flips0 == trials  # unsat/total == 1 -> always flips
    assert flips1 == 0  # unsat/total == 0 -> never flips


def test_stoch_done_freezes():
    from odesat_tpu.cnf.formula import CNFFormula, Literal

    # (-x0): satisfied by all-false start immediately
    formula = CNFFormula([(Literal(0, True),)], 1)
    fa = compile_formula(formula, clause_pad=8, var_pad=8)
    step = make_stoch_step(fa)
    state = init_stoch_state(fa, 3, jax.random.PRNGKey(2))
    out = step(state)
    assert bool(np.all(np.asarray(out.done)))
    out2 = step(out)
    np.testing.assert_array_equal(np.asarray(out2.v), np.asarray(out.v))


def test_stoch_seed_reproducible(data_dir):
    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(ode=ODEConfig(steps=500), batch_size=4, seed=7, chunk_steps=64)
    r1 = search(normalized, config)
    r2 = search(normalized, config)
    np.testing.assert_array_equal(r1.assignment, r2.assignment)


@pytest.mark.parametrize("batch", [1, 16])
def test_stoch_chunk_semantics(batch):
    """One scan-path step: weight updates are exact and flips with
    probability 0 and 1 are deterministic."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal
    from odesat_tpu.models.stoch import make_stoch_chunk_runner

    # (x0) unsatisfied at all-false start -> always flips x0;
    # (-x1) satisfied -> never flips x1
    formula = CNFFormula([(Literal(0),), (Literal(1, True),)], 2)
    fa = compile_formula(formula, clause_pad=128, var_pad=128)
    state = init_stoch_state(fa, batch, jax.random.PRNGKey(0))
    out = make_stoch_chunk_runner(fa, 1, donate=False)(state)
    v = np.asarray(out.v)
    xl = np.asarray(out.xl)
    assert (v[:, 0] == True).all()  # noqa: E712 — unsat/total == 1
    assert (v[:, 1] == False).all()  # noqa: E712 — unsat/total == 0
    assert (xl[:, 0] == 21).all()
    assert (xl[:, 1] == 1).all()


def test_stoch_chunk_solves_small(data_dir):
    from odesat_tpu.models.stoch import make_stoch_chunk_runner

    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    var_mapping, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    state = init_stoch_state(fa, 32, jax.random.PRNGKey(5))
    out = make_stoch_chunk_runner(fa, 200, donate=False)(state)
    done = np.asarray(out.done)
    assert done.any()
    idx = int(np.flatnonzero(done)[0])
    mapped = map_values_by_indices(var_mapping, np.asarray(out.v)[idx, : fa.n_vars])
    assert evaluate_cnf(mapped, formula)


def test_stoch_chunk_freeze():
    """Solved chains stay frozen across further chunks."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal
    from odesat_tpu.models.stoch import make_stoch_chunk_runner

    formula = CNFFormula([(Literal(0, True),)], 1)  # satisfied at all-false
    fa = compile_formula(formula, clause_pad=128, var_pad=128)
    state = init_stoch_state(fa, 8, jax.random.PRNGKey(1))
    run = make_stoch_chunk_runner(fa, 3, donate=False)
    out = run(state)
    assert np.asarray(out.done).all()
    out2 = run(out)
    np.testing.assert_array_equal(np.asarray(out2.v), np.asarray(out.v))
    np.testing.assert_array_equal(np.asarray(out2.xl), np.asarray(out.xl))


def test_stoch_pipeline_matches_brute_force_oracle():
    """Same end-to-end property for the stochastic engine: verify exactly
    when a satisfying assignment exists (tiny random formulas)."""
    import numpy as np

    from odesat_tpu.cnf import (
        evaluate_cnf,
        map_values_by_indices,
        normalize_cnf_variables,
    )
    from odesat_tpu.models.stoch import search
    from odesat_tpu.preprocess import preprocess_formula, reconstruct_witness
    from odesat_tpu.utils.config import ODEConfig, SolverConfig
    from tests.conftest import brute_force_sat, random_formula

    rng = np.random.default_rng(11)
    sat_checked = unsat_checked = 0
    for trial in range(8):
        formula = random_formula(rng, n_vars=8, n_clauses=18, max_width=3, min_width=2)
        oracle = brute_force_sat(formula)
        reduced, trace = preprocess_formula(formula, 7.0)
        var_mapping, normalized = normalize_cnf_variables(reduced)
        cfg = SolverConfig(
            ode=ODEConfig(steps=4000), batch_size=32, seed=trial, chunk_steps=256
        )
        result = search(normalized, cfg)
        idx = result.solved_index if result.solved_index is not None else 0
        assignment = map_values_by_indices(var_mapping, result.assignment[idx])
        reconstruct_witness(assignment, trace)
        verified = evaluate_cnf(assignment, formula)
        if oracle is None:
            assert not verified, f"trial {trial}: stoch 'verified' an UNSAT formula"
            unsat_checked += 1
        else:
            assert verified, f"trial {trial}: stoch failed a SAT formula"
            sat_checked += 1
    assert sat_checked >= 2 and unsat_checked >= 1
