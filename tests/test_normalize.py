"""Normalization and value-mapping tests (fixes C3's nondeterminism)."""

from odesat_tpu.cnf import (
    CNFFormula,
    Literal,
    evaluate_cnf,
    map_values_by_indices,
    normalize_cnf_variables,
    render_variable_map,
)


def test_normalize_deterministic_sorted():
    f = CNFFormula([(Literal(42, False), Literal(7, True)), (Literal(9, False),)], 50)
    mapping, normalized = normalize_cnf_variables(f)
    assert mapping == {7: 0, 9: 1, 42: 2}
    assert normalized.clauses[0] == (Literal(2, False), Literal(0, True))
    # varnum is preserved, not shrunk (reference: src/cnf.rs:198)
    assert normalized.varnum == 50


def test_map_values_by_indices_skips_out_of_range():
    mapping = {10: 0, 20: 5}
    values = [True, False]
    out = map_values_by_indices(mapping, values)
    assert out == {10: True}  # index 5 out of range -> skipped


def test_evaluate_cnf_inserts_missing_false():
    f = CNFFormula([(Literal(1, True),), (Literal(2, False),)], 2)
    assignment = {2: True}
    assert evaluate_cnf(assignment, f) is True
    assert assignment[1] is False  # or_insert(false) semantics


def test_render_sorted():
    out = render_variable_map({3: True, 1: False})
    assert out == "1 0\n3 1\n"


def test_bandwidth_reorder_recovers_locality():
    """RCM relabeling recovers variable locality destroyed by a random
    shuffle — the clauses' variable spans shrink — and the composed
    name map still produces verifying solutions."""
    import numpy as np

    from odesat_tpu.cnf import (
        bandwidth_reorder,
        evaluate_cnf,
        map_values_by_indices,
        normalize_cnf_variables,
    )
    from odesat_tpu.cnf.formula import CNFFormula, Literal
    from odesat_tpu.utils.generate import random_local_ksat

    def total_span(formula):
        return sum(
            max(lit.variable for lit in c) - min(lit.variable for lit in c)
            for c in formula.clauses
        )

    local = random_local_ksat(512, 1536, k=3, locality=48, seed=9)
    # scramble variable names to destroy index locality
    rng = np.random.default_rng(0)
    shuffle = {v + 1: int(p) + 1 for v, p in enumerate(rng.permutation(512))}
    scrambled = CNFFormula(
        [
            tuple(Literal(shuffle[l.variable], l.is_negated) for l in c)
            for c in local.clauses
        ],
        512,
    )
    name_map, normalized = normalize_cnf_variables(scrambled)
    total_before = total_span(normalized)
    name_map2, reordered = bandwidth_reorder(name_map, normalized)
    total_after = total_span(reordered)
    assert total_after < total_before / 2  # spans tighten substantially

    # readout composition: any satisfying assignment of the reordered
    # formula maps back to a satisfying assignment of the original
    from odesat_tpu.models.ode import simulate_batch
    from odesat_tpu.utils.config import ODEConfig, SolverConfig

    cfg = SolverConfig(
        ode=ODEConfig(step_size=0.02, steps=3000), batch_size=16, seed=0
    )
    result = simulate_batch(reordered, cfg)
    assert result.any_solved
    mapped = map_values_by_indices(name_map2, result.best_assignment())
    assert evaluate_cnf(mapped, scrambled)
