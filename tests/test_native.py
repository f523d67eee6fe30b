"""Native (C++) host runtime vs the pure-Python implementations:
parser round-trip, preprocessing parity (reduced formula + trace
reconstruction), and the baseline solver sanity."""

import os

import numpy as np
import pytest

from odesat_tpu import native
from odesat_tpu.cnf import evaluate_cnf, normalize_cnf_variables, parse_dimacs, parse_dimacs_file
from odesat_tpu.preprocess import preprocess_formula, reconstruct_witness
from tests.conftest import brute_force_sat, random_formula


@pytest.fixture(autouse=True)
def _native_library():
    """Decided when each test runs, never at import: the library builds
    with g++ on first use."""
    if not native.is_available():
        pytest.skip("native library unavailable (no g++?)")


def test_native_parse_matches_python(data_dir):
    for name in ("small.cnf", "easy.cnf", "hard.cnf"):
        text = open(os.path.join(data_dir, name)).read()
        py = parse_dimacs(text)
        nat = native.parse_dimacs_native(text)
        assert nat.varnum == py.varnum
        assert nat.clauses == py.clauses


def test_native_parse_quirks():
    text = "c x\np cnf 4 3\n\n1 -2 0\n  \n-3 4 1 0 99\n%\n0\n"
    py = parse_dimacs(text)
    nat = native.parse_dimacs_native(text)
    assert nat.clauses == py.clauses
    assert nat.varnum == 4


def test_native_parse_no_header():
    text = "1 -7 0\n7 3 0\n"
    nat = native.parse_dimacs_native(text)
    assert nat.varnum == 3


@pytest.mark.parametrize("seed", range(12))
def test_native_preprocess_parity(seed):
    rng = np.random.default_rng(seed)
    formula = random_formula(rng, n_vars=10, n_clauses=22, max_width=3)
    py_reduced, py_trace = preprocess_formula(formula, 7.0)
    nat_reduced, nat_trace = native.preprocess_native(formula, 7.0)

    assert nat_reduced.varnum == py_reduced.varnum
    assert nat_reduced.clauses == py_reduced.clauses
    assert len(nat_trace) == len(py_trace)
    for a, b in zip(nat_trace.steps, py_trace.steps):
        assert type(a) is type(b)
        assert a == b


@pytest.mark.parametrize("seed", range(4))
def test_native_preprocess_threaded_scan_parity(seed, monkeypatch):
    """Force the multi-threaded greedy-pick candidate scan (dead code on
    single-core hosts — hardware_concurrency()==1 — without the
    ODESAT_NATIVE_THREADS override) and pin it byte-identical to the
    Python twin; the formula is sized so the first rounds carry >=16
    candidates, the threshold that engages the pool."""
    rng = np.random.default_rng(900 + seed)
    formula = random_formula(rng, n_vars=40, n_clauses=150, max_width=3)
    py_reduced, py_trace = preprocess_formula(formula, 7.0)
    monkeypatch.setenv("ODESAT_NATIVE_THREADS", "4")
    nat_reduced, nat_trace = native.preprocess_native(formula, 7.0)
    assert nat_reduced.varnum == py_reduced.varnum
    assert nat_reduced.clauses == py_reduced.clauses
    assert [s for s in nat_trace.steps] == [s for s in py_trace.steps]


@pytest.mark.parametrize("seed", range(8))
def test_native_preprocess_parity_stress(seed):
    """Adversarial parity fuzz for the flat candidate scan: wide clauses
    (more merge steps per resolvent), dense formulas (bigger resolvent
    sets through dedup+subsumption), plus injected duplicate literals
    and tautological/near-tautological clauses — the cases where the
    linear-merge tautology detection (adjacent-value complement probes,
    including the shared-literal dedup branch) must match the Python
    twin's binary-search formulation exactly."""
    from odesat_tpu.cnf.formula import Literal

    rng = np.random.default_rng(1300 + seed)
    base = random_formula(rng, n_vars=20, n_clauses=80, max_width=5, min_width=1)
    clauses = list(base.clauses)
    for _ in range(10):
        width = int(rng.integers(2, 6))
        vs = rng.choice(np.arange(1, 21), size=width, replace=True)  # dup vars
        lits = [Literal(int(v), bool(rng.integers(0, 2))) for v in vs]
        if rng.integers(0, 2):  # half get an explicit complementary pair
            v = int(rng.integers(1, 21))
            lits += [Literal(v, False), Literal(v, True)]
        if rng.integers(0, 2):  # duplicate literal
            lits.append(lits[0])
        clauses.append(tuple(lits))
    formula = type(base)(clauses, 20)

    py_reduced, py_trace = preprocess_formula(formula, 7.0)
    nat_reduced, nat_trace = native.preprocess_native(formula, 7.0)
    assert nat_reduced.varnum == py_reduced.varnum
    assert nat_reduced.clauses == py_reduced.clauses
    assert [s for s in nat_trace.steps] == [s for s in py_trace.steps]


def test_native_greedy_pick_tie_break_lowest_var():
    """The greedy pick scans candidates in a cheap ratio-proxy order
    (with can't-win pruning) but must still resolve exact ratio TIES to
    the lowest variable — the reference's first-strict-less scan over
    ascending vars (src/cnf.rs:717-754). Two disjoint, literally
    identical variable neighborhoods force a tie; the trace's first VE
    step must name the lower variable, byte-identical to the Python
    twin."""
    from odesat_tpu.cnf.formula import CNFFormula, Literal
    from odesat_tpu.preprocess.trace import VariableElimination

    def block(a, b, c):
        return [
            (Literal(a, False), Literal(b, False)),
            (Literal(a, True), Literal(c, False)),
            (Literal(b, False), Literal(c, True)),
        ]

    # vars (1,2,3) and (4,5,6) are symmetric: eliminating 1 or 4 yields
    # the same ratio, so the pick is a pure tie-break
    formula = CNFFormula(block(1, 2, 3) + block(4, 5, 6), 6)
    py_reduced, py_trace = preprocess_formula(formula, 50.0, native=False)
    nat_reduced, nat_trace = native.preprocess_native(formula, 50.0)
    assert nat_reduced.clauses == py_reduced.clauses
    assert list(nat_trace.steps) == list(py_trace.steps)
    first_ve = next(
        (s for s in nat_trace.steps if isinstance(s, VariableElimination)), None
    )
    if first_ve is not None:  # BCE may fire first; the parity above is primary
        assert first_ve.variable in (1, 2, 3)


def test_native_preprocess_easy(data_dir):
    formula = parse_dimacs_file(os.path.join(data_dir, "easy.cnf"))
    py_reduced, py_trace = preprocess_formula(formula, 7.0)
    nat_reduced, nat_trace = native.preprocess_native(formula, 7.0)
    assert nat_reduced.clauses == py_reduced.clauses
    assert nat_reduced.varnum == py_reduced.varnum
    assert [s for s in nat_trace.steps] == [s for s in py_trace.steps]


@pytest.mark.parametrize("seed", range(6))
def test_native_trace_reconstructs_witness(seed):
    rng = np.random.default_rng(500 + seed)
    formula = random_formula(rng, n_vars=8, n_clauses=14, max_width=3)
    if brute_force_sat(formula) is None:
        pytest.skip("instance UNSAT")
    reduced, trace = native.preprocess_native(formula, 4.0)
    assignment = brute_force_sat(reduced)
    assert assignment is not None
    reconstruct_witness(assignment, trace)
    assert evaluate_cnf(assignment, formula)


def test_baseline_solver_runs(data_dir):
    formula = parse_dimacs_file(os.path.join(data_dir, "hard.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    rate = native.baseline_steps_per_sec(normalized, steps=2000, dt=0.01, zeta=0.001)
    assert rate > 1000  # any sane machine does >1k steps/s on 160 clauses
