"""Test harness configuration.

Tests run on CPU with 8 virtual devices so mesh-sharded paths are
exercised without GPUs (SURVEY.md §4: the rebuild's fake-backend
strategy). Must run before jax is imported anywhere. An explicit
``JAX_PLATFORMS`` wins, so the tests marked ``gpu`` run on a card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)  # float64 oracle comparisons on CPU

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from odesat_tpu.cnf.formula import CNFFormula, Literal  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="session")
def data_dir():
    return DATA_DIR


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Tests that run a
    kernel compiled for the card (no interpret mode) take this fixture
    and the ``gpu`` marker."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run with JAX_PLATFORMS=cuda ... -m gpu)")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Let the path chooser (ops/select.py) see a GPU and run the fused
    kernel in the Pallas interpreter, so CPU tests reach the kernel
    paths of the runners. Production code never interprets."""
    from functools import partial

    from odesat_tpu.ops import fused_pallas, select

    monkeypatch.setattr(select, "gpu_available", lambda: True)
    monkeypatch.setattr(
        fused_pallas, "make_fused_chunk", partial(fused_pallas.make_fused_chunk, interpret=True)
    )


def random_formula(
    rng: np.random.Generator, n_vars: int, n_clauses: int, max_width: int = 3, min_width: int = 1
):
    """Random CNF over variables 1..n_vars with widths min_width..max_width."""
    clauses = []
    for _ in range(n_clauses):
        width = int(rng.integers(min_width, max_width + 1))
        variables = rng.choice(np.arange(1, n_vars + 1), size=min(width, n_vars), replace=False)
        clauses.append(tuple(Literal(int(v), bool(rng.integers(0, 2))) for v in variables))
    return CNFFormula(clauses, n_vars)


def brute_force_sat(formula: CNFFormula):
    """Exhaustive satisfiability over used variables; returns a satisfying
    dict or None. Only for tiny test formulas."""
    variables = sorted(formula.variable_set())
    for bits in range(1 << len(variables)):
        assignment = {v: bool((bits >> i) & 1) for i, v in enumerate(variables)}
        if all(
            any(assignment[lit.variable] != lit.is_negated for lit in clause)
            for clause in formula.clauses
        ):
            return assignment
    return None
