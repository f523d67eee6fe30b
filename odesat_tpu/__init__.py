"""odesat_tpu — a continuous-time SAT solver framework for GPUs, in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
Rust solver `odesat` (Bearden, Pei & Di Ventra, "Efficient Solution of
Boolean Satisfiability Problems with Digital MemComputing",
arXiv:2011.06551): a CNF formula is compiled to dense padded incidence
arrays, mapped to a dissipative ODE over variable values plus per-clause
short/long-term memories, and integrated with fixed or adaptive forward
Euler until every clause's analog satisfaction degree crosses a threshold.
Thousands of independent trajectories run vmapped per device and shard over
a device mesh; for huge CNFs the clause axis is sharded with psum
reductions of per-variable gradient contributions.

Facade mirrors the reference library surface (reference: src/lib.rs:1-3,
exporting `cnf`, `stoch`, `system`).
"""

from odesat_tpu import cnf, models, ops, parallel, preprocess, utils
from odesat_tpu.cnf import (
    CNFFormula,
    FormulaArrays,
    Literal,
    bandwidth_reorder,
    compile_formula,
    cnf_to_dimacs,
    evaluate_cnf,
    normalize_cnf_variables,
    parse_dimacs,
    render_variable_map,
)
from odesat_tpu.models import ode, stoch
from odesat_tpu.models.hybrid import hybrid_search
from odesat_tpu.models.ode import SolveResult, simulate, simulate_batch
from odesat_tpu.models.stoch import search
from odesat_tpu.preprocess import preprocess_formula, reconstruct_witness
from odesat_tpu.utils.cache import enable_compilation_cache
from odesat_tpu.utils.config import ODEConfig, SolverConfig

__version__ = "0.4.0"

__all__ = [
    "CNFFormula",
    "FormulaArrays",
    "Literal",
    "ODEConfig",
    "SolveResult",
    "SolverConfig",
    "bandwidth_reorder",
    "cnf",
    "cnf_to_dimacs",
    "compile_formula",
    "enable_compilation_cache",
    "evaluate_cnf",
    "hybrid_search",
    "models",
    "normalize_cnf_variables",
    "ode",
    "ops",
    "parallel",
    "parse_dimacs",
    "preprocess",
    "preprocess_formula",
    "reconstruct_witness",
    "render_variable_map",
    "search",
    "simulate",
    "simulate_batch",
    "stoch",
    "utils",
]
