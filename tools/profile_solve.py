"""Capture a jax.profiler trace of the solver hot loop.

    python tools/profile_solve.py [-f CNF] [-b BATCH] [--steps N] [-o DIR]

Open the resulting directory with TensorBoard's profile plugin or
xprof. The reference has no profiling story at all (SURVEY.md §5); this
plus utils/logging.Throughput is the rebuild's.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.timing import sync


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-f", "--input", default="tests/data/hard.cnf")
    parser.add_argument("-b", "--batch", type=int, default=8192)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--dv-strategy", default="auto")
    parser.add_argument(
        "-o", "--out",
        default=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             ".scratch", "profile"),
    )
    args = parser.parse_args()

    formula = parse_dimacs_file(args.input)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    ode = ODEConfig(step_size=0.01, dv_strategy=args.dv_strategy)
    runner = make_chunk_runner(fa, ode.resolve_zeta(fa.density), ode, args.steps)
    dev = formula_device(fa)
    state = init_state(fa, args.batch, jax.random.PRNGKey(0), ode)

    state = runner(state, dev)  # compile outside the trace
    sync(state)

    jax.profiler.start_trace(args.out)
    with jax.profiler.TraceAnnotation("solve_chunk"):
        state = runner(state, dev)
        sync(state)
    jax.profiler.stop_trace()
    print(f"trace written to {args.out}")


if __name__ == "__main__":
    main()
