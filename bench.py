"""Benchmark harness: trajectories*steps/sec on the bundled hard.cnf.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}. Runs only on a GPU: with no GPU it exits nonzero and prints
no result.

Baseline: the reference publishes no numbers (BASELINE.md), so the
baseline is measured live on this host: a single-threaded C++
implementation of the same ODE semantics
(odesat_tpu/native/odesat_native.cc, odesat_baseline_steps_per_sec) runs
the identical fixed-step workload on one CPU core. If the native library
cannot build, the benchmark fails instead of assuming a number.
"""

import json
import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
from odesat_tpu.utils.config import ODEConfig

HERE = os.path.dirname(os.path.abspath(__file__))
METRIC = "trajectories*steps/sec (hard.cnf, fixed dt=0.01, b=16384)"


def require_gpu_device():
    """The first device, or SystemExit when JAX finds no GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {dev.platform!r} "
            "devices only"
        )
    return dev


def measure_baseline(normalized) -> float:
    """Single-core CPU steps/s on the same instance (C++, measured live).
    Best of five: the host CPU is shared, so one measurement swings with
    load."""
    from odesat_tpu import native

    if not native.is_available():
        raise RuntimeError("the native baseline library did not build; no baseline")
    return max(
        native.baseline_steps_per_sec(normalized, steps=20000, dt=0.01, zeta=0.001)
        for _ in range(5)
    )


def bench_fixed_step(batch_size: int = 16384, chunk_steps: int = 16384, repeats: int = 3):
    from odesat_tpu.utils.timing import measure_throughput

    formula = parse_dimacs_file(os.path.join(HERE, "tests", "data", "hard.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    ode = ODEConfig(step_size=0.01)
    zeta = ode.resolve_zeta(fa.density)

    dev = formula_device(fa)
    runner = make_chunk_runner(fa, zeta, ode, chunk_steps)
    state = init_state(fa, batch_size, jax.random.PRNGKey(0), ode)
    rate, _ = measure_throughput(runner, state, dev, chunk_steps, batch_size, iters=repeats)
    return rate, normalized


def main():
    device = require_gpu_device()
    from odesat_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    rate, normalized = bench_fixed_step()
    baseline = measure_baseline(normalized)
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": rate,
                "unit": "traj*steps/s",
                "vs_baseline": rate / baseline,
                "device": {
                    "platform": device.platform,
                    "kind": device.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
