"""dv-accumulation strategy shootout (SURVEY.md §7 hard-part #2).

Benchmarks the scan accumulators (gather, segment_sum, onehot) against
the fused kernel across formula sizes on the GPU; the results show where
``dv_strategy="auto"`` (ops/select.py) should switch. Writes
benchmarks/strategy_results.json (gitignored), labelled with the device.

    python benchmarks/strategy_bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.generate import random_ksat

SIZES = [
    ("aim100", 100, 160),
    ("uf250", 250, 1065),
    ("n1k", 1000, 4300),
    ("n4k", 4000, 17200),
]
STRATEGIES = ["gather", "segment_sum", "onehot", "fused"]


def rate(fa, ode, batch, chunk=500, repeats=3):
    from odesat_tpu.utils.timing import measure_throughput

    zeta = ode.resolve_zeta(fa.density)
    runner = make_chunk_runner(fa, zeta, ode, chunk)
    dev = formula_device(fa)
    state = init_state(fa, batch, jax.random.PRNGKey(0), ode)
    out, _ = measure_throughput(runner, state, dev, chunk, batch, iters=repeats)
    return out


def main():
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"strategy_bench measures the GPU; JAX found {device.platform!r}")
    results = {"device": {"platform": device.platform, "kind": device.device_kind}}
    for name, n, m in SIZES:
        formula = random_ksat(n, m, k=3, seed=1)
        _, normalized = normalize_cnf_variables(formula)
        fa = compile_formula(normalized)
        batch = max(512, min(16384, (1 << 24) // (n + 2 * m)))
        row = {"batch": batch}
        for strategy in STRATEGIES:
            try:
                ode = ODEConfig(step_size=0.01, dv_strategy=strategy)
                row[strategy] = round(rate(fa, ode, batch), 1)
            except Exception as e:  # noqa: BLE001 — report and continue
                row[strategy] = f"error: {type(e).__name__}: {e}"[:120]
        results[name] = row
        print(name, json.dumps(row))
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "strategy_results.json")
    with open(out, "w") as fh:
        json.dump(results, fh, indent=2)


if __name__ == "__main__":
    main()
