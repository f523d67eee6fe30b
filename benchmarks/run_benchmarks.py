"""Full benchmark suite over BASELINE.md's measurement configs.

Reports trajectories*steps/sec and median time-to-solution and writes
benchmarks/results.json (gitignored), labelled with the device. Runs
only on a GPU:

    python benchmarks/run_benchmarks.py [--quick]

Configs (BASELINE.md):
  1. easy.cnf, single trajectory, fixed-step (solve -n 1000 -s 0.01)
  2. small.cnf, batch b=100 fixed step (vmapped restarts)
  3. hard.cnf, adaptive step + tolerance
  4. random 3-SAT n=1k m/n=4.3, ratio-7 preprocessing, 10k interlaced
     trajectories per device
  5. uf250-class instance, trajectory batch (clause sharding needs >1
     device; exercised in tests/test_sharding.py on the CPU mesh)
  6. locally-structured n=4096
  7. SAT-competition-scale n=10240 on the scan path

SATLIB substitution note: this
environment has no network egress, so the *named* SATLIB uf250 files
cannot be fetched. Config 5 uses generated instances of the same
construction — uniform random 3-SAT at n=250, m=1065 (ratio 4.26) —
with a planted satisfying assignment so every instance is certainly
SAT. SATLIB's originals are *filtered* SAT (unplanted, SAT-verified);
planted instances at the phase-transition ratio are statistically close
but not identical (planting mildly biases clause polarities around the
hidden assignment).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from odesat_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()
import numpy as np

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner, simulate_batch
from odesat_tpu.preprocess import preprocess_formula
from odesat_tpu.utils.config import ODEConfig, SolverConfig
from odesat_tpu.utils.generate import random_ksat

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(os.path.dirname(HERE), "tests", "data")


def throughput(fa, ode, batch, chunk, repeats=3):
    """Steady-state trajectories*steps/s of the chunk runner."""
    from odesat_tpu.utils.timing import measure_throughput

    zeta = ode.resolve_zeta(fa.density)
    runner = make_chunk_runner(fa, zeta, ode, chunk)
    dev = formula_device(fa)
    state = init_state(fa, batch, jax.random.PRNGKey(0), ode)
    rate, _ = measure_throughput(runner, state, dev, chunk, batch, iters=repeats)
    return rate


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="smaller batches/steps")
    args = parser.parse_args()
    q = args.quick

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"the benchmark suite measures the GPU; JAX found {device.platform!r}")
    results = {
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
        "configs": {},
    }

    # --- config 1: easy.cnf single trajectory fixed step -------------------
    formula = parse_dimacs_file(os.path.join(DATA, "easy.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    ode = ODEConfig(step_size=0.01)
    results["configs"]["easy_single_fixed"] = {
        # chunk matches the solver's dispatch-amortization heuristic for
        # tiny batches (models/ode.py simulate_batch)
        "traj_steps_per_sec": throughput(fa, ode, batch=1, chunk=1000 if q else 32768),
        "note": "B=1 is the reference's solve mode; dispatch-amortized chunks",
    }

    # --- config 2: small.cnf batch 100 fixed (load-robust protocol:
    # exact steps-to-solution + compute/dispatch/wall split, the same
    # odesat_tpu.utils.tts implementation tools/uf250_tts.py uses) ------
    from odesat_tpu.utils.tts import (
        evict_formula,
        measure_dispatch_latency,
        solve_exact,
        tts_breakdown,
    )

    dispatch_s = measure_dispatch_latency()
    results["dispatch_latency_s"] = dispatch_s

    formula = parse_dimacs_file(os.path.join(DATA, "small.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    fa2 = compile_formula(normalized)
    ode2 = ODEConfig(step_size=0.01)
    rate2 = throughput(fa2, ode2, batch=100, chunk=1000)
    cache2: dict = {}
    rows2 = []
    for seed in range(3 if q else 5):
        res = solve_exact(fa2, ode2, 100, jax.random.PRNGKey(seed), 64, 1000,
                          runner_cache=cache2)
        rows2.append(
            tts_breakdown(res.steps, res.chunks, 100, rate2, dispatch_s,
                          res.wall_s)
            | {"solved": res.solved}
        )
    results["configs"]["small_batch100_fixed"] = {
        "median_steps_to_solution": int(np.median([r["steps"] for r in rows2])),
        "compute_tts_s": float(np.median([r["compute_s"] for r in rows2])),
        "median_wall_s": float(np.median([r["wall_s"] for r in rows2])),
        "solved": f"{sum(r['solved'] for r in rows2)}/{len(rows2)}",
        "note": "exact steps via final-chunk bisection (utils/tts.py); "
        "wall includes per-chunk host round trips",
    }

    # --- config 3: hard.cnf adaptive --------------------------------------
    formula = parse_dimacs_file(os.path.join(DATA, "hard.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    ode = ODEConfig()  # adaptive, tol 1e-3
    results["configs"]["hard_adaptive"] = {
        "traj_steps_per_sec": throughput(
            fa, ode, batch=2048 if q else 8192, chunk=200 if q else 2000
        ),
        "note": "adaptive = 2 RHS evals + 3 updates per step",
    }
    ode_fixed = ODEConfig(step_size=0.01)
    results["configs"]["hard_fixed"] = {
        "traj_steps_per_sec": throughput(
            fa, ode_fixed, batch=4096 if q else 16384, chunk=500 if q else 4000
        ),
    }

    # --- config 3c: END-TO-END effective throughput (includes dispatch +
    # done-flag pulls + chunk escalation; what a real solve delivers) ----
    cfg_eff = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=10240 if q else 40960,
                      ),
        batch_size=4096 if q else 16384,
        seed=0,
        chunk_steps=256,
    )
    simulate_batch(normalized, cfg_eff)  # warm the kernel caches
    t0 = time.perf_counter()
    simulate_batch(normalized, cfg_eff)
    eff_dt = time.perf_counter() - t0
    results["configs"]["hard_fixed_effective"] = {
        "traj_steps_per_sec": cfg_eff.batch_size * cfg_eff.ode.steps / eff_dt,
        "note": "end-to-end simulate_batch incl. host round trips (UNSAT: full budget)",
    }

    # --- config 4: random 3-SAT n=1k, preprocessing, 10k interlaced -------
    formula = random_ksat(1000, 4300, k=3, seed=7, planted=True)
    t0 = time.perf_counter()
    reduced, trace = preprocess_formula(formula, 7.0)
    prep_s = time.perf_counter() - t0
    _, normalized = normalize_cnf_variables(reduced)
    fa = compile_formula(normalized, bucket=True)  # VE emits mixed widths
    ode = ODEConfig(step_size=0.01)
    results["configs"]["random3sat_n1k_inter10k"] = {
        "preprocess_s": prep_s,
        "reduced_clauses": reduced.num_clauses,
        "reduced_vars": reduced.varnum,
        "traj_steps_per_sec": throughput(
            fa, ode, batch=2048 if q else 10240, chunk=100 if q else 200
        ),
    }

    # --- config 5: uf250-class --------------------------------------------
    formula = random_ksat(250, 1065, k=3, seed=11, planted=True)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    results["configs"]["uf250_fixed"] = {
        "traj_steps_per_sec": throughput(
            fa,
            ODEConfig(step_size=0.01),
            batch=4096 if q else 16384,
            chunk=200 if q else 2000,
        ),
    }

    # --- config 5b: uf250 time-to-solution (north-star metric) ------------
    # Load-robust protocol, same odesat_tpu.utils.tts implementation as
    # tools/uf250_tts.py (exact sub-chunk steps-to-solution via
    # final-chunk bisection; one protocol, so both report alike).
    from odesat_tpu.utils.generate import uf_instance

    b_tts = 1024 if q else 4096
    inst0 = uf_instance(250, seed=0)
    _, norm0 = normalize_cnf_variables(inst0)
    ode_tts = ODEConfig(step_size=0.01)
    rate_tts = throughput(
        compile_formula(norm0), ode_tts, batch=b_tts, chunk=200 if q else 2000
    )
    cache5: dict = {}
    rows5 = []
    n_seeds = 3 if q else 5
    for seed in range(n_seeds):
        inst = uf_instance(250, seed=seed)
        _, norm_i = normalize_cnf_variables(inst)
        fa_i = compile_formula(norm_i)
        res = solve_exact(
            fa_i, ode_tts, b_tts, jax.random.PRNGKey(seed),
            64, 20000, runner_cache=cache5,
        )
        evict_formula(cache5, fa_i)  # fresh formula per seed: don't pin them all
        rows5.append(
            tts_breakdown(res.steps, res.chunks, b_tts, rate_tts, dispatch_s,
                          res.wall_s)
            | {"solved": res.solved}
        )
    results["configs"]["uf250_median_tts"] = {
        "median_steps_to_solution": int(np.median([r["steps"] for r in rows5])),
        "compute_tts_s": float(np.median([r["compute_s"] for r in rows5])),
        "median_wall_s": float(np.median([r["wall_s"] for r in rows5])),
        "solved": f"{sum(r['solved'] for r in rows5)}/{n_seeds}",
        "note": "EXACT steps-to-solution (final-chunk bisection, utils/tts.py); "
        "wall - compute - dispatch = host/load noise (see tools/uf250_tts.py)",
    }

    # --- config 6: locally-structured n=4096 --------------------------------
    from odesat_tpu.utils.generate import random_local_ksat

    formula = random_local_ksat(4096, 17203, k=3, locality=256, seed=3)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    results["configs"]["local3sat_n4096"] = {
        "traj_steps_per_sec": throughput(
            fa,
            ODEConfig(step_size=0.01),
            batch=2048 if q else 10240,
            chunk=100 if q else 200,
        ),
    }

    # --- config 7: SAT-competition-scale n=10240 (scan path) ------------
    formula = random_local_ksat(10240, 43700, k=3, locality=512, seed=9)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    results["configs"]["local3sat_n10240"] = {
        "traj_steps_per_sec": throughput(
            fa, ODEConfig(step_size=0.01), batch=256 if q else 1024, chunk=100
        ),
    }

    out = os.path.join(HERE, "results.json")
    with open(out, "w") as fh:
        json.dump(results, fh, indent=2)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
