"""Load-robust uf250 north-star TTS protocol, with sub-chunk exact
steps-to-solution.

Wall-clock TTS swings with host load (the host paces chunks and shares
its cores), which says nothing about the solver. The shared
protocol (odesat_tpu/utils/tts.py — benchmarks/run_benchmarks.py uses
the same one) separates the load-independent part from the
load-dependent part:

* **steps-to-solution** per instance is deterministic given the seed —
  a pure solver-quality number with zero measurement noise. With
  ``--exact`` (the default) the final chunk is bisected so the step is
  exact, not chunk-granular;
* **compute TTS** = steps x batch / measured steady-state kernel rate —
  what the hardware needs at the measured kernel throughput;
* **dispatch latency** is measured separately (median of repeated
  no-op dispatch+sync round trips) and multiplied by the chunk count;
* the residual (wall - compute - dispatch) is host/load noise, reported
  so the spread is explained rather than absorbed.

Usage: python tools/uf250_tts.py [n_instances] [batch] [chunk] [--exact]
       (--exact is accepted for compatibility; exact is always on)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import numpy as np

from odesat_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
from odesat_tpu.cnf.evaluate import evaluate_cnf
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.generate import uf_instance
from odesat_tpu.utils.timing import measure_throughput
from odesat_tpu.utils.tts import (
    evict_formula,
    measure_dispatch_latency,
    solve_exact,
    tts_breakdown,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_instances", nargs="?", type=int, default=20)
    ap.add_argument("batch", nargs="?", type=int, default=4096)
    ap.add_argument("chunk", nargs="?", type=int, default=64)
    ap.add_argument("--exact", action="store_true",
                    help="no-op (exact final-chunk bisection is always on)")
    ap.add_argument("--budget", type=int, default=20000)
    args = ap.parse_args()
    n_inst, B, CHUNK = args.n_instances, args.batch, args.chunk

    dispatch_s = measure_dispatch_latency()
    print(f"dispatch+sync round trip: median {dispatch_s*1e3:.1f} ms (over 15)")

    # --- steady-state kernel rate on the uf250 shape ------------------------
    inst0 = uf_instance(250, seed=0)
    _, norm0 = normalize_cnf_variables(inst0)
    fa = compile_formula(norm0)
    ode = ODEConfig(step_size=0.01, matmul_dtype="bfloat16")
    runner = make_chunk_runner(fa, ode.resolve_zeta(fa.density), ode, 2000)
    st = init_state(fa, B, jax.random.PRNGKey(0), ode)
    rate, _ = measure_throughput(runner, st, formula_device(fa), 2000, B, iters=3)
    print(f"steady-state kernel rate at B={B}: {rate:.3e} traj*steps/s")

    # --- instances (shared runner cache: same padded shape) -----------------
    cache: dict = {}
    rows = []
    for seed in range(n_inst):
        inst = uf_instance(250, seed=seed)
        _, norm = normalize_cnf_variables(inst)
        fa_i = compile_formula(norm)
        res = solve_exact(fa_i, ode, B, jax.random.PRNGKey(seed), CHUNK,
                          args.budget, runner_cache=cache, readout=True)
        verified = bool(
            res.solved
            and evaluate_cnf(
                # assignment[i] is normalized variable i (0-based dense
                # indices, cnf/normalize.py) — NOT 1-based DIMACS names
                {i: bool(a) for i, a in enumerate(res.assignment)}, norm
            )
        )
        bd = tts_breakdown(res.steps, res.chunks, B, rate, dispatch_s, res.wall_s)
        rows.append((seed, res.solved, verified, bd))
        # each instance is a fresh formula object: drop its runners so a
        # long sweep doesn't pin every instance's device planes (the
        # shape-keyed kernel caches keep the compiles)
        evict_formula(cache, fa_i)

    print(f"\n{'seed':>4} {'solved':>6} {'verif':>5} {'steps':>6} {'wall s':>7} "
          f"{'compute s':>9} {'dispatch s':>10} {'residual s':>10}")
    for seed, ok, ver, bd in rows:
        print(f"{seed:>4} {str(ok):>6} {str(ver):>5} {bd['steps']:>6} "
              f"{bd['wall_s']:>7.2f} {bd['compute_s']:>9.4f} "
              f"{bd['dispatch_s']:>10.3f} {bd['residual_s']:>10.3f}")

    solved = sum(1 for r in rows if r[1])
    steps = np.array([r[3]["steps"] for r in rows if r[1]])
    walls = np.array([r[3]["wall_s"] for r in rows if r[1]])
    comps = np.array([r[3]["compute_s"] for r in rows if r[1]])
    ovhs = np.array([r[3]["dispatch_s"] for r in rows if r[1]])
    resid = walls - comps - ovhs
    print(f"\nsolved {solved}/{n_inst} (all verified: "
          f"{all(r[2] for r in rows if r[1])})")
    print(f"steps-to-solution (EXACT): median {np.median(steps):.0f}, "
          f"p90 {np.percentile(steps, 90):.0f}, max {steps.max()}, "
          f"min {steps.min()}")
    print(f"compute TTS (steps x B / kernel rate): median "
          f"{np.median(comps)*1e3:.1f} ms, p90 {np.percentile(comps, 90)*1e3:.1f} ms")
    print(f"dispatch share (chunks x {dispatch_s*1e3:.1f} ms): median "
          f"{np.median(ovhs)*1e3:.0f} ms")
    print(f"wall TTS: median {np.median(walls)*1e3:.0f} ms, "
          f"p90 {np.percentile(walls, 90)*1e3:.0f} ms, max {walls.max()*1e3:.0f} ms")
    print(f"residual (host/load noise): median {np.median(resid)*1e3:.0f} ms, "
          f"p90 {np.percentile(resid, 90)*1e3:.0f} ms")


if __name__ == "__main__":
    main()
