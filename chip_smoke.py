"""On-card smoke test: the solver's main path on one NVIDIA GPU.

    python chip_smoke.py          # every one-card phase below
    python chip_smoke.py --four   # only the four-card phase

Phases (each failure exits nonzero; nothing is caught and reported as a
pass):

1. device   — JAX must report a GPU; prints the card's name and power
              limit as nvidia-smi gives them;
2. compile  — the fused Pallas chunk kernel (ops/fused_pallas.py,
              Triton route) at hard.cnf and uf250 widths, with
              ``compiled.memory_analysis()``;
3. parity   — the kernel against the scan path (``dv_strategy="gather"``)
              and the NumPy oracle (ops/oracle.py) at hard.cnf width;
4. cli      — the CLI entry point in this process (``cli.main(argv)``),
              checking each oracle verdict;
5. timing   — kernel against the XLA scan path: raw chunk rate and the
              wall time of ``simulate_batch`` to its verdict.

``--four`` runs the multi-device paths on four cards (trajectory data
parallelism, the clause mesh, the stochastic engine) against one-card
runs from the same initial state. The last line of standard output is
one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
WORK = os.path.join(HERE, ".scratch", "chip_smoke")  # gitignored inputs

# Parity tolerances, f32 mode. The forward pass is exact (each literal
# value is one product with a +-1 plane entry), but dv sums a variable's
# <= D contributions in the order of the transposed dot rather than the
# gather's, so single steps differ in the last bits (~1e-7). 16 fixed
# steps keep that below 1e-6. The adaptive step evaluates the RHS twice
# per step and feeds the error norm back into dt (dt *= sqrt(tol/err)),
# which amplifies last-bit differences: 16 adaptive steps reach ~1e-5
# (1.0e-5 measured on an H100, 8e-6 on the CPU), hence a looser bound.
TOL_ABS = {"fixed": 1e-5, "adaptive": 5e-5}  # on v, xs and dt
TOL_REL = {"fixed": 1e-5, "adaptive": 5e-5}  # on xl (it grows to ~1e2, so relative)
# bf16 mode rounds v and the contributions to 8 significand bits. Near-tied
# literal values then swap which one is the clause minimum, and the paper
# rigidity term (1 + zeta*xl)(1 - xs)(q - v)/2, up to ~2 in size, switches
# on or off for that literal: one step of dt=0.01 may move v by a few
# times dt * 2. So one step is bounded by 0.05, and 16 steps, where
# trajectories have parted, only by finite, in-range states.
TOL_BF16_ONE_STEP = 5e-2
# the f64 oracle against the f32 kernel over 16 steps: f32 rounding
# (~6e-8 per operation) grown by the same dynamics
TOL_ORACLE = 1e-4


def log(*args):
    print(*args, flush=True)


def require_gpu():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {devices[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {len(devices)} x {devices[0].device_kind}")
    log(smi.splitlines()[0])
    return devices


def load_hard():
    from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file

    _, hard = normalize_cnf_variables(parse_dimacs_file(os.path.join(DATA, "hard.cnf")))
    return hard, compile_formula(hard)


def load_uf250():
    from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu.utils.generate import random_ksat

    _, uf = normalize_cnf_variables(random_ksat(250, 1065, k=3, seed=0, planted=True))
    return uf, compile_formula(uf)


def max_errors(a, b):
    import numpy as np

    f = lambda x: np.asarray(x, np.float64)  # noqa: E731
    return {
        "v": float(np.max(np.abs(f(a.v) - f(b.v)))),
        "xs": float(np.max(np.abs(f(a.xs) - f(b.xs)))),
        "xl_rel": float(np.max(np.abs(f(a.xl) - f(b.xl)) / f(b.xl))),
        "dt": float(np.max(np.abs(f(a.dt) - f(b.dt)))),
        "done_equal": bool((np.asarray(a.done) == np.asarray(b.done)).all()),
    }


def phase_compile(fa_h, fa_u):
    import jax

    from odesat_tpu.models.ode import init_state
    from odesat_tpu.ops.fused_pallas import make_fused_chunk
    from odesat_tpu.utils.config import ODEConfig

    for name, fa, B, step in (("hard.cnf", fa_h, 16384, 0.01), ("uf250", fa_u, 4096, None)):
        for mm in ("float32", "bfloat16"):
            ode = ODEConfig(step_size=step, matmul_dtype=mm)
            kernel = make_fused_chunk(fa, 0.001, ode, 256)
            state = init_state(fa, B, jax.random.PRNGKey(0), ode)
            t0 = time.perf_counter()
            compiled = kernel._core.lower(state, *kernel._extra).compile()
            log(f"[compile] {name} B={B} {'fixed' if step else 'adaptive'} {mm}: "
                f"{time.perf_counter() - t0:.2f}s {compiled.memory_analysis()}")


def phase_parity(hard, fa_h):
    import jax
    import numpy as np

    from odesat_tpu.constants import DT_INIT
    from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
    from odesat_tpu.ops.fused_pallas import make_fused_chunk
    from odesat_tpu.ops.oracle import (
        compute_derivatives_oracle,
        max_error_oracle,
        update_state_oracle,
    )
    from odesat_tpu.utils.config import ODEConfig

    dev = formula_device(fa_h)
    steps, zeta = 16, 0.001
    for mode in ("fixed", "adaptive"):
        for rigidity in ("paper", "reference"):
            ode = ODEConfig(step_size=0.01 if mode == "fixed" else None, rigidity=rigidity,
                            dv_strategy="gather")
            state = init_state(fa_h, 512, jax.random.PRNGKey(3), ode)
            ref = make_chunk_runner(fa_h, zeta, ode, steps, donate=False)(state, dev)
            out = make_fused_chunk(fa_h, zeta, ode, steps)(state)
            e = max_errors(out, ref)
            log(f"[parity] f32 {mode} {rigidity} vs scan, {steps} steps: {e}")
            ta, tr = TOL_ABS[mode], TOL_REL[mode]
            if not (e["v"] <= ta and e["xs"] <= ta and e["xl_rel"] <= tr
                    and e["dt"] <= ta and e["done_equal"]):
                raise SystemExit(f"f32 parity out of tolerance ({ta} abs, {tr} rel)")

            # two trajectories against the scalar-loop f64 oracle
            v0 = np.asarray(state.v[:2], np.float64)
            M = fa_h.n_clauses
            got = make_fused_chunk(fa_h, zeta, ode, steps)(jax.tree.map(lambda x: x[:2], state))
            for row in range(2):
                v, xs, xl = v0[row], np.asarray(fa_h.xs_init, np.float64), np.ones(fa_h.n_clauses_padded)
                dt = DT_INIT
                for _ in range(steps):
                    dv, dxs, dxl, allsat = compute_derivatives_oracle(v, xs, xl, hard, zeta, rigidity)
                    if mode == "fixed":
                        v, xs, xl = update_state_oracle(v, xs, xl, dv, dxs, dxl, 0.01, M)
                        if allsat:
                            break
                        continue
                    if allsat:
                        break
                    fv = update_state_oracle(v, xs, xl, dv, dxs, dxl, dt, M)
                    hv, hxs, hxl = update_state_oracle(v, xs, xl, dv, dxs, dxl, 0.5 * dt, M)
                    d2 = compute_derivatives_oracle(hv, hxs, hxl, hard, zeta, rigidity)
                    v, xs, xl = update_state_oracle(hv, hxs, hxl, *d2[:3], 0.5 * dt, M)
                    err = max_error_oracle(fv, (v, xs, xl))
                    dt = min(max(dt * np.sqrt(1e-3 / err) if err > 0 else 1e3, 2.0**-7), 1e3)
                m = slice(0, fa_h.n_clauses)
                eo = max(
                    float(np.max(np.abs(np.asarray(got.v[row], np.float64) - v))),
                    float(np.max(np.abs(np.asarray(got.xs[row], np.float64)[m] - xs[m]))),
                    float(np.max(np.abs(np.asarray(got.xl[row], np.float64)[m] - xl[m]) / xl[m])),
                )
                log(f"[parity] f32 {mode} {rigidity} vs oracle, trajectory {row}: {eo:.3e}")
                if eo > TOL_ORACLE:
                    raise SystemExit(f"oracle parity out of tolerance ({TOL_ORACLE})")

    for mode in ("fixed", "adaptive"):
        ode = ODEConfig(step_size=0.01 if mode == "fixed" else None, matmul_dtype="bfloat16",
                        dv_strategy="gather")
        state = init_state(fa_h, 512, jax.random.PRNGKey(3), ode)
        for n in (1, steps):
            ref = make_chunk_runner(fa_h, zeta, ode, n, donate=False)(state, dev)
            out = make_fused_chunk(fa_h, zeta, ode, n)(state)
            e = max_errors(out, ref)
            log(f"[parity] bf16 {mode} vs f32 scan, {n} steps: {e}")
            finite = all(np.isfinite(np.asarray(x)).all() for x in (out.v, out.xs, out.xl))
            in_range = float(np.max(np.abs(np.asarray(out.v)))) <= 1.0
            if not (finite and in_range):
                raise SystemExit("bf16 kernel state is not finite or left [-1, 1]")
            if n == 1 and not (e["v"] <= TOL_BF16_ONE_STEP and e["xs"] <= TOL_BF16_ONE_STEP):
                raise SystemExit(f"bf16 one-step parity beyond {TOL_BF16_ONE_STEP}")


def run_cli(argv, expect):
    """Run ``odesat_tpu.cli.main(argv)`` here and check its oracle verdict
    (the CLI exits 0 either way, like the reference)."""
    from odesat_tpu.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    verdicts = [line for line in out.splitlines() if line.startswith("Checking if solution")]
    for line in out.splitlines():
        if line.startswith(("Winner:", "Clauses:", "wrote ")):
            log(f"    {line}")
    got = verdicts[-1].rsplit(":", 1)[1].strip() if verdicts else None
    log(f"[cli] {' '.join(argv[:1] + argv[2:])}: rc={rc} verdict={got} wall={wall:.2f}s")
    if rc != 0 or got is None or (expect is not None and got != expect):
        raise SystemExit(f"cli {argv[0]} gave verdict {got!r}, expected {expect!r}")
    return wall


def phase_cli():
    from odesat_tpu.cnf import cnf_to_dimacs, normalize_cnf_variables
    from odesat_tpu.preprocess import preprocess_formula
    from odesat_tpu.utils.generate import random_ksat

    os.makedirs(WORK, exist_ok=True)
    easy = os.path.join(DATA, "easy.cnf")
    hard = os.path.join(DATA, "hard.cnf")
    uf = os.path.join(WORK, "uf250.cnf")
    run_cli(["solve", "-f", easy, "--seed", "0"], "true")
    run_cli(["inter", "-f", hard, "-b", "16384", "-s", "0.01", "-n", "2000", "--seed", "0"], "false")
    from odesat_tpu.cli import main

    with contextlib.redirect_stdout(io.StringIO()):
        main(["gen", "-n", "250", "--planted", "--seed", "0", "-o", uf])
    run_cli(["inter", "-f", uf, "-b", "4096", "--seed", "0"], "true")
    run_cli(["stoch", "-f", easy, "-b", "4096", "--seed", "0"], "true")
    run_cli(["hybrid", "-f", easy, "-b", "1024", "--seed", "0"], "true")

    # preprocessed random 3-SAT at n=10240 (the scan path's segment_sum
    # branch: preprocessing widens occurrence lists past 32)
    t0 = time.perf_counter()
    reduced, _ = preprocess_formula(random_ksat(10240, 43622, k=3, seed=7, planted=True), 7.0)
    _, reduced = normalize_cnf_variables(reduced)
    big = os.path.join(WORK, "random3sat_n10240_pre.cnf")
    with open(big, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(reduced))
    log(f"[cli] n=10240 preprocessed in {time.perf_counter() - t0:.2f}s: "
        f"{reduced.varnum} vars, {reduced.num_clauses} clauses")
    B, n = 1024, 300
    wall = run_cli(["inter", "-f", big, "-b", str(B), "-s", "0.01", "-n", str(n), "--seed", "0"], None)
    log(f"[cli] n=10240 inter completed: {B * n / wall:.4e} traj*steps/s "
        "(wall clock of the CLI call, compile included)")


def phase_timing(fa_h, fa_u):
    import jax

    from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner, simulate_batch
    from odesat_tpu.utils.config import ODEConfig, SolverConfig

    def rate(runner, fa, ode, B, n, dev, iters=5):
        state = init_state(fa, B, jax.random.PRNGKey(0), ode)
        state = jax.block_until_ready(runner(state, dev))  # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            state = runner(state, dev)
        jax.block_until_ready(state)
        return B * n * iters / (time.perf_counter() - t0)

    cases = (
        ("hard.cnf fixed dt=0.01 B=16384", fa_h, 16384, 0.01, 4096),
        ("uf250 adaptive B=4096", fa_u, 4096, None, None),
    )
    for name, fa, B, step, budget in cases:
        dev = formula_device(fa)
        for strategy, mm in (("fused", "float32"), ("fused", "bfloat16"),
                             ("gather", "float32"), ("segment_sum", "float32")):
            ode = ODEConfig(step_size=step, dv_strategy=strategy, matmul_dtype=mm)
            n = 256
            r = rate(make_chunk_runner(fa, ode.resolve_zeta(fa.density), ode, n), fa, ode, B, n, dev)
            cfg = SolverConfig(ode=ODEConfig(step_size=step, steps=budget, dv_strategy=strategy,
                                             matmul_dtype=mm), batch_size=B, seed=0)
            # the compiled FormulaArrays is passed in, so the warm-up run
            # compiles every program the timed runs use
            simulate_batch(fa, cfg)
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                res = simulate_batch(fa, cfg)
                walls.append(time.perf_counter() - t0)
            log(f"[timing] {name} {strategy}/{mm}: chunk {r:.4e} traj*steps/s; "
                f"simulate_batch {min(walls):.4f}s to verdict (solved={res.any_solved}, "
                f"steps={res.steps})")


def phase_four(devices):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
    from odesat_tpu.models.stoch import StochState, init_stoch_state, make_stoch_chunk_runner
    from odesat_tpu.parallel.mesh import make_mesh
    from odesat_tpu.parallel.sharded import (
        compile_for_mesh,
        make_sharded_chunk_runner,
        make_sharded_stoch_runner,
        shard_inputs,
        shard_stoch_inputs,
    )
    from odesat_tpu.utils.config import ODEConfig, SolverConfig

    if len(devices) < 4:
        raise SystemExit(f"--four needs four GPUs; JAX found {len(devices)}")
    hard, _ = load_hard()
    steps = 16

    def show(tag, tree):
        for name, x in zip(tree._fields, tree):
            if isinstance(x.sharding, NamedSharding):
                log(f"    {tag}.{name}: {x.shape} {x.sharding.spec} on "
                    f"{sorted(d.id for d in x.sharding.device_set)}")

    # trajectory DP (the fused kernel per device under shard_map) and the
    # clause mesh (scan path, dv psum'd across cards), each against one card
    # fixed steps; trajectory DP runs the same kernel per card (parity
    # tolerance), the clause mesh adds the psum's summation order
    for n_traj, n_clause, tol in ((4, 1, TOL_ABS["fixed"]), (2, 2, 1e-4), (1, 4, 1e-4)):
        mesh = make_mesh(n_traj, n_clause, devices=devices[:4])
        config = SolverConfig(ode=ODEConfig(step_size=0.01))
        fa = compile_for_mesh(hard, config, mesh)
        state = init_state(fa, 4096, jax.random.PRNGKey(5), config.ode)
        dev = formula_device(fa)
        ref = make_chunk_runner(fa, 0.001, config.ode, steps, donate=False)(state, dev)
        st_m, dev_m = shard_inputs(jax.tree.map(lambda x: x.copy(), state), dev, mesh)
        show(f"traj={n_traj},clause={n_clause} state", st_m)
        out = make_sharded_chunk_runner(fa, 0.001, config.ode, steps, mesh)(st_m, dev_m)
        show(f"traj={n_traj},clause={n_clause} out", out)
        e = max_errors(out, ref)
        log(f"[four] traj={n_traj} clause={n_clause} vs one card, {steps} steps: {e}")
        if not (e["v"] <= tol and e["xs"] <= tol and e["xl_rel"] <= tol and e["done_equal"]):
            raise SystemExit(f"four-card parity beyond {tol}")

    # stochastic engine, trajectory DP: each card's slice equals a
    # one-card run of that slice with that card's key
    from odesat_tpu.cnf import compile_formula

    fa = compile_formula(hard)
    key = jax.random.PRNGKey(9)
    base = init_stoch_state(fa, 4096, key)
    keys = jax.random.split(key, 4)
    mesh = make_mesh(4, 1, devices=devices[:4])
    st = shard_stoch_inputs(StochState(base.v, base.xl, base.done, keys), mesh)
    show("stoch state", st)
    out = make_sharded_stoch_runner(fa, steps, mesh)(st)
    one = make_stoch_chunk_runner(fa, steps, donate=False)
    for i in range(4):
        rows = slice(i * 1024, (i + 1) * 1024)
        ref = one(StochState(base.v[rows], base.xl[rows], base.done[rows], keys[i]))
        if not (np.array_equal(np.asarray(out.v[rows]), np.asarray(ref.v))
                and np.array_equal(np.asarray(out.xl[rows]), np.asarray(ref.xl))):
            raise SystemExit(f"stoch device {i} disagrees with its one-card run")
    log("[four] stoch traj=4: every card's chains equal their one-card runs")

    # the documented CLI multi-device paths
    easy = os.path.join(DATA, "easy.cnf")
    hard_f = os.path.join(DATA, "hard.cnf")
    run_cli(["inter", "-f", hard_f, "-b", "16384", "-s", "0.01", "-n", "2000", "--devices", "4"],
            "false")
    run_cli(["inter", "-f", easy, "-b", "4096", "--devices", "2", "--clause-shards", "2",
             "--seed", "0"], "true")
    run_cli(["stoch", "-f", easy, "-b", "4096", "--devices", "4", "--seed", "0"], "true")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run only the four-card phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "odesat_tpu")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    devices = require_gpu()
    from odesat_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.perf_counter()
    if args.four:
        phase_four(devices)
        count = 4
    else:
        hard, fa_h = load_hard()
        _, fa_u = load_uf250()
        phase_compile(fa_h, fa_u)
        phase_parity(hard, fa_h)
        phase_cli()
        phase_timing(fa_h, fa_u)
        count = len(devices)
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
