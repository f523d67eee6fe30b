"""Command-line driver: ``odesat_tpu {solve,stoch,batch,inter}``.

Mirrors the reference CLI surface (reference: src/main.rs:19-141):
same subcommands, same short flags (-f input, -o output, -t tolerance,
-n steps, -s step size, -l learning rate, -r clause-to-variable ratio,
-b batch size), same pipeline per mode:

* solve  — preprocess to target ratio, normalize, single ODE trajectory,
           map back, reconstruct eliminated variables, verify, render
           (src/main.rs:143-204);
* stoch  — same pipeline with the stochastic engine (src/main.rs:206-251);
* batch  — NO preprocessing; B random restarts (parallel here, sequential
           in the reference), stop at the first oracle-verified
           assignment (src/main.rs:253-323);
* inter  — NO preprocessing; B interlaced trajectories, stop when any
           reaches allsat (src/main.rs:325-386).

Every mode prints ``Checking if solution vector satisfies formula:
{true|false}`` and exits 0 regardless, like the reference. Additions: --seed (the reference is unseeded and unreproducible),
--batch-per-chip/--clause-shards mesh controls, --dv-strategy,
--rigidity, --chunk-steps, --profile-dir, --checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from odesat_tpu.cnf import (
    evaluate_cnf,
    map_values_by_indices,
    bandwidth_reorder,
    normalize_cnf_variables,
    parse_dimacs_file,
    render_variable_map,
)
from odesat_tpu.preprocess import preprocess_formula, reconstruct_witness
from odesat_tpu.utils.config import ODEConfig, SolverConfig


def _add_common(p: argparse.ArgumentParser, batch_required: bool = False) -> None:
    p.add_argument("-f", "--input", required=True, help="input DIMACS CNF file")
    p.add_argument(
        "-o", "--output", default=None,
        help="optional output file (multi-host runs write it on the "
        "primary process only — point it at a shared filesystem, or "
        "collect it from the coordinator host)",
    )
    p.add_argument("--seed", type=int, default=None, help="PRNG seed (reproducible runs)")
    p.add_argument("--chunk-steps", type=int, default=256, help="scan steps per dispatch")
    p.add_argument("--rigidity", choices=["paper", "reference"], default="paper")
    p.add_argument(
        "--dv-strategy",
        choices=["auto", "fused", "gather", "segment_sum", "onehot"],
        default="auto",
        help="derivative accumulation: 'fused' is the GPU chunk kernel, the "
        "others the XLA scan path; 'auto' picks (ops/select.py)",
    )
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument(
        "--var-order",
        choices=["natural", "bandwidth"],
        default="natural",
        help="variable layout: 'bandwidth' relabels via reverse Cuthill-McKee "
        "so clauses touch nearby variables on instances without native "
        "index locality",
    )
    p.add_argument(
        "--matmul-dtype",
        choices=["float32", "bfloat16"],
        default="float32",
        help="fused-kernel dot operands (bfloat16 halves the plane bytes "
        "and doubles the kernel's formula envelope; solutions stay "
        "oracle-verified)",
    )
    p.add_argument("--devices", type=int, default=1, help="devices on the trajectory mesh axis")
    p.add_argument("--clause-shards", type=int, default=1, help="devices on the clause mesh axis")
    p.add_argument(
        "--pod-mesh",
        action="store_true",
        help="span the mesh over EVERY device in the (multi-host) job: the "
        "clause axis (--clause-shards) fills same-process devices first so "
        "its collectives stay inside one host, the trajectory axis takes "
        "the rest (--devices is ignored). Requires jax.distributed "
        "coordination — auto-detected under Slurm/MPI, or explicit via "
        "--coordinator",
    )
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address (multi-host)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --coordinator")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index for --coordinator")
    p.add_argument("--profile-dir", default=None, help="jax.profiler trace directory")
    p.add_argument("--checkpoint", default=None, help="state snapshot path (.npz)")
    p.add_argument("--checkpoint-every", type=int, default=0, help="chunks between snapshots")
    p.add_argument("--resume", default=None, help="resume a solve from a snapshot (.npz)")
    p.add_argument("--log-every", type=int, default=0, help="chunks between progress logs")
    p.add_argument("--wall-clock-budget", type=float, default=None, help="seconds budget")
    p.add_argument(
        "--no-preprocess",
        action="store_true",
        help="skip the resolution preprocessor in solve/stoch/hybrid "
        "(batch/inter never preprocess — reference parity, src/main.rs:269,341)",
    )


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="odesat_tpu", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def _add_dt_mode(p):
        p.add_argument(
            "--dt-mode",
            choices=["per-trajectory", "shared"],
            default="per-trajectory",
            help="adaptive-dt coupling across the batch: 'shared' adapts one "
            "dt from the batch-max error like the reference inter mode "
            "(src/system.rs:314); 'per-trajectory' is the default and the "
            "paper's intent",
        )

    solve = sub.add_parser("solve", help="Run a single simulation")
    _add_common(solve)
    solve.add_argument("-t", "--tolerance", type=float, default=None)
    solve.add_argument("-n", "--step-number", type=int, default=None)
    solve.add_argument("-s", "--step-size", type=float, default=None)
    solve.add_argument("-l", "--learning-rate", type=float, default=None)
    solve.add_argument("-r", "--ctv-ratio", type=float, default=None)
    solve.add_argument(
        "--solve-batch", type=int, default=8, metavar="B",
        help="race B random initializations and return the first verified "
        "winner (single solves are latency-bound: B=8 costs about the same "
        "wall time per step as B=1 and typically solves in fewer "
        "steps; pass 1 to restore the reference's single-trajectory solve)",
    )

    stoch = sub.add_parser("stoch", help="Run a stochastic search")
    _add_common(stoch)
    stoch.add_argument("-n", "--step-number", type=int, default=None)
    stoch.add_argument("-r", "--ctv-ratio", type=float, default=None)
    stoch.add_argument("-b", "--batch-size", type=int, default=1, help="parallel chains")

    batch = sub.add_parser("batch", help="Run a batch of simulations (parallel restarts)")
    _add_common(batch)
    batch.add_argument("-t", "--tolerance", type=float, default=None)
    batch.add_argument("-n", "--step-number", type=int, required=True)
    batch.add_argument("-s", "--step-size", type=float, default=None)
    batch.add_argument("-b", "--batch-size", type=int, required=True)
    batch.add_argument("-l", "--learning-rate", type=float, default=None)
    _add_dt_mode(batch)

    hybrid = sub.add_parser(
        "hybrid", help="Race the ODE and stochastic engines (portfolio)"
    )
    _add_common(hybrid)
    hybrid.add_argument("-t", "--tolerance", type=float, default=None)
    hybrid.add_argument("-n", "--step-number", type=int, default=None)
    hybrid.add_argument("-s", "--step-size", type=float, default=None)
    hybrid.add_argument("-b", "--batch-size", type=int, default=256)
    hybrid.add_argument("-l", "--learning-rate", type=float, default=None)
    hybrid.add_argument("-r", "--ctv-ratio", type=float, default=None)

    gen = sub.add_parser(
        "gen", help="Generate a random CNF instance (benchmark families)"
    )
    gen.add_argument("-o", "--output", required=True, help="output DIMACS file")
    gen.add_argument("-n", "--n-vars", type=int, required=True)
    gen.add_argument("-m", "--n-clauses", type=int, default=None,
                     help="default: round(4.26 * n)")
    gen.add_argument("-k", "--clause-width", type=int, default=3)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--planted", action="store_true",
                     help="plant a hidden satisfying assignment (guaranteed SAT)")
    gen.add_argument("--locality", type=int, default=None,
                     help="draw each clause's variables from a window this wide "
                     "(locally-structured instances; implies --planted)")

    inter = sub.add_parser("inter", help="Run a batch of interlaced simulations")
    _add_common(inter)
    inter.add_argument("-t", "--tolerance", type=float, default=None)
    inter.add_argument("-n", "--step-number", type=int, default=None)
    inter.add_argument("-s", "--step-size", type=float, default=None)
    inter.add_argument("-b", "--batch-size", type=int, required=True)
    inter.add_argument("-l", "--learning-rate", type=float, default=None)
    _add_dt_mode(inter)

    return parser


def _config_from_args(args, batch_size: int = 1) -> SolverConfig:
    tol = getattr(args, "tolerance", None)
    ratio = getattr(args, "ctv_ratio", None)
    ode = ODEConfig(
        # `is not None`, not truthiness: an explicit 0 must stick
        tolerance=tol if tol is not None else 1e-3,
        step_size=getattr(args, "step_size", None),
        steps=getattr(args, "step_number", None),
        zeta=getattr(args, "learning_rate", None),
        rigidity=args.rigidity,
        dtype=args.dtype,
        dv_strategy=args.dv_strategy,
        matmul_dtype=args.matmul_dtype,
        dt_mode=getattr(args, "dt_mode", "per-trajectory"),
    )
    return SolverConfig(
        ode=ode,
        ctv_ratio=ratio if ratio is not None else 7.0,
        preprocess=not getattr(args, "no_preprocess", False),
        batch_size=batch_size,
        seed=args.seed,
        chunk_steps=args.chunk_steps,
        checkpoint_path=args.checkpoint,
        checkpoint_every_chunks=args.checkpoint_every,
        resume_from=getattr(args, "resume", None),
        profile_dir=args.profile_dir,
        log_every_chunks=args.log_every,
        wall_clock_budget_s=args.wall_clock_budget,
    )


def _or_exit(fn, *args, **kwargs):
    """Run ``fn``; surface a library ValueError as a clean CLI error."""
    try:
        return fn(*args, **kwargs)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None


def _mesh_from_args(args):
    if getattr(args, "pod_mesh", False):
        # global mesh over the whole job (reference anchor: the CLI is
        # the reference's entire surface, src/main.rs:388 — the
        # rebuild's multi-host capability must be reachable from it)
        from odesat_tpu.parallel.multihost import make_pod_mesh

        return _or_exit(make_pod_mesh, args.clause_shards)
    if args.devices * args.clause_shards <= 1:
        return None
    from odesat_tpu.parallel.mesh import make_mesh

    return _or_exit(make_mesh, args.devices, args.clause_shards)


def _finish(mapped_values: dict, formula, output) -> None:
    """Shared tail: verify against the ORIGINAL formula, render, write
    (reference: src/main.rs:189-201)."""
    print("Evaluating CNF formula...")
    is_satisfiable = evaluate_cnf(mapped_values, formula)
    print(f"Checking if solution vector satisfies formula: {str(is_satisfiable).lower()}")

    print("Rendering variable assignments...")
    render_str = render_variable_map(mapped_values)
    if output:
        print("Writing results to file...")
        from odesat_tpu.parallel.dist import is_primary

        if is_primary():  # one writer per shared filesystem on a pod
            with open(output, "w", encoding="utf-8") as fh:
                fh.write(render_str)
    else:
        print(f"Variable assignments:\n{render_str}")


def _load(args):
    print("Reading CNF formula from file...")
    if not os.path.exists(args.input):
        print(f"error: input file not found: {args.input}", file=sys.stderr)
        raise SystemExit(2)
    print("Parsing CNF formula...")
    try:
        from odesat_tpu import native

        native_ok = native.is_available()
    except ImportError:
        native_ok = False
    if native_ok:
        try:
            with open(args.input, "r", encoding="utf-8") as fh:
                return native.parse_dimacs_native(fh.read())
        except ValueError as e:
            # a genuine parse error must surface, not silently retry on
            # the Python parser (the two are fuzz-parity-tested; hiding
            # a native failure here would mask a real scanner bug)
            print(f"error: malformed DIMACS in {args.input}: {e}", file=sys.stderr)
            raise SystemExit(2) from None
        except (OSError, RuntimeError, UnicodeDecodeError):
            pass  # IO/library trouble: the Python parser reads the file itself
    try:
        return parse_dimacs_file(args.input)
    except ValueError as e:
        print(f"error: malformed DIMACS in {args.input}: {e}", file=sys.stderr)
        raise SystemExit(2) from None


def _maybe_preprocess(formula, config):
    """Preprocess unless disabled (SolverConfig.preprocess; batch/inter
    never call this — reference parity, src/main.rs:269,341)."""
    if not config.preprocess:
        from odesat_tpu.preprocess.trace import SimplificationTrace

        return formula, SimplificationTrace()
    print("Preprocessing CNF formula...")
    reduced, trace = preprocess_formula(formula, config.ctv_ratio)
    print(f"Clauses: {reduced.num_clauses} | Vars: {reduced.varnum}")
    return reduced, trace


def cmd_solve(args) -> int:
    formula = _load(args)
    # race a micro-batch of random inits (reference solve draws ONE
    # random init, src/system.rs:171 — racing B inits and returning the
    # first winner preserves that contract; a single solve is
    # dispatch-latency-bound, so the extra trajectories are ~free)
    config = _config_from_args(args, batch_size=max(1, args.solve_batch))

    reduced, trace = _maybe_preprocess(formula, config)
    var_mapping, normalized = normalize_cnf_variables(reduced)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)

    print("Simulating...")
    from odesat_tpu.models.ode import simulate_batch

    mesh = _mesh_from_args(args)
    if mesh is not None:
        import dataclasses

        # the micro-batch must split evenly over the trajectory axis
        nt = mesh.shape.get("traj", 1)
        config = dataclasses.replace(
            config, batch_size=-(-config.batch_size // nt) * nt
        )
    result = _or_exit(simulate_batch, normalized, config, mesh=mesh)

    print("Mapping values...")
    mapped_values = map_values_by_indices(var_mapping, result.best_assignment())
    reconstruct_witness(mapped_values, trace)

    _finish(mapped_values, formula, args.output)
    return 0


def cmd_stoch(args) -> int:
    formula = _load(args)
    config = _config_from_args(args, batch_size=args.batch_size)

    reduced, trace = _maybe_preprocess(formula, config)
    var_mapping, normalized = normalize_cnf_variables(reduced)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)

    print("Simulating...")
    from odesat_tpu.models.stoch import search

    result = _or_exit(search, normalized, config, mesh=_mesh_from_args(args))

    print("Mapping values...")
    mapped_values = map_values_by_indices(var_mapping, result.best_assignment())
    reconstruct_witness(mapped_values, trace)

    _finish(mapped_values, formula, args.output)
    return 0


def cmd_batch(args) -> int:
    formula = _load(args)
    config = _config_from_args(args, batch_size=args.batch_size)

    print("Normalizing CNF formula...")
    var_mapping, normalized = normalize_cnf_variables(formula)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)

    print("Simulating...")
    from odesat_tpu.cnf.arrays import compile_formula
    from odesat_tpu.models.ode import simulate_batch

    mesh = _mesh_from_args(args)
    if mesh is not None:
        # mesh-aware compile: the clause axis must divide across the
        # clause devices
        from odesat_tpu.parallel.sharded import compile_for_mesh

        fa = _or_exit(compile_for_mesh, normalized, config, mesh)
    else:
        fa = compile_formula(
            normalized, clause_pad=config.clause_pad, var_pad=config.var_pad
        )
    verified_holder = {}
    progress = {"chunks": 0}

    def harvest(state, done) -> bool:
        # oracle-verified early exit: the reference gates batch termination
        # on the verifier, not the allsat flag (src/main.rs:302-307);
        # ``done`` arrives already host-pulled by the solve loop
        # \r-style progress like the reference's per-trial line
        # (src/main.rs:279); trials run in parallel here, so the line
        # reports converged trajectories instead of a serial trial index
        progress["chunks"] += 1
        print(
            f"\rRunning batch: {int(done.sum())}/{done.size} trajectories converged",
            end="",
            flush=True,
        )
        converged = np.flatnonzero(done)
        if converged.size:
            from odesat_tpu.parallel.dist import fetch

            # one pull for all candidate rows (a collective on a pod —
            # every process sees the same done flags, so all reach it)
            v_host = fetch(state.v[:, : fa.n_vars] > 0.0)
            for idx in converged:
                mapped = map_values_by_indices(var_mapping, v_host[idx])
                if evaluate_cnf(mapped, formula):
                    verified_holder["mapped"] = mapped
                    return True
        return False

    result = _or_exit(
        simulate_batch, fa, config, stop_on="all", harvest=harvest, mesh=mesh
    )
    if progress["chunks"]:
        print()  # terminate the \r progress line

    if "mapped" not in verified_holder:
        # budget exhausted: check every readout like the reference checks
        # every trial (verified or not, the last mapping is kept)
        mapped = {}
        for idx in range(result.assignment.shape[0]):
            mapped = map_values_by_indices(var_mapping, result.assignment[idx])
            if evaluate_cnf(dict(mapped), formula):
                verified_holder["mapped"] = mapped
                break
        mapped_values = verified_holder.get("mapped", mapped)
    else:
        mapped_values = verified_holder["mapped"]

    _finish(mapped_values, formula, args.output)
    return 0


def cmd_inter(args) -> int:
    formula = _load(args)
    config = _config_from_args(args, batch_size=args.batch_size)

    print("Normalizing CNF formula...")
    var_mapping, normalized = normalize_cnf_variables(formula)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)

    print("Simulating...")
    from odesat_tpu.models.ode import simulate_batch

    result = _or_exit(
        simulate_batch, normalized, config, stop_on="any", mesh=_mesh_from_args(args)
    )

    mapped_values = map_values_by_indices(var_mapping, result.best_assignment())
    _finish(mapped_values, formula, args.output)
    return 0


def cmd_hybrid(args) -> int:
    """solve-style pipeline with both engines racing (no reference
    counterpart; preprocessing + witness reconstruction as in solve).
    Checkpoints hold BOTH engine states (utils/checkpoint
    save_hybrid_state), so --checkpoint/--resume work like the other
    modes."""
    formula = _load(args)
    config = _config_from_args(args, batch_size=args.batch_size)

    reduced, trace = _maybe_preprocess(formula, config)
    var_mapping, normalized = normalize_cnf_variables(reduced)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)

    from odesat_tpu.models.hybrid import hybrid_search

    print("Racing ODE and stochastic engines...")
    result = _or_exit(hybrid_search, normalized, config, mesh=_mesh_from_args(args))
    print(f"Winner: {result.engine} after {result.steps} steps per engine "
          f"({result.wall_time_s:.2f}s)")
    mapped_values = map_values_by_indices(var_mapping, result.assignment)
    reconstruct_witness(mapped_values, trace)
    _finish(mapped_values, formula, args.output)
    return 0


def cmd_gen(args) -> int:
    from odesat_tpu.cnf import cnf_to_dimacs
    from odesat_tpu.utils.generate import random_ksat, random_local_ksat

    m = args.n_clauses if args.n_clauses is not None else int(round(4.26 * args.n_vars))
    # a narrow --locality surfaces as the generator's ValueError — one
    # source of truth for the constraint
    if args.locality is not None:
        formula = _or_exit(
            random_local_ksat, args.n_vars, m, k=args.clause_width,
            locality=args.locality, seed=args.seed, planted=True,
        )
    else:
        formula = _or_exit(
            random_ksat, args.n_vars, m, k=args.clause_width, seed=args.seed,
            planted=args.planted,
        )
    with open(args.output, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(formula))
    print(f"wrote {args.output}: {formula.varnum} vars, {formula.num_clauses} clauses")
    return 0


def main(argv=None) -> int:
    from odesat_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # persist compiled kernels across runs
    args = _build_parser().parse_args(argv)
    if args.cmd != "gen":
        # must run before the first JAX computation; a safe no-op when
        # single-process with no cluster environment, and the thing that
        # makes --pod-mesh (and cluster auto-detection) work at all
        from odesat_tpu.parallel.multihost import initialize_distributed

        _or_exit(
            initialize_distributed,
            coordinator_address=getattr(args, "coordinator", None),
            num_processes=getattr(args, "num_processes", None),
            process_id=getattr(args, "process_id", None),
        )
    handlers = {
        "solve": cmd_solve,
        "stoch": cmd_stoch,
        "batch": cmd_batch,
        "inter": cmd_inter,
        "hybrid": cmd_hybrid,
        "gen": cmd_gen,
    }
    return handlers[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
