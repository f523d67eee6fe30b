"""Hybrid portfolio: race the ODE and stochastic engines on one formula.

No reference counterpart — the reference picks one engine per run
(`solve`/`inter` vs `stoch`). The two engines have complementary
strengths (the ODE excels on dense preprocessed instances, the
clause-weighted local search on others), and both are chunked device
dispatches, so interleaving them costs nothing but the dispatch
slots: run an ODE chunk, then a stoch chunk, stop as soon as either
batch satisfies every clause. Each engine keeps its own batch and PRNG
stream; the step budget applies to each engine independently.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import jax
import numpy as np

from odesat_tpu.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu.models.ode import (
    formula_device,
    init_state,
    make_chunk_runner,
    _readout,
)
from odesat_tpu.models.stoch import init_stoch_state, make_stoch_chunk_runner
from odesat_tpu.utils.config import SolverConfig


@dataclass
class HybridResult:
    engine: str  # "ode" | "stoch" | "none"
    assignment: np.ndarray  # (n_vars,) bool — winner's first satisfied row
    solved: bool
    steps: int  # steps run per engine
    wall_time_s: float = 0.0


def hybrid_search(
    formula_or_arrays,
    config: Optional[SolverConfig] = None,
    key: Optional[jax.Array] = None,
    mesh=None,
) -> HybridResult:
    """Interleave ODE and stochastic chunks until either engine's batch
    reaches allsat, the per-engine step budget runs out, or the
    wall-clock budget expires.

    ``mesh``: a ('traj', 'clause') mesh shards both engines' batches
    over the trajectory axis; a non-trivial clause axis shards the
    incidence arrays of both engines (the ODE's psum'd dv and the stoch
    engine's psum'd weight sums).

    Ops parity with the single-engine loops: ``checkpoint_path`` +
    ``checkpoint_every_chunks`` snapshot BOTH engine states into one
    file, ``resume_from`` restores them — mesh snapshots resume on a
    mesh with the same trajectory device count (the per-device stoch
    key layout is validated like models/stoch.py), ``log_every_chunks``
    logs both engines."""
    config = config or SolverConfig()
    if isinstance(formula_or_arrays, FormulaArrays):
        fa = formula_or_arrays
    elif mesh is not None:
        # mesh-aware compile: clause-axis padding that divides across
        # the clause devices; both engines run the same layout
        from odesat_tpu.parallel.sharded import compile_for_mesh

        fa = compile_for_mesh(formula_or_arrays, config, mesh)
    else:
        fa = compile_formula(
            formula_or_arrays,
            clause_pad=config.clause_pad,
            var_pad=config.var_pad,
        )
    ode = config.ode
    zeta = ode.resolve_zeta(fa.density)
    if key is None:
        seed = (
            config.seed
            if config.seed is not None
            else int.from_bytes(__import__("os").urandom(4), "little")
        )
        key = jax.random.PRNGKey(seed)
    k_ode, k_stoch = jax.random.split(key)

    chunk = config.chunk_steps
    dev = formula_device(fa)
    steps_resumed = 0
    resumed = False
    if config.resume_from:
        import jax.numpy as jnp

        from odesat_tpu.models.stoch import StochState
        from odesat_tpu.utils.checkpoint import (
            load_hybrid_state,
            validate_mesh_layout,
        )

        from odesat_tpu.models.ode import ODEState

        ode_loaded, stoch_loaded, steps_resumed, saved_layout = load_hybrid_state(
            config.resume_from, ODEState, StochState
        )
        # full-layout check first (traj AND clause axes — the clause axis
        # changes the compiled clause order for BOTH engines); the
        # key-shape checks below remain for pre-layout snapshots
        validate_mesh_layout(saved_layout, mesh, what="hybrid snapshot")
        # mesh snapshots carry the per-device stoch key layout — resume
        # needs the same trajectory device count (same validation as the
        # plain stoch engine, models/stoch.py)
        if mesh is not None:
            n_traj = mesh.shape.get("traj", 1)
            if stoch_loaded.key.ndim != 2 or stoch_loaded.key.shape[0] != n_traj:
                raise ValueError(
                    f"cannot resume this hybrid snapshot on a {n_traj}-device "
                    "mesh: it holds "
                    f"{stoch_loaded.key.shape[0] if stoch_loaded.key.ndim == 2 else 1}"
                    " per-device stoch PRNG key(s); resume with the same "
                    "--devices count"
                )
        elif stoch_loaded.key.ndim != 1:
            raise ValueError(
                "this hybrid snapshot was taken on a mesh (per-device stoch "
                "key layout); resume with the same --devices count"
            )
        ode_state = jax.tree.map(jnp.asarray, ode_loaded)
        stoch_state = jax.tree.map(jnp.asarray, stoch_loaded)
        resumed = True
    else:
        ode_state = init_state(fa, config.batch_size, k_ode, ode)
        stoch_state = init_stoch_state(fa, config.batch_size, k_stoch)
    def _make_runners(n):
        """(ode_runner, stoch_runner) advancing every trajectory n steps
        — one builder for the steady-state AND tail runners so their
        argument lists can never diverge."""
        if mesh is not None:
            from odesat_tpu.parallel.sharded import (
                make_sharded_chunk_runner,
                make_sharded_stoch_runner,
            )

            return (
                make_sharded_chunk_runner(fa, zeta, ode, n, mesh),
                make_sharded_stoch_runner(fa, n, mesh),
            )
        return make_chunk_runner(fa, zeta, ode, n), make_stoch_chunk_runner(fa, n)

    if mesh is not None:
        from odesat_tpu.models.stoch import StochState
        from odesat_tpu.parallel.sharded import shard_inputs, shard_stoch_inputs

        n_traj = mesh.shape["traj"]
        n_clause = mesh.shape.get("clause", 1)
        if config.batch_size % n_traj:
            raise ValueError(
                f"batch_size={config.batch_size} does not divide across "
                f"{n_traj} trajectory devices"
            )
        if n_clause > 1 and fa.n_clauses_padded % n_clause:
            # same pre-check as models/stoch.py: a caller-supplied plain
            # FormulaArrays would otherwise die in a cryptic jax sharding
            # error inside shard_map (compile_for_mesh-built layouts
            # always divide)
            raise ValueError(
                f"the padded clause axis ({fa.n_clauses_padded}) does not "
                f"divide across {n_clause} clause devices; recompile with a "
                "mesh-aware layout (parallel.sharded.compile_for_mesh)"
            )
        ode_state, dev = shard_inputs(ode_state, dev, mesh)
        if not resumed:
            # fresh runs get one PRNG key per device; resumed snapshots
            # already carry the per-device key layout
            stoch_state = StochState(
                stoch_state.v,
                stoch_state.xl,
                stoch_state.done,
                jax.random.split(k_stoch, n_traj),
            )
        stoch_state = shard_stoch_inputs(stoch_state, mesh)
    ode_runner, stoch_runner = _make_runners(chunk)

    # tail runners keep the step budget exact (a 100-step budget with
    # chunk 16 runs 100 steps, not 112 — same clamp as drive_chunks)
    tail_runners = None

    budget = ode.steps
    steps = steps_resumed
    chunks = 0
    t0 = time.perf_counter()
    profiling = False
    if config.profile_dir:
        jax.profiler.start_trace(config.profile_dir)
        profiling = True
    try:
        while budget is None or steps < budget:
            remaining = None if budget is None else budget - steps
            if remaining is not None and remaining < chunk:
                if tail_runners is None:
                    tail_runners = _make_runners(remaining)
                ode_state = tail_runners[0](ode_state, dev)
                stoch_state = tail_runners[1](stoch_state)
                steps += remaining
            else:
                ode_state = ode_runner(ode_state, dev)
                stoch_state = stoch_runner(stoch_state)
                steps += chunk
            chunks += 1
            if config.log_every_chunks and chunks % config.log_every_chunks == 0:
                from odesat_tpu.utils.logging import log_chunk

                log_chunk(ode_state, steps)
                log_chunk(stoch_state, steps)
            if (
                config.checkpoint_every_chunks
                and config.checkpoint_path
                and chunks % config.checkpoint_every_chunks == 0
            ):
                from odesat_tpu.utils.checkpoint import (
                    mesh_layout_of,
                    save_hybrid_state,
                )

                save_hybrid_state(
                    config.checkpoint_path, ode_state, stoch_state, steps,
                    mesh_layout=mesh_layout_of(mesh),
                )
            from odesat_tpu.parallel.dist import fetch

            ode_done = fetch(ode_state.done)
            if ode_done.any():
                idx = int(np.flatnonzero(ode_done)[0])
                return HybridResult(
                    engine="ode",
                    assignment=_readout(ode_state, fa.n_vars)[idx],
                    solved=True,
                    steps=steps,
                    wall_time_s=time.perf_counter() - t0,
                )
            stoch_done = fetch(stoch_state.done)
            if stoch_done.any():
                idx = int(np.flatnonzero(stoch_done)[0])
                return HybridResult(
                    engine="stoch",
                    assignment=fetch(stoch_state.v)[idx, : fa.n_vars],
                    solved=True,
                    steps=steps,
                    wall_time_s=time.perf_counter() - t0,
                )
            if (
                config.wall_clock_budget_s is not None
                and time.perf_counter() - t0 > config.wall_clock_budget_s
            ):
                break
    finally:
        if profiling:
            jax.profiler.stop_trace()
    return HybridResult(
        engine="none",
        assignment=_readout(ode_state, fa.n_vars)[0],
        solved=False,
        steps=steps,
        wall_time_s=time.perf_counter() - t0,
    )
