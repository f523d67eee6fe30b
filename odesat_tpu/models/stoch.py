"""Stochastic discrete engine: clause-weighted randomized local search.

Batched rebuild of the reference's second solver (reference:
src/stoch.rs:1-110). Per step:

* every clause is evaluated against the boolean assignment
  (src/stoch.rs:20-25);
* clause weights update: satisfied -> max(xl-1, 1), unsatisfied ->
  xl + 20 (src/stoch.rs:47-51, ALPHA=20);
* every variable accumulates ``total = sum xl`` over clauses containing
  it and ``unsat = sum xl`` over *unsatisfied* clauses containing it,
  using the **post-update** weights (src/stoch.rs:53-59);
* each variable flips with probability ``unsat/total``
  (src/stoch.rs:67-75 draws an integer in [1, total] and flips when
  <= unsat — identical in distribution to a uniform float < unsat/total).

Design departures, all deliberate:

* the clause walk becomes masked array ops over the same padded (K, M)
  incidence arrays as the ODE engine, and the per-variable weight sums
  are the same variable-major gather+sum — no scatters;
* trajectories are a vmapped batch with explicit PRNG keys (the reference
  uses an unseeded thread_rng, so no reference run is reproducible —
  SURVEY.md §5 calls for seedability);
* clause weights are int32 clamped to [1, 2**24] instead of saturating
  u64: weights beyond 16.7M are indistinguishable for the flip
  probabilities, and int32 keeps the device on its native integer path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from odesat_tpu.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu.constants import STOCH_ALPHA
from odesat_tpu.utils.config import SolverConfig

XL_CAP = 2**24


class StochState(NamedTuple):
    v: jax.Array  # (B, Np) bool assignment
    xl: jax.Array  # (B, Mp) int32 clause weights
    done: jax.Array  # (B,) bool
    key: jax.Array  # PRNG key


@dataclass
class StochResult:
    assignment: np.ndarray  # (B, n_vars) bool
    done: np.ndarray  # (B,)
    steps: int
    solved_index: Optional[int]
    wall_time_s: float = 0.0

    def best_assignment(self) -> np.ndarray:
        idx = self.solved_index if self.solved_index is not None else 0
        return self.assignment[idx]


def init_stoch_state(fa: FormulaArrays, batch_size: int, key: jax.Array) -> StochState:
    """All-false start, unit weights (reference: src/stoch.rs:84-87)."""
    v = jnp.zeros((batch_size, fa.n_vars_padded), dtype=jnp.bool_)
    xl = jnp.ones((batch_size, fa.n_clauses_padded), dtype=jnp.int32)
    done = jnp.zeros((batch_size,), dtype=jnp.bool_)
    return StochState(v, xl, done, key)


def make_stoch_step(fa: FormulaArrays):
    from odesat_tpu.cnf.arrays import slot_clause_map

    lit_var = jnp.asarray(fa.lit_var)  # (K, M)
    pos = jnp.asarray(fa.sign > 0)
    lit_mask = jnp.asarray(fa.lit_mask > 0)
    clause_mask = jnp.asarray(fa.clause_mask > 0)  # (M,)
    # var_occ indexes the bucket-major flat slot layout (cnf/arrays.py);
    # compose with the slot->clause map so the weight gather is correct
    # for bucketed and clause-shard-plan layouts too, not just the
    # single-bucket layout where slot == k*M + m
    occ_clause = jnp.asarray(slot_clause_map(fa)[fa.var_occ])  # (N, D)
    occ_mask = jnp.asarray(fa.occ_mask > 0)
    has_occ = jnp.asarray(fa.occ_mask.sum(axis=-1) > 0)  # vars with any clause
    K, M = fa.lit_var.shape

    def step(state: StochState) -> StochState:
        key, sub = jax.random.split(state.key)

        lit_true = state.v[:, lit_var] == pos  # (B, K, M)
        sat = jnp.any(lit_true & lit_mask, axis=-2)  # (B, M)

        # weight update (post-update weights feed the flip probabilities)
        xl = jnp.where(
            sat,
            jnp.maximum(state.xl - 1, 1),
            jnp.minimum(state.xl + STOCH_ALPHA, XL_CAP),
        )
        xl = jnp.where(clause_mask, xl, 0)

        # per-variable weight sums via variable-major gather
        xl_f = xl.astype(jnp.float32)
        unsat_f = (xl_f * (~sat)).astype(jnp.float32)
        total = jnp.sum(xl_f[:, occ_clause] * occ_mask, axis=-1)  # (B, N)
        unsat_w = jnp.sum(unsat_f[:, occ_clause] * occ_mask, axis=-1)

        u = jax.random.uniform(sub, total.shape, dtype=jnp.float32)
        flip = (u * total < unsat_w) & has_occ

        active = ~state.done
        all_sat = jnp.all(sat | ~clause_mask, axis=-1)
        v = jnp.where(active[:, None] & flip, ~state.v, state.v)
        xl = jnp.where(active[:, None], xl, state.xl)
        done = state.done | all_sat
        return StochState(v, xl, done, key)

    return step


def make_stoch_clause_step(clause_axis: str):
    """Clause-sharded stoch step ``step(state, dev) -> state``: runs
    inside shard_map with the incidence arrays (a FormulaDevice) and
    ``xl`` sharded over ``clause_axis``. The per-variable weight sums
    (reference: src/stoch.rs:53-59) are local segment-sums over this
    shard's clauses, psum-reduced over the axis — the same collective
    plumbing as the ODE engine's dv — and the all-sat flag is an
    AND-reduce. The PRNG key is replicated over the clause axis, so
    every shard draws identical flips and v stays consistent.

    The weight sums are integer-valued (int32 weights in [1, 2**24])
    accumulated in f32, so shard-local summation order cannot perturb
    the flip comparisons until a variable's total weight exceeds 2**24
    — the same exactness envelope as the single-device gather path.
    """

    def step(state: StochState, dev) -> StochState:
        key, sub = jax.random.split(state.key)
        lit_var = dev.lit_var  # (K, M_local)
        pos = dev.sign > 0
        lit_mask = dev.lit_mask > 0
        clause_mask = dev.clause_mask > 0
        B, Np = state.v.shape
        K, M = lit_var.shape

        lit_true = state.v[:, lit_var] == pos  # (B, K, M)
        sat = jnp.any(lit_true & lit_mask, axis=-2)  # (B, M)

        xl = jnp.where(
            sat,
            jnp.maximum(state.xl - 1, 1),
            jnp.minimum(state.xl + STOCH_ALPHA, XL_CAP),
        )
        xl = jnp.where(clause_mask, xl, 0)

        xl_f = xl.astype(jnp.float32)
        w_lit = jnp.broadcast_to(xl_f[:, None, :], (B, K, M)) * lit_mask
        u_lit = jnp.broadcast_to(
            (xl_f * (~sat))[:, None, :], (B, K, M)
        ) * lit_mask
        ids = lit_var.reshape(-1)
        total = jax.ops.segment_sum(
            w_lit.reshape(B, K * M).swapaxes(0, 1), ids, num_segments=Np
        ).swapaxes(0, 1)
        unsat_w = jax.ops.segment_sum(
            u_lit.reshape(B, K * M).swapaxes(0, 1), ids, num_segments=Np
        ).swapaxes(0, 1)
        total = jax.lax.psum(total, clause_axis)
        unsat_w = jax.lax.psum(unsat_w, clause_axis)

        u = jax.random.uniform(sub, (B, Np), dtype=jnp.float32)
        # total == 0 for variables in no (real) clause: 0 < 0 never flips
        flip = u * total < unsat_w

        local_all = jnp.all(sat | ~clause_mask, axis=-1)
        all_sat = jax.lax.psum((~local_all).astype(jnp.int32), clause_axis) == 0

        active = ~state.done
        v = jnp.where(active[:, None] & flip, ~state.v, state.v)
        xl = jnp.where(active[:, None], xl, state.xl)
        done = state.done | all_sat
        return StochState(v, xl, done, key)

    return step


def make_stoch_chunk_runner(fa: FormulaArrays, chunk_steps: int, donate: bool = True):
    """Jitted ``state -> state`` running ``chunk_steps`` steps as a
    ``lax.scan`` with ``jax.random`` flips. ``donate=False`` when the
    runner is re-wrapped (e.g. under shard_map, where the wrapper owns
    donation)."""
    step = make_stoch_step(fa)

    def run_chunk(state: StochState) -> StochState:
        def body(carry, _):
            return step(carry), None

        out, _ = jax.lax.scan(body, state, None, length=chunk_steps)
        return out

    return jax.jit(run_chunk, donate_argnums=0 if donate else ())


def search(
    formula_or_arrays,
    config: Optional[SolverConfig] = None,
    key: Optional[jax.Array] = None,
    mesh=None,
) -> StochResult:
    """Batched stochastic search (reference: src/stoch.rs:80-110 runs one
    chain; here ``config.batch_size`` chains run vmapped with early exit
    when any chain satisfies every clause).

    Honors the same ops plumbing as the ODE loop (models/ode.py
    simulate_batch): step and wall-clock budgets, ``resume_from`` /
    ``checkpoint_path`` + ``checkpoint_every_chunks`` StochState
    snapshots, ``log_every_chunks`` progress metrics, ``profile_dir``.

    ``mesh``: a ('traj', 'clause') jax Mesh. The trajectory axis shards
    the chain batch as pure data parallelism, one PRNG key per traj
    device (parallel/sharded.make_sharded_stoch_runner); a non-trivial
    clause axis shards the incidence/weight arrays for CNFs too big for
    one device, with the per-variable weight sums psum-reduced over it.
    The sharded PRNG stream differs from the single-device stream for
    the same seed (per-device key splits); runs are reproducible per
    (seed, mesh traj width)."""
    config = config or SolverConfig()
    n_clause = mesh.shape.get("clause", 1) if mesh is not None else 1
    if isinstance(formula_or_arrays, FormulaArrays):
        fa = formula_or_arrays
    elif n_clause > 1:
        # mesh-aware compile: the clause axis divides across the mesh
        from odesat_tpu.parallel.sharded import compile_for_mesh

        fa = compile_for_mesh(formula_or_arrays, config, mesh)
    else:
        # only reachable at n_clause == 1 (clause meshes compile above)
        fa = compile_formula(
            formula_or_arrays,
            clause_pad=config.clause_pad,
            var_pad=config.var_pad,
        )
    if key is None:
        seed = config.seed if config.seed is not None else int.from_bytes(__import__("os").urandom(4), "little")
        key = jax.random.PRNGKey(seed)

    if mesh is not None:
        from odesat_tpu.parallel.sharded import (
            make_sharded_stoch_runner,
            shard_stoch_inputs,
        )

        n_traj = mesh.shape.get("traj", 1)
        if n_clause > 1 and fa.n_clauses_padded % n_clause:
            raise ValueError(
                f"the padded clause axis ({fa.n_clauses_padded}) does not "
                f"divide across {n_clause} clause devices; recompile with a "
                "mesh-compatible clause_pad"
            )
        if config.batch_size % n_traj:
            raise ValueError(
                f"batch_size={config.batch_size} does not divide across "
                f"{n_traj} trajectory devices"
            )


        def make_runner(n):
            return make_sharded_stoch_runner(fa, n, mesh)

    else:
        # host-paced chunks (models/loop.py drive_chunks escalates their
        # length on long runs)
        def make_runner(n):
            return make_stoch_chunk_runner(fa, n)

    steps_resumed = 0
    if config.resume_from:
        from odesat_tpu.utils.checkpoint import load_state, validate_mesh_layout

        loaded, steps_resumed, saved_layout = load_state(
            config.resume_from, StochState
        )
        # full-layout check (traj AND clause axes — the clause axis
        # changes the compiled clause order); the key-shape checks below
        # remain for pre-layout snapshots
        validate_mesh_layout(saved_layout, mesh, what="stoch snapshot")
        state = jax.tree.map(jnp.asarray, loaded)
        if mesh is not None and (
            state.key.ndim != 2 or state.key.shape[0] != mesh.shape["traj"]
        ):
            raise ValueError(
                "cannot resume this stoch snapshot on a "
                f"{mesh.shape.get('traj', 1)}-device mesh: the snapshot holds "
                f"{state.key.shape[0] if state.key.ndim == 2 else 1} per-device "
                "PRNG key(s); resume with the same --devices count"
            )
        if mesh is None and state.key.ndim == 2:
            raise ValueError(
                "this stoch snapshot was taken on a mesh (per-device key "
                "layout); resume with the same --devices count"
            )
    else:
        state = init_stoch_state(fa, config.batch_size, key)
        if mesh is not None:
            state = StochState(
                state.v,
                state.xl,
                state.done,
                jax.random.split(key, mesh.shape["traj"]),
            )
    if mesh is not None:
        state = shard_stoch_inputs(state, mesh)

    from odesat_tpu.models.loop import drive_chunks
    from odesat_tpu.utils.checkpoint import mesh_layout_of

    state, steps_run, wall_time = drive_chunks(
        state,
        make_runner,
        config,
        budget=config.ode.steps,
        should_stop=lambda st, done: bool(done.any()),
        steps_resumed=steps_resumed,
        mesh_layout=mesh_layout_of(mesh),
    )

    from odesat_tpu.parallel.dist import fetch

    done = fetch(state.done)
    solved = np.flatnonzero(done)
    return StochResult(
        assignment=fetch(state.v[:, : fa.n_vars]),
        done=done,
        steps=steps_run,
        solved_index=int(solved[0]) if solved.size else None,
        wall_time_s=wall_time,
    )
