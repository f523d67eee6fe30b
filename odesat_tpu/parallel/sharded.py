"""Mesh-sharded solve paths.

Two axes of parallelism (SURVEY.md §2b — the reference has neither):

* ``traj``: the trajectory batch shards over devices as pure data
  parallelism. No communication inside the step; the only cross-device
  traffic is the host's between-chunk pull of the (B,) done flags.
* ``clause``: for CNFs whose incidence arrays dwarf one chip, the padded
  clause axis shards over devices. Inside shard_map each device computes
  its clauses' contributions; per-variable dv segments are psum-reduced
  (XLA hands the collective to NCCL on GPUs), the allsat flag is an
  AND-reduce, and the adaptive error norm a pmax (see make_step_fn's
  clause_axis handling in models/ode.py).

Validated without hardware via
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` (SURVEY.md §4).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from odesat_tpu.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu.models.ode import FormulaDevice, ODEState, make_step_fn
from odesat_tpu.utils.config import ODEConfig, SolverConfig

STATE_SPECS = ODEState(
    v=P("traj"),  # replicated over 'clause'
    xs=P("traj", "clause"),
    xl=P("traj", "clause"),
    dt=P("traj"),
    done=P("traj"),
)

DEV_SPECS = FormulaDevice(
    lit_var=P(None, "clause"),
    sign=P(None, "clause"),
    lit_mask=P(None, "clause"),
    clause_mask=P("clause"),
    var_occ=P(),  # only used unsharded; replicated
    occ_mask=P(),
)


def compile_for_mesh(formula, config: SolverConfig, mesh: Mesh) -> FormulaArrays:
    """Compile with padding compatible with the mesh: the clause axis must
    divide evenly across the 'clause' dimension."""
    clause_pad = config.clause_pad * mesh.shape.get("clause", 1)
    return compile_formula(formula, clause_pad=clause_pad, var_pad=config.var_pad)


def shard_inputs(state: ODEState, dev: FormulaDevice, mesh: Mesh):
    """Lay out the state and incidence arrays on the mesh (multi-host
    aware: each process contributes its local shards)."""
    from odesat_tpu.parallel.dist import put_global

    state = shard_state(state, mesh)
    dev = jax.tree.map(
        lambda x, spec: put_global(x, NamedSharding(mesh, spec)), dev, DEV_SPECS
    )
    return state, dev


def shard_state(state: ODEState, mesh: Mesh) -> ODEState:
    from odesat_tpu.parallel.dist import put_global

    return jax.tree.map(
        lambda x, spec: put_global(x, NamedSharding(mesh, spec)), state, STATE_SPECS
    )


# Sharded programs shared across same-shaped instances (planes as jit
# args, chunk bound traced — the mesh twins of models/ode.py's
# _MULTI_CORE_CACHE)
_SHARDED_PROGRAM_CACHE: dict = {}


def _mesh_key(mesh: Mesh):
    return (
        tuple(mesh.shape.items()),
        tuple(d.id for d in mesh.devices.flat),
    )


def _cache_program(pkey, build):
    jitted = _SHARDED_PROGRAM_CACHE.get(pkey)
    if jitted is None:
        jitted = build()
        if len(_SHARDED_PROGRAM_CACHE) >= 128:  # shape-diverse sweep backstop
            _SHARDED_PROGRAM_CACHE.clear()
        _SHARDED_PROGRAM_CACHE[pkey] = jitted
    return jitted


def sharded_multi_supported(fa: FormulaArrays, ode: ODEConfig, mesh: Mesh) -> bool:
    """Build-free eligibility check for make_sharded_multi_runner: the
    device loop on a mesh needs the fused kernel's shape-shared core."""
    from odesat_tpu.ops.select import gpu_available, kernel_eligible

    return (
        mesh.shape.get("clause", 1) == 1
        and ode.dv_strategy in ("auto", "fused")
        and gpu_available()
        and kernel_eligible(fa, ode)
    )


def make_sharded_multi_runner(
    fa: FormulaArrays,
    zeta: float,
    ode: ODEConfig,
    chunk_steps: int,
    max_chunks: int,
    mesh: Mesh,
    stop_on: str = "any",
):
    """Mesh twin of models/ode.make_multi_chunk_runner for trajectory-only
    (pure DP) meshes: one dispatch runs up to ``max_chunks`` chunks of the
    fused kernel per device inside a ``lax.while_loop``, with the stop
    flag reduced over the ``traj`` axis every chunk (a tiny pmax/pmin)
    so every device exits after the SAME chunk — ``steps_advanced`` is
    uniform and exact. Returns ``state -> (state, steps_advanced)`` or
    None when the config runs the scan path."""
    import jax.numpy as jnp

    if not sharded_multi_supported(fa, ode, mesh):
        return None
    from odesat_tpu.ops.fused_pallas import make_fused_chunk

    kernel = make_fused_chunk(fa, zeta, ode, chunk_steps, donate=False)
    core = kernel._core
    stop_all = stop_on == "all"
    pkey = ("dp_multi", kernel._cache_key, stop_on, _mesh_key(mesh))

    def build():
        n_extra = len(kernel._extra)

        def per_shard(state, n_chunks, *ex):
            def solved(st):
                if stop_all:
                    loc = jnp.all(st.done).astype(jnp.int32)
                    return jax.lax.pmin(loc, "traj") > 0
                loc = jnp.any(st.done).astype(jnp.int32)
                return jax.lax.pmax(loc, "traj") > 0

            def cond(carry):
                st, i = carry
                return (i < n_chunks) & ~solved(st)

            def body(carry):
                st, i = carry
                return core(st, *ex), i + 1

            st, n = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
            return st, n * chunk_steps

        sk = shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(STATE_SPECS, P()) + (P(),) * n_extra,
            out_specs=(STATE_SPECS, P()),
            check_vma=False,
        )
        return jax.jit(
            lambda state, bound, ex: sk(state, bound, *ex), donate_argnums=0
        )

    jitted = _cache_program(pkey, build)
    extra = kernel._extra
    bound = jnp.int32(max_chunks)
    return lambda state, dev=None: jitted(state, bound, extra)


def make_sharded_chunk_runner(
    fa: FormulaArrays, zeta: float, ode: ODEConfig, chunk_steps: int, mesh: Mesh
):
    """Jitted ``(state, dev) -> state`` over the mesh. On a
    trajectory-only mesh the fused kernel (when ops/select picks it) runs
    per device under shard_map, otherwise GSPMD partitions the scan path
    over the batch; with clause sharding the scan step runs under
    shard_map with explicit collectives."""
    from odesat_tpu.ops.select import resolve_strategy

    n_clause = mesh.shape.get("clause", 1)
    clause_axis = "clause" if n_clause > 1 else None
    strategy = resolve_strategy(fa, ode, clause_sharded=clause_axis is not None)

    if strategy == "fused":
        # pure DP: each device runs the kernel on its batch slice. The
        # incidence planes ride as jit ARGUMENTS and the program is
        # cached per (kernel shape key, mesh): a closure-traced wrapper
        # would bake the planes in as constants, one compile per
        # same-shaped instance (see ops/kernelctx.wrap_chunk_runner)
        from odesat_tpu.ops.fused_pallas import make_fused_chunk

        kernel = make_fused_chunk(fa, zeta, ode, chunk_steps)
        core = kernel._core
        extra = kernel._extra
        pkey = ("dp_chunk", kernel._cache_key, _mesh_key(mesh))

        def build():
            sk = shard_map(
                lambda state, *ex: core(state, *ex),
                mesh=mesh,
                in_specs=(STATE_SPECS,) + (P(),) * len(extra),
                out_specs=STATE_SPECS,
                check_vma=False,  # pallas_call outputs carry no vma info
            )
            return jax.jit(lambda state, ex: sk(state, *ex), donate_argnums=0)

        jitted = _cache_program(pkey, build)
        return lambda state, dev: jitted(state, extra)

    import dataclasses

    # traj_axis only matters inside shard_map for dt_mode="shared" (the
    # GSPMD jit path below reduces over the global batch automatically)
    step = make_step_fn(
        fa,
        zeta,
        dataclasses.replace(ode, dv_strategy=strategy),
        clause_axis=clause_axis,
        traj_axis="traj" if clause_axis is not None else None,
    )

    def run_chunk(state: ODEState, dev: FormulaDevice) -> ODEState:
        def body(carry, _):
            return step(carry, dev), None

        out, _ = jax.lax.scan(body, state, None, length=chunk_steps)
        return out

    if clause_axis is None:
        return jax.jit(
            run_chunk,
            in_shardings=(
                jax.tree.map(lambda s: NamedSharding(mesh, s), STATE_SPECS),
                jax.tree.map(lambda s: NamedSharding(mesh, s), DEV_SPECS),
            ),
            out_shardings=jax.tree.map(lambda s: NamedSharding(mesh, s), STATE_SPECS),
            donate_argnums=0,
        )

    sharded = shard_map(
        run_chunk, mesh=mesh, in_specs=(STATE_SPECS, DEV_SPECS), out_specs=STATE_SPECS
    )
    return jax.jit(sharded, donate_argnums=0)


def make_sharded_stoch_runner(fa: FormulaArrays, chunk_steps: int, mesh: Mesh):
    """Trajectory-DP stoch chunk runner: each device runs the scan chunk
    on its batch slice with its own PRNG key — chains are independent,
    so the only cross-device traffic is the host's done pull. The
    sharded state's ``key`` leading axis is the device axis ((n_traj, 2)
    keys from jax.random.split), NOT a batch axis.

    With a non-trivial clause axis the incidence arrays and xl shard
    over it; the per-variable weight sums are psum-reduced and all-sat
    AND-reduced inside shard_map (models/stoch.make_stoch_clause_step),
    so CNFs whose incidence/weight arrays exceed one device get the
    stoch engine too.

    Reference anchor: per-step chain independence, src/stoch.rs:26-78;
    the weight sums, src/stoch.rs:53-59.
    """
    from odesat_tpu.models.stoch import (
        StochState,
        make_stoch_chunk_runner,
        make_stoch_clause_step,
    )

    n_clause = mesh.shape.get("clause", 1)
    if n_clause > 1:
        from odesat_tpu.models.ode import formula_device
        from odesat_tpu.parallel.dist import put_global

        specs = StochState(
            v=P("traj"), xl=P("traj", "clause"), done=P("traj"), key=P("traj")
        )
        step = make_stoch_clause_step("clause")

        def local(state: StochState, dev: FormulaDevice) -> StochState:
            st = StochState(state.v, state.xl, state.done, state.key[0])

            def body(carry, _):
                return step(carry, dev), None

            out, _ = jax.lax.scan(body, st, None, length=chunk_steps)
            return StochState(out.v, out.xl, out.done, out.key[None])

        sharded = shard_map(
            local, mesh=mesh, in_specs=(specs, DEV_SPECS), out_specs=specs
        )
        jitted = jax.jit(sharded, donate_argnums=0)
        dev = jax.tree.map(
            lambda x, spec: put_global(x, NamedSharding(mesh, spec)),
            formula_device(fa),
            DEV_SPECS,
        )
        return lambda state: jitted(state, dev)

    inner = make_stoch_chunk_runner(fa, chunk_steps, donate=False)
    specs = StochState(v=P("traj"), xl=P("traj"), done=P("traj"), key=P("traj"))

    def local(state: StochState) -> StochState:
        st = StochState(state.v, state.xl, state.done, state.key[0])
        out = inner(st)
        return StochState(out.v, out.xl, out.done, out.key[None])

    sharded = shard_map(local, mesh=mesh, in_specs=(specs,), out_specs=specs)
    return jax.jit(sharded, donate_argnums=0)


def shard_stoch_inputs(state, mesh: Mesh):
    """Lay a StochState (with (n_traj, 2) per-device keys) out on the
    mesh; the clause weights shard over a non-trivial clause axis."""
    from odesat_tpu.models.stoch import StochState

    from odesat_tpu.parallel.dist import put_global

    xl_spec = P("traj", "clause") if mesh.shape.get("clause", 1) > 1 else P("traj")
    specs = StochState(v=P("traj"), xl=xl_spec, done=P("traj"), key=P("traj"))
    return jax.tree.map(
        lambda x, spec: put_global(x, NamedSharding(mesh, spec)), state, specs
    )


def simulate_batch_sharded(
    formula,
    config: SolverConfig,
    mesh: Mesh,
    key: Optional[jax.Array] = None,
    v0: Optional[np.ndarray] = None,
    stop_on: str = "any",
):
    """Mesh-sharded batched solve; same semantics as
    models.ode.simulate_batch on one device."""
    from odesat_tpu.models.ode import simulate_batch

    fa = compile_for_mesh(formula, config, mesh) if not isinstance(formula, FormulaArrays) else formula
    return simulate_batch(fa, config, key=key, v0=v0, stop_on=stop_on, mesh=mesh)
