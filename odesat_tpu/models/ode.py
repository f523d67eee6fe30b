"""The continuous-time SAT engine: batched Euler integration under jit.

Batched redesign of the reference integrators and drivers
(reference: src/system.rs:93-359). Key departures from the Rust design,
all deliberate (SURVEY.md §7):

* **Trajectories are a batch axis**, not a round-robin host loop: the scan
  carry is ``(v, xs, xl, dt, done)`` with a leading batch dimension; the
  reference's ``inter`` mode (src/system.rs:241-359) becomes the same code
  path with B > 1.
* **Per-trajectory adaptive dt.** The reference's interlaced mode shares
  one global dt across all trajectories (src/system.rs:314 — each
  trajectory inherits whatever the previous one's error left behind);
  here each trajectory carries its own dt, which is both the paper's
  intent and the only design that vmaps.
* **Early exit without leaving jit**: a naive scan always runs N steps;
  instead the host dispatches fixed-size scan *chunks* and checks the
  per-trajectory ``done`` flags between chunks. Solved trajectories are
  frozen inside the chunk via ``where(done, old, new)`` so their states
  (and the satisfying sign pattern) are preserved exactly.
* **Formula arrays are step arguments** (a ``FormulaDevice`` pytree), not
  closures, so the same step function runs unsharded, trajectory-sharded,
  or clause-sharded under ``shard_map`` with psum'd dv contributions.

Step semantics preserved from the reference:

* fixed step: derivatives are computed, the clamped update is applied
  **even on the step where allsat is detected**, then the loop breaks
  (src/system.rs:141-154 + the break in simulate);
* adaptive step (step doubling): one full-dt trial step vs two half-dt
  steps with a mid-point derivative re-evaluation; inf-norm error over
  all three state arrays; ``dt <- clip(dt*sqrt(tol/err), 2^-7, 1e3)``;
  when allsat the state is *not* advanced (src/system.rs:111-139).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from odesat_tpu.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu.cnf.formula import CNFFormula
from odesat_tpu.constants import (
    DT_INIT,
    DT_MAX,
    DT_MIN,
    EPSILON,
    XL_CAP_PER_CLAUSE,
)
from odesat_tpu.ops import rhs as rhs_ops
from odesat_tpu.utils.config import ODEConfig, SolverConfig


class ODEState(NamedTuple):
    """Scan carry, batched over the leading axis.

    v: (B, Np) variable values; xs/xl: (B, Mp) clause memories;
    dt: (B,) per-trajectory step size; done: (B,) bool allsat latches.
    """

    v: jax.Array
    xs: jax.Array
    xl: jax.Array
    dt: jax.Array
    done: jax.Array


class FormulaDevice(NamedTuple):
    """Device-resident incidence arrays, passed to the step function so
    they can be sharded over a clause mesh axis."""

    lit_var: jax.Array  # (K, Mp) int32
    sign: jax.Array  # (K, Mp)
    lit_mask: jax.Array  # (K, Mp)
    clause_mask: jax.Array  # (Mp,)
    var_occ: jax.Array  # (Np, D) int32
    occ_mask: jax.Array  # (Np, D)


def formula_device(fa: FormulaArrays, dtype=jnp.float32) -> FormulaDevice:
    return FormulaDevice(
        lit_var=jnp.asarray(fa.lit_var),
        sign=jnp.asarray(fa.sign, dtype=dtype),
        lit_mask=jnp.asarray(fa.lit_mask, dtype=dtype),
        clause_mask=jnp.asarray(fa.clause_mask, dtype=dtype),
        var_occ=jnp.asarray(fa.var_occ),
        occ_mask=jnp.asarray(fa.occ_mask, dtype=dtype),
    )


@dataclass
class SolveResult:
    """Outcome of a batched solve."""

    assignment: np.ndarray  # (B, n_vars) bool readout sign(v) > 0
    done: np.ndarray  # (B,) bool — trajectory reached allsat
    steps: int  # scan steps dispatched per trajectory
    solved_index: Optional[int]  # first done trajectory, else None
    wall_time_s: float = 0.0

    @property
    def any_solved(self) -> bool:
        return self.solved_index is not None

    def best_assignment(self) -> np.ndarray:
        """First satisfied trajectory's readout, else trajectory 0
        (reference: src/system.rs:353-358)."""
        idx = self.solved_index if self.solved_index is not None else 0
        return self.assignment[idx]


def _dtype(ode: ODEConfig):
    """Resolve the state dtype.

    **Global side effect, by design**: requesting ``dtype="float64"``
    flips ``jax_enable_x64`` for the whole process (without it jnp
    silently truncates f64 arrays to f32, so the reference-parity dtype
    the user asked for would be a lie — reference is f64 throughout,
    src/system.rs:6-11). JAX offers no per-computation x64 scope that
    survives returned arrays, so the honest options are this toggle or
    refusing f64; we toggle and warn once. Subsequent f32 work in the
    same process keeps f32 *arrays* but weakly-typed Python scalars
    promote to f64 — callers mixing dtypes in one process should enable
    x64 themselves at startup."""
    if ode.dtype == "float64":
        if not jax.config.jax_enable_x64:
            import warnings

            warnings.warn(
                "dtype='float64' enables jax_enable_x64 process-wide "
                "(see models/ode.py:_dtype); set JAX_ENABLE_X64=1 at "
                "startup to silence this",
                stacklevel=2,
            )
            jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def init_state(
    fa: FormulaArrays,
    batch_size: int,
    key: jax.Array,
    ode: ODEConfig,
    v0: Optional[np.ndarray] = None,
) -> ODEState:
    """Fresh trajectory batch: v ~ U(-1, 1), xs from the all-false clause
    valuation, xl = 1, dt = 0.01 (reference: src/main.rs:170-174,
    src/system.rs:205, 362-372)."""
    dtype = _dtype(ode)
    if v0 is not None:
        v = jnp.broadcast_to(
            jnp.asarray(v0, dtype=dtype), (batch_size, fa.n_vars_padded)
        ).copy()
    else:
        v = jax.random.uniform(
            key, (batch_size, fa.n_vars_padded), dtype=dtype, minval=-1.0, maxval=1.0
        )
    xs = jnp.broadcast_to(
        jnp.asarray(fa.xs_init, dtype=dtype), (batch_size, fa.n_clauses_padded)
    ).copy()
    xl = jnp.ones((batch_size, fa.n_clauses_padded), dtype=dtype)
    dt = jnp.full((batch_size,), DT_INIT, dtype=dtype)
    done = jnp.zeros((batch_size,), dtype=jnp.bool_)
    return ODEState(v, xs, xl, dt, done)


def make_step_fn(
    fa: FormulaArrays,
    zeta: float,
    ode: ODEConfig,
    clause_axis: Optional[str] = None,
    traj_axis: Optional[str] = None,
):
    """Build ``step(state, dev) -> state`` for a batched ODEState.

    When ``clause_axis`` is set, the step runs inside shard_map over that
    mesh axis: dv contributions, the allsat flag, and the adaptive error
    norm are reduced with psum/pmax across the clause devices.
    ``traj_axis`` only matters for ``dt_mode="shared"`` inside shard_map,
    where the batch-wide error max must also reduce over the trajectory
    mesh axis.
    """
    from odesat_tpu.ops.select import scan_strategy

    xl_cap = XL_CAP_PER_CLAUSE * fa.n_clauses  # real clause count (src/system.rs:95)
    zeta = float(zeta)
    dv_strategy = ode.dv_strategy
    if dv_strategy in ("fused", "auto"):
        # 'fused' is a whole-chunk kernel (make_chunk_runner handles
        # it); in single-step contexts pick between the XLA accumulators
        dv_strategy = scan_strategy(fa)
    if clause_axis is not None and dv_strategy in ("gather", "onehot"):
        # variable-major occurrence tables index the *global* flattened
        # clause slots; under a clause shard each device only holds its
        # slice, so fall back to a local segment-sum + psum.
        dv_strategy = "segment_sum"
    if clause_axis is not None and len(fa.bucket_slices) > 1:
        raise ValueError(
            "width-bucketed formulas cannot shard over a clause mesh axis "
            "(bucket coordinates are global); compile with bucket=False"
        )
    if dv_strategy == "onehot" and fa.min_width < 2:
        # unit clauses carry infinite gradients (see ops/rhs.py); the
        # one-hot matmul would turn inf * 0 into NaN, so fall back
        dv_strategy = "gather"

    onehot = None
    if dv_strategy == "onehot":
        # constant (K*M, N) incidence matrix, baked at build time so the
        # matmul reuses one buffer instead of rematerializing it
        onehot = rhs_ops.build_onehot(
            jnp.asarray(fa.lit_var), jnp.asarray(fa.lit_mask), fa.n_vars_padded, dtype=_dtype(ode)
        )

    def derivs(v, xs, xl, dev: FormulaDevice):
        dv, dxs, dxl, allsat = rhs_ops.compute_derivatives(
            v,
            xs,
            xl,
            lit_var=dev.lit_var,
            sign=dev.sign,
            lit_mask=dev.lit_mask,
            clause_mask=dev.clause_mask,
            var_occ=dev.var_occ,
            occ_mask=dev.occ_mask,
            zeta=zeta,
            rigidity=ode.rigidity,
            dv_strategy=dv_strategy,
            onehot=onehot,
            bucket_slices=fa.bucket_slices if len(fa.bucket_slices) > 1 else None,
        )
        if clause_axis is not None:
            dv = jax.lax.psum(dv, clause_axis)
            allsat = jax.lax.psum((~allsat).astype(jnp.int32), clause_axis) == 0
        return dv, dxs, dxl, allsat

    def update(v, xs, xl, dv, dxs, dxl, dt):
        """Clamped Euler update (reference: src/system.rs:93-97).
        dt broadcasts per trajectory: (B,) against (B, ...).

        fmax/fmin (NaN-ignoring) match Rust's f64::max/min: a NaN update
        (conflicting unit clauses summing +inf and -inf) clamps to the
        lower bound instead of poisoning the state."""
        dt_c = dt[..., None]
        xs2 = jnp.fmin(jnp.fmax(xs + dt_c * dxs, EPSILON), 1.0 - EPSILON)
        xl2 = jnp.fmin(jnp.fmax(xl + dt_c * dxl, 1.0), xl_cap)
        v2 = jnp.fmin(jnp.fmax(v + dt_c * dv, -1.0), 1.0)
        return v2, xs2, xl2

    def freeze(cond, new, old):
        return jnp.where(cond[..., None], new, old)

    if ode.step_size is not None:
        dt_fixed = float(ode.step_size)

        def step(state: ODEState, dev: FormulaDevice) -> ODEState:
            dv, dxs, dxl, allsat = derivs(state.v, state.xs, state.xl, dev)
            active = ~state.done
            dt_b = jnp.where(active, dt_fixed, 0.0).astype(state.v.dtype)
            v, xs, xl = update(state.v, state.xs, state.xl, dv, dxs, dxl, dt_b)
            done = state.done | allsat
            return ODEState(v, xs, xl, state.dt, done)

    else:
        tol = float(ode.tolerance)

        def step(state: ODEState, dev: FormulaDevice) -> ODEState:
            dv, dxs, dxl, allsat = derivs(state.v, state.xs, state.xl, dev)
            advance = ~state.done & ~allsat  # src/system.rs:122: no update when allsat
            dt = state.dt

            # one full step (trial) vs two half steps (kept)
            fv, fxs, fxl = update(state.v, state.xs, state.xl, dv, dxs, dxl, dt)
            hv, hxs, hxl = update(state.v, state.xs, state.xl, dv, dxs, dxl, 0.5 * dt)
            dv2, dxs2, dxl2, _ = derivs(hv, hxs, hxl, dev)
            tv, txs, txl = update(hv, hxs, hxl, dv2, dxs2, dxl2, 0.5 * dt)

            err = jnp.maximum(
                jnp.max(jnp.abs(fv - tv), axis=-1),
                jnp.maximum(
                    jnp.max(jnp.abs(fxs - txs), axis=-1),
                    jnp.max(jnp.abs(fxl - txl), axis=-1),
                ),
            )
            if clause_axis is not None:
                err = jax.lax.pmax(err, clause_axis)
            if ode.dt_mode == "shared":
                # reference inter parity: one dt for the whole batch,
                # adapted from the batch-max error (src/system.rs:314).
                # Frozen/allsat trajectories never adapt dt in the
                # reference (src/system.rs:122-136), so their
                # hypothetical-step errors must not pollute the shared dt
                err = jnp.where(advance, err, 0.0)
                err = jnp.broadcast_to(jnp.max(err, keepdims=True), err.shape)
                if traj_axis is not None:
                    err = jax.lax.pmax(err, traj_axis)
            # err == 0 -> dt hits the ceiling, like the reference's
            # dt*inf clamped at 1e3 (src/system.rs:132-135).
            new_dt = jnp.clip(dt * jnp.sqrt(tol / jnp.maximum(err, 1e-30)), DT_MIN, DT_MAX)

            v = freeze(advance, tv, state.v)
            xs = freeze(advance, txs, state.xs)
            xl = freeze(advance, txl, state.xl)
            dt = jnp.where(advance, new_dt, state.dt)
            done = state.done | allsat
            return ODEState(v, xs, xl, dt, done)

    return step


def make_chunk_runner(
    fa: FormulaArrays, zeta: float, ode: ODEConfig, chunk_steps: int, donate: bool = True
):
    """Jitted ``(state, dev) -> state`` advancing every trajectory by
    ``chunk_steps`` steps (solved trajectories stay frozen). The state
    buffers are donated so XLA updates them in place.

    ``ops/select.resolve_strategy`` decides the path: the fused Pallas
    chunk kernel (ops/fused_pallas.py) runs the whole chunk in one
    launch; the scan path runs a ``lax.scan`` of single steps."""
    from odesat_tpu.ops.select import resolve_strategy

    strategy = resolve_strategy(fa, ode)
    if strategy == "fused":
        from odesat_tpu.ops.fused_pallas import make_fused_chunk

        # already jitted inside (shape-cached; donated state)
        return make_fused_chunk(fa, zeta, ode, chunk_steps, donate=donate)
    ode = dataclasses.replace(ode, dv_strategy=strategy)

    step = make_step_fn(fa, zeta, ode)

    def run_chunk(state: ODEState, dev: FormulaDevice) -> ODEState:
        def body(carry, _):
            return step(carry, dev), None

        out, _ = jax.lax.scan(body, state, None, length=chunk_steps)
        return out

    return jax.jit(run_chunk, donate_argnums=0 if donate else ())


# Multi-chunk runners are cached so repeated simulate_batch calls don't
# re-jit (and re-compile) the while_loop program. Two tiers:
#  - chunk runners exposing a shape-cached core (_core/_extra from
#    ops/kernelctx.wrap_chunk_runner — the fused Pallas kernel) share
#    ONE compiled while program per static shape: the incidence planes
#    ride as jit ARGUMENTS, so a same-shaped instance costs nothing.
#    Tracing the closure wrapper instead would bake the planes in as
#    constants — one full compile per instance.
#  - scan-path runners (content threads through `dev`) fall back to a
#    bounded formula-identity cache; the value pins `fa` so a recycled
#    id() cannot alias a dead formula's runner.
_MULTI_CORE_CACHE: dict = {}
_MULTI_CHUNK_CACHE: dict = {}


def make_multi_chunk_runner(
    fa: FormulaArrays,
    zeta: float,
    ode: ODEConfig,
    chunk_steps: int,
    max_chunks: int,
    stop_on: str = "any",
    core_only: bool = False,
):
    chunk = make_chunk_runner(fa, zeta, ode, chunk_steps, donate=False)
    core = getattr(chunk, "_core", None)
    if core is None and core_only:
        # caller wants the shape-shared program or nothing (a scan-path
        # while program would recompile per formula)
        return None
    if core is not None:
        # max_chunks rides as a TRACED scalar, not a static constant —
        # one compiled while program per (shape, inner chunk) serves
        # every dispatch-slice and budget-tail size (a static bound
        # meant one compile per distinct budget)
        key = (chunk._cache_key, stop_on)
        jitted_run = _MULTI_CORE_CACHE.get(key)
        if jitted_run is None:
            stop_all = stop_on == "all"

            def run(state: ODEState, extra, n_chunks):
                def cond(carry):
                    st, i = carry
                    solved = jnp.all(st.done) if stop_all else jnp.any(st.done)
                    return (i < n_chunks) & ~solved

                def body(carry):
                    st, i = carry
                    return core(st, *extra), i + 1

                st, n = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
                return st, n * chunk_steps

            jitted_run = jax.jit(run, donate_argnums=0)
            _MULTI_CORE_CACHE[key] = jitted_run
        extra = chunk._extra
        bound = jnp.int32(max_chunks)
        return lambda state, dev=None: jitted_run(state, extra, bound)

    key = (
        id(fa),
        float(zeta),
        tuple(sorted((k, v) for k, v in dataclasses.asdict(ode).items())),
        chunk_steps,
        max_chunks,
        stop_on,
    )
    hit = _MULTI_CHUNK_CACHE.get(key)
    if hit is not None:
        return hit[0]
    run = _build_multi_chunk_runner(chunk, chunk_steps, max_chunks, stop_on)
    if len(_MULTI_CHUNK_CACHE) >= 128:
        _MULTI_CHUNK_CACHE.clear()
    _MULTI_CHUNK_CACHE[key] = (run, fa)
    return run


def _build_multi_chunk_runner(
    chunk,
    chunk_steps: int,
    max_chunks: int,
    stop_on: str = "any",
):
    """Jitted ``(state, dev) -> (state, steps_advanced)`` running up to
    ``max_chunks`` chunks of ``chunk_steps`` inside ONE dispatch, with an
    on-device done short-circuit between chunks (``lax.while_loop``).

    Small batches are dispatch-latency bound: the host round trip
    dwarfs the step cost, and host-side chunk escalation merely
    amortizes it at the price of coarse early exit. The device loop
    keeps the fine exit window (one inner chunk) while paying ONE
    dispatch per ``max_chunks`` chunks — the batched shape of the
    reference's per-step solved break (src/system.rs:192-196).
    ``steps_advanced`` is exact (chunks actually run x chunk_steps), so
    the host budget accounting stays precise."""
    stop_all = stop_on == "all"

    def run(state: ODEState, dev: FormulaDevice):
        def cond(carry):
            st, i = carry
            solved = jnp.all(st.done) if stop_all else jnp.any(st.done)
            return (i < max_chunks) & ~solved

        def body(carry):
            st, i = carry
            return chunk(st, dev), i + 1

        st, n = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
        return st, n * chunk_steps

    return jax.jit(run, donate_argnums=0)


def _readout(state: ODEState, n_vars: int) -> np.ndarray:
    """Boolean readout: v > 0 (reference: src/system.rs:238)."""
    from odesat_tpu.parallel.dist import fetch

    return fetch(state.v[:, :n_vars] > 0.0)


def _resolve_key(config: SolverConfig, key: Optional[jax.Array]) -> jax.Array:
    if key is not None:
        return key
    seed = config.seed if config.seed is not None else int.from_bytes(os.urandom(4), "little")
    return jax.random.PRNGKey(seed)


def simulate_batch(
    formula_or_arrays,
    config: SolverConfig,
    key: Optional[jax.Array] = None,
    v0: Optional[np.ndarray] = None,
    stop_on: str = "any",
    harvest=None,
    mesh=None,
) -> SolveResult:
    """Run ``config.batch_size`` trajectories to completion or budget.

    ``stop_on``: "any" stops as soon as one trajectory reaches allsat
    (reference inter semantics, src/system.rs:291); "all" runs until every
    trajectory is done or the budget is exhausted (parallel-restart /
    batch semantics). ``harvest(state, done) -> bool`` is called between
    chunks with the already-host-pulled done flags (avoids a second
    device round trip); returning True stops the run (used for
    oracle-verified early exit).
    ``mesh``: a ('traj', 'clause') jax Mesh to shard over; None runs on
    one device.
    """
    if isinstance(formula_or_arrays, FormulaArrays):
        fa = formula_or_arrays
    elif mesh is not None:
        from odesat_tpu.parallel.sharded import compile_for_mesh

        fa = compile_for_mesh(formula_or_arrays, config, mesh)
    else:
        formula = formula_or_arrays
        bucket = config.bucket == "on" or (
            config.bucket == "auto"
            and formula.num_clauses >= 512
            and formula.max_clause_width
            > min((len(c) for c in formula.clauses), default=1)
        )
        fa = compile_formula(
            formula,
            clause_pad=config.clause_pad,
            var_pad=config.var_pad,
            bucket=bucket,
        )
    ode = config.ode
    zeta = ode.resolve_zeta(fa.density)
    key = _resolve_key(config, key)

    steps_resumed = 0
    if config.resume_from:
        from odesat_tpu.utils.checkpoint import load_state, validate_mesh_layout

        loaded, steps_resumed, saved_layout = load_state(
            config.resume_from, ODEState
        )
        # the clause axis changes the compiled clause layout itself —
        # a mismatched resume would be silently wrong, not just misshapen.
        # The traj axis is pure DP for the ODE state and may reshard
        # freely (traj_sensitive=False); stoch/hybrid keep the full check
        validate_mesh_layout(
            saved_layout, mesh, what="ODE snapshot", traj_sensitive=False
        )
        state = jax.tree.map(jnp.asarray, loaded)
    else:
        state = init_state(fa, config.batch_size, key, ode, v0=v0)
    dev = formula_device(fa, dtype=_dtype(ode))

    # Chunked dispatch pays one host round trip per chunk. An on-device
    # bounded while_loop runs many chunks per dispatch with
    # an exact done short-circuit between them (make_multi_chunk_runner)
    # — unlike host-side chunk growth, the early-exit window stays ONE
    # inner chunk while dispatch overhead amortizes over the whole
    # dispatch. Used at every batch size; the per-dispatch slice scales
    # down with B so one dispatch stays ~1 s (the host regains control —
    # logging, KeyboardInterrupt — at that cadence).
    from odesat_tpu.models.loop import device_dispatch_plan

    chunk_steps = config.chunk_steps
    dispatch_ok, DISPATCH_STEPS = device_dispatch_plan(config, ode.steps)
    use_device_loop = (
        mesh is None
        and harvest is None  # the oracle exit needs host control per chunk
        and dispatch_ok
    )

    if use_device_loop:
        inner_chunk = chunk_steps
        chunk_steps = DISPATCH_STEPS  # nominal per-dispatch budget slice

        def make_runner(n):
            if n <= inner_chunk:
                r = make_chunk_runner(fa, zeta, ode, n)
                return lambda st: r(st, dev)
            m = make_multi_chunk_runner(
                fa, zeta, ode, inner_chunk, n // inner_chunk, stop_on=stop_on
            )
            return lambda st: m(st, dev)
    elif mesh is None:
        def make_runner(n):
            r = make_chunk_runner(fa, zeta, ode, n)
            return lambda st: r(st, dev)
    else:
        from odesat_tpu.parallel.sharded import (
            make_sharded_chunk_runner,
            make_sharded_multi_runner,
            shard_inputs,
            sharded_multi_supported,
        )

        state, dev = shard_inputs(state, dev, mesh)

        def plain_runner(n):
            r = make_sharded_chunk_runner(fa, zeta, ode, n, mesh)
            return lambda st: r(st, dev)

        # trajectory-only (pure DP) meshes get the same device-loop
        # dispatch as the single-device path: the stop flag reduces over
        # the traj axis every inner chunk (a pmax), so a mesh run pays
        # one host round trip per dispatch instead of per chunk
        mesh_loop = (
            harvest is None
            and dispatch_ok
            and sharded_multi_supported(fa, ode, mesh)
        )
        if mesh_loop:
            inner_chunk = chunk_steps
            chunk_steps = DISPATCH_STEPS

            def make_runner(n):
                if n > inner_chunk:
                    m = make_sharded_multi_runner(
                        fa, zeta, ode, inner_chunk, n // inner_chunk, mesh,
                        stop_on,
                    )
                    if m is not None:
                        return m
                return plain_runner(n)
        else:
            make_runner = plain_runner

    def should_stop(st, done):
        # harvest first: the oracle-verified exit (and its progress
        # line) must run even on the chunk where every trajectory
        # converges
        if harvest is not None and harvest(st, done):
            return True
        if stop_on == "any" and done.any():
            return True
        return bool(done.all())

    from odesat_tpu.models.loop import drive_chunks

    from odesat_tpu.utils.checkpoint import mesh_layout_of

    state, steps_run, wall_time = drive_chunks(
        state,
        make_runner,
        config,
        budget=ode.steps,  # None => unbounded
        should_stop=should_stop,
        steps_resumed=steps_resumed,
        chunk_steps=chunk_steps,
        mesh_layout=mesh_layout_of(mesh),
    )

    from odesat_tpu.parallel.dist import fetch

    done = fetch(state.done)
    solved = np.flatnonzero(done)
    return SolveResult(
        assignment=_readout(state, fa.n_vars),
        done=done,
        steps=steps_run,
        solved_index=int(solved[0]) if solved.size else None,
        wall_time_s=wall_time,
    )


def simulate(
    formula: CNFFormula,
    config: Optional[SolverConfig] = None,
    key: Optional[jax.Array] = None,
    v0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Single-trajectory solve returning the boolean readout of length
    ``varnum`` (reference: src/system.rs:156-239). The formula must be
    normalized (dense variable indices)."""
    config = config or SolverConfig()
    if config.batch_size != 1:
        config = dataclasses.replace(config, batch_size=1)
    result = simulate_batch(formula, config, key=key, v0=v0)
    return result.assignment[0]
