"""Load-robust time-to-solution protocol with exact step resolution.

The north-star metric (BASELINE.md config 5) is time-to-solution on
uf250-class instances. Two measurement problems make naive wall-clock
numbers useless here, and this module is the one implementation of the
protocol that fixes both — tools/uf250_tts.py and
benchmarks/run_benchmarks.py both call it so their numbers agree:

1. **Wall clock swings with host load** (the host paces chunks and
   shares its cores). The protocol separates the run into a deterministic
   steps-to-solution (zero measurement noise), a compute TTS derived
   from the separately measured steady-state kernel rate, a dispatch
   share (chunks x measured round-trip latency), and a residual that
   names the host noise instead of absorbing it.

2. **Chunked early exit makes steps-to-solution chunk-granular** — the
   round-3 measurement reported 500 for every instance because every
   instance finished inside its first 500-step chunk. ``solve_exact``
   resolves the true first-solve step by bisecting inside the final
   chunk: ``done`` latches monotonically, so running power-of-two
   sub-chunks (compiled once each, reused across instances) from the
   pre-final-chunk snapshot finds the exact step in ~log2(chunk) tiny
   dispatches.

The integration itself is the production path (models/ode.py
make_chunk_runner, same kernels) — only the driving loop differs: it
keeps the pre-chunk snapshot (non-donating runners) so the bisection
has a starting state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ExactSolve:
    """Outcome of ``solve_exact``: the exact first-solve step (or the
    budget when unsolved), the solve's own chunk count and wall time
    (bisection probes excluded — they are measurement apparatus, not
    part of a production solve)."""

    steps: int
    solved: bool
    chunks: int
    wall_s: float
    solved_index: Optional[int] = None  # first done trajectory
    assignment: Optional[np.ndarray] = None  # that trajectory's readout


def measure_dispatch_latency(n: int = 15) -> float:
    """Median dispatch+sync round trip of a tiny jitted op, seconds."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((8, 128))
    f = jax.jit(lambda a: a + 1.0)
    np.asarray(f(x))  # compile
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        np.asarray(f(x))
        lat.append(time.perf_counter() - t0)
    return float(np.median(lat))


def _pow2_ladder(chunk: int) -> list[int]:
    """Descending powers of two that can compose any offset < chunk."""
    sizes = []
    s = 1
    while s < chunk:
        s *= 2
    s //= 2
    while s >= 1:
        sizes.append(s)
        s //= 2
    return sizes


def evict_formula(runner_cache: dict, fa) -> None:
    """Drop every runner ``solve_exact`` cached for ``fa``.

    A shared cache pins each formula (the value holds ``fa`` so a
    recycled ``id`` can never alias a dead formula's runner), so a long
    multi-instance sweep that never evicts grows memory without bound —
    each retired instance keeps its device incidence planes alive. Call
    this when moving to the next instance; same-shaped instances still
    reuse the compiled Pallas kernels one level down (shape-keyed jit
    caches), so eviction costs a retrace, not a recompile."""
    for key in [k for k in runner_cache if k[0] == id(fa)]:
        del runner_cache[key]


def solve_exact(
    fa,
    ode,
    batch: int,
    key,
    chunk: int,
    budget: int,
    runner_cache: Optional[dict] = None,
    readout: bool = False,
) -> ExactSolve:
    """Run a trajectory batch until any trajectory solves (or ``budget``
    steps), resolving the EXACT first-solve step by final-chunk
    bisection.

    ``runner_cache`` may be shared across instances — entries are keyed
    by (formula identity, chunk length), because ``make_chunk_runner``
    bakes the formula CONTENT (the fused kernel's incidence planes) into
    the runner at build time, not just its shape. A shape-only key would
    silently solve every later instance against the first one's formula
    (caught in round 4: 20 "instances" were 20 inits of instance 0).
    Cross-instance compile reuse still happens one level down — the
    Pallas chunk kernels are jit-cached on the static shape signature,
    so a same-shaped instance only pays a retrace, not a recompile.
    Runners are built non-donating: the pre-chunk snapshot must stay
    alive as the bisection start state.

    Entries pin their formula and are never dropped automatically —
    multi-instance sweeps sharing one cache should ``evict_formula``
    each instance when done with it, or memory grows with every
    instance ever solved.
    """
    import jax

    from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
    from odesat_tpu.utils.timing import sync

    if runner_cache is None:
        runner_cache = {}
    zeta = ode.resolve_zeta(fa.density)

    def runner(n):
        # id(fa) is stable while fa is alive; the entry pins fa so a
        # recycled id cannot alias a dead formula's runner
        key = (id(fa), n)
        if key not in runner_cache:
            runner_cache[key] = (
                make_chunk_runner(fa, zeta, ode, n, donate=False), fa
            )
        return runner_cache[key][0]

    dev = formula_device(fa)
    state = init_state(fa, batch, key, ode)
    import jax as _jax

    def finish(cur, final, base, n, chunks, wall):
        # bisect inside the final chunk: smallest k in (0, n] with
        # done.any(). done latches, so each probe either crosses the
        # first-solve step (discard) or lands before it (advance the
        # snapshot).
        off = 0
        for size in _pow2_ladder(n):
            if off + size >= n:  # can't advance past the known-solved point
                continue
            probe = runner(size)(cur, dev)
            if sync(probe).any():
                final = probe
                continue
            cur = probe
            off += size
        exact = base + off + 1
        from odesat_tpu.parallel.dist import fetch

        # `final` is the earliest solved state seen; its lowest-indexed
        # done trajectory latched at some step <= final's and has been
        # frozen since (sign readout one update past detection,
        # src/system.rs:238 — the reference applies the update on the
        # allsat step too)
        idx = int(np.flatnonzero(fetch(final.done))[0])
        assignment = fetch(final.v[idx, : fa.n_vars] > 0.0) if readout else None
        return ExactSolve(steps=exact, solved=True, chunks=chunks,
                          wall_s=wall, solved_index=idx, assignment=assignment)

    # Device-loop fast path: run the whole chunk ladder in ONE dispatch
    # (on-device while_loop with a done short-circuit between chunks —
    # models/ode.make_multi_chunk_runner), then recover the pre-final-
    # chunk snapshot by a deterministic replay (bit-identical kernels,
    # pinned by the determinism soak) and bisect as before. Wall TTS
    # then carries one round trip instead of one per chunk; the exact
    # step count is unchanged.
    from odesat_tpu.models.ode import make_multi_chunk_runner

    import jax.numpy as jnp

    multi = None
    if budget // chunk >= 2:
        multi = make_multi_chunk_runner(
            fa, zeta, ode, chunk, budget // chunk, core_only=True
        )
    if multi is not None:
        copy = lambda st: jax.tree.map(jnp.copy, st)  # noqa: E731
        # warm the while program off the clock at ONE chunk of work: the
        # bound is a traced scalar, so this compiles the identical
        # program the timed full-bound dispatch reuses (warming with the
        # full bound would run the whole budget on the throwaway state)
        warm = make_multi_chunk_runner(fa, zeta, ode, chunk, 1, core_only=True)
        out, _ = warm(init_state(fa, batch, _jax.random.PRNGKey(0), ode))
        sync(out)
        t0 = time.perf_counter()
        out, adv = multi(copy(state))
        done = sync(out)
        wall = time.perf_counter() - t0
        chunks = 1
        steps = int(adv)
        if not done.any():
            rem = budget - steps
            if rem > 0:  # budget tail shorter than one chunk, host-paced
                before_tail = out
                t1 = time.perf_counter()
                out = runner(rem)(out, dev)
                done = sync(out)
                wall += time.perf_counter() - t1
                chunks += 1
                if done.any():
                    return finish(before_tail, out, steps, rem, chunks, wall)
            return ExactSolve(steps=budget, solved=False, chunks=chunks,
                              wall_s=wall)
        n_chunks = steps // chunk
        if n_chunks > 1:
            replay = make_multi_chunk_runner(
                fa, zeta, ode, chunk, n_chunks - 1, core_only=True
            )
            prev, _ = replay(copy(state))
        else:
            prev = state
        return finish(prev, out, steps - chunk, chunk, chunks, wall)

    # host-paced path: warm the solve-chunk compile OUTSIDE the timed
    # region (bisection runners compile lazily during the untimed
    # bisection phase) with one throwaway dispatch
    n0 = min(chunk, budget)
    sync(runner(n0)(init_state(fa, batch, _jax.random.PRNGKey(0), ode), dev))
    steps = 0
    chunks = 0
    prev = state
    t0 = time.perf_counter()
    while steps < budget:
        n = min(chunk, budget - steps)
        prev = state
        state = runner(n)(state, dev)
        steps += n
        chunks += 1
        if sync(state).any():
            break
    else:
        return ExactSolve(steps=budget, solved=False, chunks=chunks,
                          wall_s=time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    return finish(prev, state, steps - n, n, chunks, wall)


def tts_breakdown(steps: int, chunks: int, batch: int, kernel_rate: float,
                  dispatch_s: float, wall_s: float) -> dict:
    """Split a wall-clock TTS into compute / dispatch / residual."""
    compute = steps * batch / kernel_rate
    overhead = chunks * dispatch_s
    return {
        "steps": int(steps),
        "compute_s": float(compute),
        "dispatch_s": float(overhead),
        "wall_s": float(wall_s),
        "residual_s": float(wall_s - compute - overhead),
    }
