"""Shared chunked-dispatch driver for both engines.

The ODE loop (models/ode.py simulate_batch) and the stochastic loop
(models/stoch.py search) dispatch fixed-size scan chunks and check exit
conditions on the host between chunks; everything around that — step
budget and tail chunks, multiplicative chunk escalation, wall-clock
budget, log/checkpoint cadence, profiler bracketing — is identical and
lives here once. The engines differ only in how a runner is built for a
chunk length and in their stop predicate.

Escalation: each chunk boundary costs a host round trip, so after
every GROW_AFTER further chunks without stopping, the chunk grows 16x
up to GROW_CAP — long runs converge to kernel-rate effective
throughput while fast solves keep the fine early-exit window. Cadence
flags disable growth so checkpoint/log intervals stay what the user
asked for.
"""

from __future__ import annotations

import time

GROW_AFTER = 8
GROW_CAP = 32768

# per-dispatch traj-step target for the device-loop dispatch structure:
# one dispatch stays ~1 s so the host keeps its logging/interrupt cadence
DISPATCH_TRAJ_STEPS = 1 << 28
DISPATCH_STEPS_CAP = 262144


def device_dispatch_plan(config, steps_budget):
    """Shared gate + sizing for the device-loop dispatch structure used
    by both engines (single-chip and trajectory-DP meshes). Returns
    ``(eligible, dispatch_steps)``: ``eligible`` is the config-level
    gate (callers AND it with their own probe — mesh axes, shape-cached
    core availability); ``dispatch_steps`` is the nominal per-dispatch
    slice — never below ``config.chunk_steps`` (the user's inner-chunk
    choice always stands), scaled down with batch size so one dispatch
    stays ~1 s, and clipped to the step budget."""
    inner = config.chunk_steps
    eligible = (
        not config.wants_chunk_cadence()
        # a wall-clock budget is only checked between dispatches: a
        # full-slice dispatch could overshoot it on a slow instance
        and config.wall_clock_budget_s is None
        and (steps_budget is None or steps_budget > inner)
    )
    dispatch = max(
        inner,
        min(DISPATCH_STEPS_CAP,
            DISPATCH_TRAJ_STEPS // max(config.batch_size, 1)),
    )
    if steps_budget is not None:
        dispatch = min(dispatch, steps_budget)
    return eligible, dispatch


def drive_chunks(
    state,
    make_runner,
    config,
    budget,
    should_stop,
    steps_resumed: int = 0,
    chunk_steps: int | None = None,
    mesh_layout=None,
):
    """Run ``state = runner(state)`` chunks until ``should_stop(state,
    done)`` (done arrives host-pulled), the step budget, or the
    wall-clock budget. ``make_runner(n) -> (state -> state)`` builds a
    runner advancing every trajectory n steps; a runner may instead
    return ``(state, steps_advanced)`` when it short-circuits on-device
    (models/ode.make_multi_chunk_runner) — the actual advance is then
    credited instead of the nominal n. Returns
    ``(state, steps_run, wall_time_s)``.
    """
    import jax

    from odesat_tpu.parallel.dist import fetch

    chunk_steps = chunk_steps if chunk_steps is not None else config.chunk_steps
    can_grow = not config.wants_chunk_cadence()

    runner = make_runner(chunk_steps)
    tail_runner = None
    tail_n = None
    steps_run = steps_resumed
    chunks = 0
    t0 = time.perf_counter()
    profiling = False
    if config.profile_dir:
        jax.profiler.start_trace(config.profile_dir)
        profiling = True
    try:
        while True:
            remaining = None if budget is None else budget - steps_run
            if remaining is not None and remaining <= 0:
                break
            chunk_t0 = time.perf_counter()
            if remaining is not None and remaining < chunk_steps:
                # keyed on remaining: a device-loop runner may advance
                # less than its nominal n, shifting later tail sizes
                if tail_runner is None or tail_n != remaining:
                    tail_runner = make_runner(remaining)
                    tail_n = remaining
                state = tail_runner(state)
                if type(state) is tuple:  # NamedTuple states are excluded
                    state, advanced = state
                    steps_run += int(advanced)
                else:
                    steps_run += remaining
            else:
                state = runner(state)
                if type(state) is tuple:  # NamedTuple states are excluded
                    state, advanced = state
                    steps_run += int(advanced)
                else:
                    steps_run += chunk_steps
            chunks += 1
            done = fetch(state.done)  # allgathers on a pod; SYNCS the chunk
            if can_grow and chunks % GROW_AFTER == 0 and chunk_steps < GROW_CAP:
                bigger = min(chunk_steps * 16, GROW_CAP)
                if budget is not None:
                    bigger = min(bigger, max(budget - steps_run, 1))
                if config.wall_clock_budget_s is not None:
                    # the budget is only checked between chunks, so bound
                    # the grown chunk's PREDICTED duration by the remaining
                    # seconds — a 16x-grown chunk must not overshoot a
                    # seconds budget by minutes. The chunk time is measured
                    # through the fetch above (dispatch is async; only the
                    # fetch blocks on device completion).
                    last_chunk_s = time.perf_counter() - chunk_t0
                    remaining_s = config.wall_clock_budget_s - (
                        time.perf_counter() - t0
                    )
                    if last_chunk_s > 0 and remaining_s > 0:
                        cap = int(remaining_s * chunk_steps / last_chunk_s)
                        bigger = min(bigger, max(cap, 1))
                    elif remaining_s <= 0:
                        bigger = chunk_steps  # budget already spent
                if bigger > chunk_steps:
                    runner = make_runner(bigger)
                    chunk_steps = bigger

            if should_stop(state, done):
                break
            if (
                config.wall_clock_budget_s is not None
                and time.perf_counter() - t0 > config.wall_clock_budget_s
            ):
                break
            if config.log_every_chunks and chunks % config.log_every_chunks == 0:
                from odesat_tpu.utils.logging import log_chunk

                log_chunk(state, steps_run)
            if (
                config.checkpoint_every_chunks
                and config.checkpoint_path
                and chunks % config.checkpoint_every_chunks == 0
            ):
                from odesat_tpu.utils.checkpoint import save_state

                save_state(
                    config.checkpoint_path, state, steps_run,
                    mesh_layout=mesh_layout,
                )
    finally:
        if profiling:
            jax.profiler.stop_trace()

    return state, steps_run, time.perf_counter() - t0
