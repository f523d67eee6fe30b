"""Benchmark timing helpers: steady-state rates timed on the host clock
around work that ends in ``jax.block_until_ready``."""

from __future__ import annotations

import time

import jax
import numpy as np


def sync(state) -> np.ndarray:
    """Block until every array of ``state`` is computed, then return its
    done flags on the host."""
    return np.asarray(jax.block_until_ready(state).done)


def measure_throughput(runner, state, dev, chunk_steps: int, batch: int, iters: int = 3):
    """Steady-state trajectories*steps/s: one warm-up call (compiles),
    then ``iters`` timed calls. Returns (rate, final_state)."""
    state = runner(state, dev)
    sync(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = runner(state, dev)
    sync(state)
    elapsed = time.perf_counter() - t0
    return batch * chunk_steps * iters / elapsed, state
