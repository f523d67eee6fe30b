"""Helpers shared by Pallas kernel wrappers.

``pallas_call_32bit``: the kernels are written for 32-bit state, but
Python scalar constants and loop indices inside a kernel body trace at
the PROCESS default width. With ``jax_enable_x64`` on (models/ode.py
``_dtype`` flips it process-wide when a user asks for an f64 scan-path
solve, and the test harness turns it on), float constants would trace as
weak f64 and loop indices as i64: ``jnp.where(cond, 1.0, 0.0)`` comes out
f64, and the fused kernel's loop carries change dtype, which tracing
rejects. The kernels' inputs are all 32-bit, so
disabling x64 around each ``pallas_call`` invocation restores the exact
32-bit trace the kernels are written for, with no effect when x64 is off.
"""

from __future__ import annotations

import jax
from jax.experimental import pallas as pl


def trace_32bit():
    """Context manager: trace the enclosed kernel invocation with 32-bit
    weak scalars regardless of the process-wide ``jax_enable_x64``."""
    return jax.enable_x64(False)


def pallas_call_32bit(*args, **kwargs):
    """``pl.pallas_call`` whose invocation (kernel-body and index-map
    tracing included) runs under :func:`trace_32bit`."""
    inner = pl.pallas_call(*args, **kwargs)

    def invoke(*a, **k):
        with trace_32bit():
            return inner(*a, **k)

    return invoke


def wrap_chunk_runner(jitted, cache_key, *extra):
    """Wrap a shape-cached jitted chunk kernel into the `(state, dev) ->
    state` runner signature, exposing the pieces composition needs:

    - ``_core``: the shape-cached jitted function itself (same object
      for every same-shaped formula via the kernel's _JIT_CACHE);
    - ``_extra``: this instance's incidence-plane arguments;
    - ``_cache_key``: the kernel's static-shape cache key.

    Callers that embed the runner in a larger jitted program (the
    on-device multi-chunk loop in models/ode.py) MUST trace ``_core``
    with ``_extra`` threaded as jit arguments — tracing the closure
    wrapper instead bakes the planes into the program as constants,
    turning every same-shaped instance into a fresh compile."""
    def fn(state, dev=None):
        return jitted(state, *extra)

    fn._core = jitted
    fn._extra = extra
    fn._cache_key = cache_key
    return fn
