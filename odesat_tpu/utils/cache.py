"""Persistent XLA compilation cache.

The jitted-callable shape caches remove recompiles within a process;
this removes them across processes: compiled executables are written to
disk and loaded again by the next run.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX uses it, and nothing else is
  set here;
* otherwise one fixed directory inside the checkout,
  ``<repo>/.jax_cache`` (listed in ``.gitignore``). A fixed path keeps
  the cache's keys stable from run to run.

``ODESAT_NO_CACHE=1`` disables it. The CLI, the benchmarks and
``chip_smoke.py`` enable it; library users call
``enable_compilation_cache()`` themselves (a library should not mutate
global JAX config on import).
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache. Returns the directory
    in use, or None when disabled."""
    if os.environ.get("ODESAT_NO_CACHE"):
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # solver kernels are always worth persisting; the default 1 s floor
    # would skip small-formula programs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_CACHE_DIR
