"""Host<->global-array plumbing for multi-process runs.

On a single process these helpers degrade to ``jax.device_put`` /
``np.asarray`` exactly; across processes (``jax.process_count() > 1``) they do
what multi-host JAX requires instead:

* **placing** a host-local value onto a mesh that spans processes needs
  ``jax.make_array_from_callback`` (each process contributes the shards
  its local devices own — ``device_put`` of a host array onto a
  non-addressable sharding is an error);
* **pulling** a global array back to the host needs an allgather
  across processes (``multihost_utils.process_allgather``) because ``np.asarray`` can
  only read addressable shards.

The reference has no distributed anything (SURVEY.md §2b); this module
is the thin waist that lets the chunked host loop (models/loop.py) and
the CLI drive a multi-host job unchanged — the between-chunk done-flag
pull is the ONLY recurring cross-host transfer, everything else inside
the step rides the devices' own collectives.
"""

from __future__ import annotations

import numpy as np


def is_multiprocess() -> bool:
    import jax

    return jax.process_count() > 1


def put_global(x, sharding):
    """Place a host-local array on a (possibly process-spanning) sharding."""
    import jax
    import jax.numpy as jnp

    if not is_multiprocess():
        return jax.device_put(x, sharding)
    arr = jnp.asarray(x)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def fetch(x) -> np.ndarray:
    """Global (or local) array -> host ndarray on EVERY process.

    Collective when the array spans processes: all processes must call
    it in lockstep (the chunked drivers do — their control flow is a
    pure function of the fetched values, so processes stay in step)."""
    import jax

    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def is_primary() -> bool:
    """True on the process that should write files/artifacts (always
    true single-process)."""
    import jax

    return jax.process_index() == 0
