"""Device-mesh construction for trajectory and clause parallelism.

The reference is single-process, single-threaded (SURVEY.md §2b); this
build scales two ways:

* ``traj`` axis — pure data parallelism over independent trajectories
  (the restart/interlace batch), no communication except the tiny solved
  flag reduce between chunks;
* ``clause`` axis — for huge CNFs, the padded clause arrays shard over
  devices and per-variable dv contributions are psum-reduced across
  them. Every GPU of a host reaches every other at the same rate, so the
  mesh is a plain reshape of ``jax.devices()``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_traj: int | None = None, n_clause: int = 1, devices=None) -> Mesh:
    """Build a ('traj', 'clause') mesh. Defaults to all devices on the
    trajectory axis (the common case: trajectory parallelism only)."""
    devices = devices if devices is not None else jax.devices()
    if n_traj is None:
        n_traj = len(devices) // n_clause
    if n_traj * n_clause != len(devices):
        raise ValueError(
            f"mesh {n_traj}x{n_clause} does not match {len(devices)} devices"
        )
    grid = np.asarray(devices).reshape(n_traj, n_clause)
    return Mesh(grid, axis_names=("traj", "clause"))


def traj_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-axis sharding for (B, ...) trajectory state arrays."""
    return NamedSharding(mesh, P("traj"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
