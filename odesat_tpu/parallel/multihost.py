"""Multi-host initialization glue.

The reference has no distributed anything (SURVEY.md §2b); across hosts
the equivalent is ``jax.distributed.initialize`` + a global mesh whose
``traj`` axis spans hosts. Trajectory parallelism needs no cross-host
communication inside the step — only the between-chunk done-flag reduce
crosses hosts — so scaling across hosts is embarrassingly parallel.
Clause sharding should stay *within* one host, where its devices share
NVLink; ``make_pod_mesh`` lays the mesh out accordingly.

Tested for real in tests/test_multihost.py: two coordinated CPU
processes (`jax.distributed.initialize` with an explicit coordinator)
build the pod mesh, run a sharded solve chunk over the global mesh, and
assert parity with the single-process result.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX. No-ops when running single-process
    (all arguments None and no cluster env detected).

    The cluster-present decision is structural, not message-sniffed:
    when no cluster environment markers exist, any auto-detect failure
    means "single process" and is swallowed; when markers ARE present
    (a real Slurm/MPI job) every failure propagates — a
    misconfigured cluster must not silently degrade to N disconnected
    single-process replicas."""
    if coordinator_address is None and num_processes is None and process_id is None:
        import os

        cluster_markers = (
            "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS",
            "SLURM_JOB_ID",
            "OMPI_COMM_WORLD_SIZE",
        )

        in_cluster_env = any(os.environ.get(m) for m in cluster_markers)

        try:
            from jax._src import xla_bridge

            if xla_bridge.backends_are_initialized():
                # too late to initialize distributed (jax refuses after
                # backend init): in a real cluster job that's a programming
                # error worth surfacing; single-process it is a no-op
                if in_cluster_env:
                    raise RuntimeError(
                        "initialize_distributed() must run before any JAX "
                        "computation in a cluster job (the XLA backend is already "
                        "initialized)"
                    )
                return
        except ImportError:  # private module moved: fall through to try
            pass

        try:
            jax.distributed.initialize()  # cluster auto-detection (Slurm, MPI)
        except (ValueError, RuntimeError):
            if in_cluster_env:
                raise
            return  # no cluster env: single-process
    else:
        kwargs = {}
        if initialization_timeout is not None:
            kwargs["initialization_timeout"] = initialization_timeout
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )


def make_pod_mesh(n_clause: int = 1) -> Mesh:
    """Global ('traj', 'clause') mesh over every device in the job.

    The clause axis is filled from devices of the same process first so
    its psum collectives stay inside one host; the traj axis spans the rest
    (including host boundaries — fine, it never communicates inside the
    step)."""
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if len(devices) % n_clause != 0:
        raise ValueError(f"{len(devices)} devices not divisible by clause={n_clause}")
    grid = np.asarray(devices).reshape(len(devices) // n_clause, n_clause)
    return Mesh(grid, axis_names=("traj", "clause"))
