"""Multi-device execution: mesh construction, trajectory-sharded solves
(data parallelism), and clause-sharded RHS evaluation (model parallelism
with a psum across devices). No reference counterpart exists — the reference is
single-threaded (SURVEY.md §2b)."""

from odesat_tpu.parallel.mesh import make_mesh, replicated, traj_sharding
from odesat_tpu.parallel.multihost import initialize_distributed, make_pod_mesh
from odesat_tpu.parallel.sharded import (
    compile_for_mesh,
    make_sharded_chunk_runner,
    make_sharded_stoch_runner,
    shard_state,
    simulate_batch_sharded,
)

__all__ = [
    "compile_for_mesh",
    "initialize_distributed",
    "make_mesh",
    "make_pod_mesh",
    "make_sharded_chunk_runner",
    "make_sharded_stoch_runner",
    "replicated",
    "shard_state",
    "simulate_batch_sharded",
    "traj_sharding",
]
