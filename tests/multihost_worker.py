"""Worker for tests/test_multihost.py: one of two coordinated CPU
processes. Initializes distributed JAX, builds the pod mesh, runs a
scenario over the GLOBAL mesh, and checks the result against a
locally-computed reference.

argv: coordinator_address num_processes process_id [scenario]

Scenarios (every mesh path crosses a real process boundary):

* ``basic``    — fixed-step ODE, trajectory DP over the pod (round 1).
* ``clause``   — ``make_pod_mesh(n_clause=2)``: asserts clause groups
  never cross a process boundary (the make_pod_mesh claim), then runs
  the clause-sharded scan step with the fixed integrator and the dv psum
  inside each process.
* ``adaptive`` — the adaptive integrator with ``dt_mode='shared'``: the
  batch-max error pmax reduces over the trajectory axis ACROSS the
  process boundary; parity against a single-process shared-dt run.
* ``stoch``    — a clause-sharded stochastic chunk over the pod mesh
  (weight-sum psums within process, chains spanning processes); parity
  against per-device local scan chains with the same keys.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
from jax.sharding import NamedSharding

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
from odesat_tpu.models.ode import formula_device, init_state, make_chunk_runner
from odesat_tpu.parallel.dist import fetch as _allgather
from odesat_tpu.parallel.dist import put_global as to_global
from odesat_tpu.parallel.multihost import initialize_distributed, make_pod_mesh
from odesat_tpu.parallel.sharded import (
    DEV_SPECS,
    STATE_SPECS,
    compile_for_mesh,
    make_sharded_chunk_runner,
)
from odesat_tpu.utils.config import ODEConfig, SolverConfig

HERE = os.path.dirname(os.path.abspath(__file__))


def _formula():
    formula = parse_dimacs_file(os.path.join(HERE, "data", "hard.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    return normalized


def scenario_basic(mesh_unused):
    normalized = _formula()
    mesh = make_pod_mesh()  # traj axis over every device in the job
    fa = compile_formula(normalized)
    ode = ODEConfig(step_size=0.01)
    B = 2 * len(jax.devices())

    state = init_state(fa, B, jax.random.PRNGKey(0), ode)
    dev = formula_device(fa)
    ref = make_chunk_runner(fa, 0.001, ode, 8)(
        jax.tree.map(lambda x: x.copy(), state), dev
    )
    ref_v = np.asarray(ref.v)

    gstate = jax.tree.map(
        lambda x, s: to_global(x, NamedSharding(mesh, s)), state, STATE_SPECS
    )
    gdev = jax.tree.map(
        lambda x, s: to_global(x, NamedSharding(mesh, s)), dev, DEV_SPECS
    )
    out = make_sharded_chunk_runner(fa, 0.001, ode, 8, mesh)(gstate, gdev)
    np.testing.assert_allclose(_allgather(out.v), ref_v, rtol=1e-6, atol=1e-7)


def scenario_clause(nproc):
    normalized = _formula()
    mesh = make_pod_mesh(n_clause=2)
    # the multihost.py claim: clause groups fill same-process devices
    # first, so their psums never cross a process boundary
    for row in mesh.devices:
        procs = {d.process_index for d in row}
        assert len(procs) == 1, f"clause group spans processes: {procs}"

    config = SolverConfig(ode=ODEConfig(step_size=0.01))
    fa = compile_for_mesh(normalized, config, mesh)
    assert fa.n_clauses_padded % 2 == 0
    ode = config.ode
    B = 2 * mesh.shape["traj"]
    state = init_state(fa, B, jax.random.PRNGKey(1), ode)
    dev = formula_device(fa)

    # reference: single-device scan path on the same arrays
    ode_scan = ODEConfig(step_size=0.01, dv_strategy="segment_sum")
    ref = make_chunk_runner(fa, 0.001, ode_scan, 4)(
        jax.tree.map(lambda x: x.copy(), state), dev
    )

    gstate = jax.tree.map(
        lambda x, s: to_global(x, NamedSharding(mesh, s)), state, STATE_SPECS
    )
    gdev = jax.tree.map(
        lambda x, s: to_global(x, NamedSharding(mesh, s)), dev, DEV_SPECS
    )
    out = make_sharded_chunk_runner(fa, 0.001, ode, 4, mesh)(gstate, gdev)
    np.testing.assert_allclose(
        _allgather(out.v), np.asarray(ref.v), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        _allgather(out.xs), np.asarray(ref.xs), rtol=2e-4, atol=2e-5
    )


def scenario_adaptive(nproc):
    normalized = _formula()
    mesh = make_pod_mesh()
    ode = ODEConfig(tolerance=1e-3, dt_mode="shared")
    fa = compile_formula(normalized)
    B = 2 * len(jax.devices())
    state = init_state(fa, B, jax.random.PRNGKey(2), ode)
    dev = formula_device(fa)

    # single-process shared-dt reference: the global batch-max error on
    # one device must equal the pod's cross-process pmax chain
    ref = make_chunk_runner(fa, 0.001, ode, 6)(
        jax.tree.map(lambda x: x.copy(), state), dev
    )

    gstate = jax.tree.map(
        lambda x, s: to_global(x, NamedSharding(mesh, s)), state, STATE_SPECS
    )
    gdev = jax.tree.map(
        lambda x, s: to_global(x, NamedSharding(mesh, s)), dev, DEV_SPECS
    )
    out = make_sharded_chunk_runner(fa, 0.001, ode, 6, mesh)(gstate, gdev)
    np.testing.assert_allclose(_allgather(out.v), np.asarray(ref.v), rtol=1e-6)
    np.testing.assert_allclose(_allgather(out.dt), np.asarray(ref.dt), rtol=1e-6)
    dts = _allgather(out.dt)
    active = ~_allgather(out.done)
    if active.sum() > 1:
        assert np.allclose(dts[active], dts[active][0]), "shared dt must stay uniform"


def scenario_stoch(nproc):
    from odesat_tpu.models.stoch import StochState, init_stoch_state, make_stoch_chunk_runner
    from odesat_tpu.parallel.sharded import make_sharded_stoch_runner

    normalized = _formula()
    mesh = make_pod_mesh(n_clause=2)
    n_traj = mesh.shape["traj"]
    fa = compile_formula(normalized, clause_pad=8)
    assert fa.n_clauses_padded % 2 == 0
    B = 2 * n_traj
    key = jax.random.PRNGKey(3)
    base = init_stoch_state(fa, B, key)
    keys = jax.random.split(key, n_traj)

    # local reference: each traj device's chains are an independent scan
    # stream seeded with that device's key
    per = B // n_traj
    inner = make_stoch_chunk_runner(fa, 10, donate=False)
    ref_v, ref_done = [], []
    for d in range(n_traj):
        sl = slice(d * per, (d + 1) * per)
        out_d = inner(StochState(base.v[sl], base.xl[sl], base.done[sl], keys[d]))
        ref_v.append(np.asarray(out_d.v))
        ref_done.append(np.asarray(out_d.done))

    specs = StochState(
        v=jax.sharding.PartitionSpec("traj"),
        xl=jax.sharding.PartitionSpec("traj", "clause"),
        done=jax.sharding.PartitionSpec("traj"),
        key=jax.sharding.PartitionSpec("traj"),
    )
    gstate = jax.tree.map(
        lambda x, s: to_global(x, NamedSharding(mesh, s)),
        StochState(base.v, base.xl, base.done, keys),
        specs,
    )
    out = make_sharded_stoch_runner(fa, 10, mesh)(gstate)
    np.testing.assert_array_equal(_allgather(out.v), np.concatenate(ref_v))
    np.testing.assert_array_equal(_allgather(out.done), np.concatenate(ref_done))


SCENARIOS = {
    "basic": scenario_basic,
    "clause": scenario_clause,
    "adaptive": scenario_adaptive,
    "stoch": scenario_stoch,
}


def main():
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    scenario = sys.argv[4] if len(sys.argv) > 4 else "basic"
    initialize_distributed(coordinator_address=coord, num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    n_dev = len(jax.devices())
    assert n_dev == 4 * nproc, n_dev
    SCENARIOS[scenario](nproc)
    print(f"MULTIHOST_OK pid={pid} scenario={scenario}", flush=True)


if __name__ == "__main__":
    main()
