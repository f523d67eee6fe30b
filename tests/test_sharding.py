"""Mesh-sharded paths vs the single-device path on an 8-virtual-device CPU
mesh (SURVEY.md §4: "mesh-sharded trajectory batches and clause-sharded
psum RHS must produce identical results to the single-device path")."""

import os

import jax
import numpy as np
import pytest

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
from odesat_tpu.models.ode import (
    formula_device,
    init_state,
    make_chunk_runner,
    simulate_batch,
)
from odesat_tpu.parallel.mesh import make_mesh
from odesat_tpu.parallel.sharded import (
    compile_for_mesh,
    make_sharded_chunk_runner,
    shard_inputs,
)
from odesat_tpu.utils.config import ODEConfig, SolverConfig


@pytest.fixture
def requires_8():
    """The mesh tests lay 8 devices out (conftest forces 8 virtual CPU
    devices); decided when the test runs, never at import."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")


def _inputs(data_dir, config, mesh=None, batch=16):
    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    if mesh is not None:
        fa = compile_for_mesh(normalized, config, mesh)
    else:
        fa = compile_formula(normalized, clause_pad=config.clause_pad, var_pad=config.var_pad)
    key = jax.random.PRNGKey(123)
    state = init_state(fa, batch, key, config.ode)
    dev = formula_device(fa)
    return fa, state, dev


@pytest.mark.parametrize("step_kind", ["fixed", "adaptive"])
def test_traj_sharded_matches_single(data_dir, step_kind, requires_8):
    ode = ODEConfig(step_size=0.01 if step_kind == "fixed" else None, tolerance=1e-3)
    config = SolverConfig(ode=ode, chunk_steps=32)
    mesh = make_mesh(8, 1)

    fa, state, dev = _inputs(data_dir, config)
    ref_runner = make_chunk_runner(fa, 0.001, ode, 32)
    ref = ref_runner(state, dev)

    fa2, state2, dev2 = _inputs(data_dir, config, mesh=mesh)
    state2, dev2 = shard_inputs(state2, dev2, mesh)
    runner = make_sharded_chunk_runner(fa2, 0.001, ode, 32, mesh)
    out = runner(state2, dev2)

    np.testing.assert_allclose(np.asarray(ref.v), np.asarray(out.v), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ref.done), np.asarray(out.done))


@pytest.mark.parametrize("step_kind", ["fixed", "adaptive"])
def test_clause_sharded_matches_single(data_dir, step_kind, requires_8):
    ode = ODEConfig(step_size=0.01 if step_kind == "fixed" else None, tolerance=1e-3)
    config = SolverConfig(ode=ode, chunk_steps=16, clause_pad=8)
    mesh = make_mesh(2, 4)  # 2-way traj x 4-way clause

    fa, state, dev = _inputs(data_dir, config, mesh=mesh, batch=4)
    ref_runner = make_chunk_runner(fa, 0.001, ode, 16)
    # copy because runners donate their input buffers
    state_copy = jax.tree.map(lambda x: x.copy(), state)
    ref = ref_runner(state_copy, dev)

    state2, dev2 = shard_inputs(state, dev, mesh)
    runner = make_sharded_chunk_runner(fa, 0.001, ode, 16, mesh)
    out = runner(state2, dev2)

    np.testing.assert_allclose(np.asarray(ref.v), np.asarray(out.v), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ref.xs), np.asarray(out.xs), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ref.xl), np.asarray(out.xl), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(ref.done), np.asarray(out.done))


def test_simulate_batch_with_mesh_end_to_end(data_dir, requires_8):
    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    var_mapping, normalized = normalize_cnf_variables(formula)
    mesh = make_mesh(4, 2)
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=1000), batch_size=16, seed=5, chunk_steps=64
    )
    result = simulate_batch(normalized, config, mesh=mesh)
    assert result.any_solved
    from odesat_tpu.cnf import evaluate_cnf, map_values_by_indices

    mapped = map_values_by_indices(var_mapping, result.best_assignment())
    assert evaluate_cnf(mapped, formula)


def test_traj_sharded_fused_matches_single(data_dir, requires_8, interpret_kernel):
    """The fused Pallas chunk under shard_map (pure DP over 'traj') must
    match the unsharded fused kernel."""
    from odesat_tpu.ops.fused_pallas import make_fused_chunk
    from odesat_tpu.utils.generate import random_ksat
    from odesat_tpu.cnf import normalize_cnf_variables

    formula = random_ksat(30, 80, k=3, seed=9)
    _, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(ode=ODEConfig(step_size=0.02, dv_strategy="fused"))
    mesh = make_mesh(8, 1)
    fa = compile_for_mesh(normalized, config, mesh)

    state = init_state(fa, 16, jax.random.PRNGKey(11), config.ode)
    ref = make_fused_chunk(fa, 0.05, config.ode, 6)(state)

    state_sh = jax.tree.map(lambda x: x.copy(), state)
    dev = formula_device(fa)
    state_sh, dev = shard_inputs(state_sh, dev, mesh)
    runner = make_sharded_chunk_runner(fa, 0.05, config.ode, 6, mesh)
    out = runner(state_sh, dev)

    # interpret-mode Pallas under shard_map vs plain jit can reassociate
    # at the ULP level (XLA fusion differences); 6 steps accumulate to
    # ~1e-7 absolute — assert to that, not bitwise
    np.testing.assert_allclose(
        np.asarray(out.v), np.asarray(ref.v), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(out.done), np.asarray(ref.done))


def test_make_pod_mesh():
    from odesat_tpu.parallel.multihost import initialize_distributed, make_pod_mesh

    initialize_distributed()  # single-process no-op
    if len(jax.devices()) % 2 == 0:
        mesh = make_pod_mesh(n_clause=2)
        assert mesh.shape["clause"] == 2
    mesh = make_pod_mesh()
    assert mesh.shape["traj"] == len(jax.devices())


def test_make_pod_mesh_layout_and_solve():
    """Pod-mesh helper: clause axis filled from same-process devices
    (host-local psum), traj axis spans the rest; a sharded solve runs."""
    import jax

    from odesat_tpu.parallel.multihost import initialize_distributed, make_pod_mesh

    initialize_distributed()  # single-process no-op
    mesh = make_pod_mesh(n_clause=2)
    assert mesh.axis_names == ("traj", "clause")
    assert mesh.shape["traj"] * mesh.shape["clause"] == len(jax.devices())
    import pytest

    with pytest.raises(ValueError):
        make_pod_mesh(n_clause=3)  # 8 devices not divisible

    from odesat_tpu.cnf import normalize_cnf_variables
    from odesat_tpu.models.ode import simulate_batch
    from odesat_tpu.utils.config import ODEConfig, SolverConfig
    from odesat_tpu.utils.generate import random_ksat

    _, norm = normalize_cnf_variables(random_ksat(24, 72, k=3, seed=2, planted=True))
    cfg = SolverConfig(
        ode=ODEConfig(step_size=0.02, steps=512),
        batch_size=16,
        seed=0,
        chunk_steps=64,
        bucket="off",
    )
    result = simulate_batch(norm, cfg, mesh=mesh)
    assert result.assignment.shape[0] == 16


def test_sharded_explicit_kernel_unsupported_raises(data_dir, interpret_kernel):
    """An explicitly forced chunk kernel must raise on the mesh path when
    the formula can't run it instead of silently remapping to the scan
    path."""
    import pytest

    from odesat_tpu.cnf.formula import CNFFormula, Literal
    from odesat_tpu.cnf import compile_formula as _cf
    from odesat_tpu.parallel.mesh import make_mesh
    from odesat_tpu.parallel.sharded import make_sharded_chunk_runner
    from odesat_tpu.utils.config import ODEConfig

    # unit clause => kernel unsupported
    formula = CNFFormula(
        [(Literal(0, False),), (Literal(0, True), Literal(1, False))], 2
    )
    fa = _cf(formula)
    mesh = make_mesh(8, 1)
    ode = ODEConfig(step_size=0.01, dv_strategy="fused")
    with pytest.raises(ValueError, match="unit clauses"):
        make_sharded_chunk_runner(fa, 0.001, ode, 4, mesh)


def test_sharded_explicit_kernel_clause_axis_raises(data_dir):
    import pytest

    from odesat_tpu.cnf import compile_formula as _cf, normalize_cnf_variables, parse_dimacs_file
    import os as _os

    from odesat_tpu.parallel.mesh import make_mesh
    from odesat_tpu.parallel.sharded import make_sharded_chunk_runner
    from odesat_tpu.utils.config import ODEConfig

    formula = parse_dimacs_file(_os.path.join(data_dir, "hard.cnf"))
    _, normalized = normalize_cnf_variables(formula)
    fa = _cf(normalized)
    mesh = make_mesh(4, 2)
    with pytest.raises(ValueError, match="clause mesh"):
        make_sharded_chunk_runner(
            fa, 0.001, ODEConfig(step_size=0.01, dv_strategy="fused"), 4, mesh
        )


def test_stoch_sharded_matches_per_slice_runs(data_dir):
    """Trajectory-DP stoch on the mesh == running each device's slice
    single-device with that device's key (exact: both sides use the
    scan path on CPU)."""
    import jax.numpy as jnp

    from odesat_tpu.cnf import parse_dimacs_file
    from odesat_tpu.models.stoch import (
        StochState,
        init_stoch_state,
        make_stoch_chunk_runner,
    )
    from odesat_tpu.parallel.sharded import (
        make_sharded_stoch_runner,
        shard_stoch_inputs,
    )

    formula = parse_dimacs_file(os.path.join(data_dir, "hard.cnf"))
    from odesat_tpu.cnf import normalize_cnf_variables as _norm

    _, normalized = _norm(formula)
    from odesat_tpu.cnf import compile_formula as _cf

    fa = _cf(normalized)
    n_dev, per = 8, 4
    B = n_dev * per
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, n_dev)

    mesh = make_mesh(n_dev, 1)
    state = init_stoch_state(fa, B, key)
    state = StochState(state.v, state.xl, state.done, keys)
    state = shard_stoch_inputs(state, mesh)
    runner = make_sharded_stoch_runner(fa, 16, mesh)
    out = runner(state)

    single = make_stoch_chunk_runner(fa, 16, donate=False)
    for d in range(n_dev):
        st_d = init_stoch_state(fa, per, keys[d])
        ref = single(st_d)
        np.testing.assert_array_equal(
            np.asarray(out.v)[d * per : (d + 1) * per], np.asarray(ref.v)
        )
        np.testing.assert_array_equal(
            np.asarray(out.xl)[d * per : (d + 1) * per], np.asarray(ref.xl)
        )


def test_stoch_clause_sharded_matches_traj_only(data_dir):
    """The clause-sharded stoch path (weight sums psum'd over the axis,
    replicated PRNG key per traj device) must match the traj-only scan
    path chain for chain: same per-device keys => identical flips
    (round-2 VERDICT item 2). Weight sums are integer-valued, so the
    comparison is exact."""
    from odesat_tpu.cnf import compile_formula as _cf
    from odesat_tpu.cnf import normalize_cnf_variables as _norm
    from odesat_tpu.cnf import parse_dimacs_file
    from odesat_tpu.models.stoch import StochState, init_stoch_state
    from odesat_tpu.parallel.sharded import (
        make_sharded_stoch_runner,
        shard_stoch_inputs,
    )

    formula = parse_dimacs_file(os.path.join(data_dir, "hard.cnf"))
    _, normalized = _norm(formula)
    fa = _cf(normalized, clause_pad=8)
    assert fa.n_clauses_padded % 4 == 0

    key = jax.random.PRNGKey(7)
    base = init_stoch_state(fa, 8, key)
    keys = jax.random.split(key, 2)  # one per traj device, both meshes

    mesh_cl = make_mesh(2, 4)
    st1 = shard_stoch_inputs(StochState(base.v, base.xl, base.done, keys), mesh_cl)
    out1 = make_sharded_stoch_runner(fa, 12, mesh_cl)(st1)

    mesh_tr = make_mesh(2, 1, devices=jax.devices()[:2])
    st2 = shard_stoch_inputs(StochState(base.v, base.xl, base.done, keys), mesh_tr)
    out2 = make_sharded_stoch_runner(fa, 12, mesh_tr)(st2)

    np.testing.assert_array_equal(np.asarray(out1.v), np.asarray(out2.v))
    np.testing.assert_array_equal(np.asarray(out1.xl), np.asarray(out2.xl))
    np.testing.assert_array_equal(np.asarray(out1.done), np.asarray(out2.done))


def test_stoch_search_on_clause_mesh(data_dir):
    """End-to-end search() over a clause mesh solves a small instance."""
    from odesat_tpu.cnf import normalize_cnf_variables as _norm
    from odesat_tpu.cnf import parse_dimacs_file
    from odesat_tpu.models.stoch import search

    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    _, normalized = _norm(formula)
    config = SolverConfig(
        ode=ODEConfig(steps=3000), batch_size=8, seed=1, chunk_steps=64
    )
    result = search(normalized, config, mesh=make_mesh(2, 4))
    assert result.solved_index is not None
    from odesat_tpu.cnf import evaluate_cnf

    values = {i + 1: bool(b) for i, b in enumerate(result.best_assignment())}
    assert evaluate_cnf(values, normalized)


def test_hybrid_on_clause_mesh(data_dir):
    """hybrid_search accepts clause meshes: both engines race with the
    incidence sharded over the clause axis (round-2 VERDICT item 2)."""
    from odesat_tpu.cnf import normalize_cnf_variables as _norm
    from odesat_tpu.cnf import parse_dimacs_file
    from odesat_tpu.models.hybrid import hybrid_search

    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    _, normalized = _norm(formula)
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=800), batch_size=16, seed=0,
        chunk_steps=64,
    )
    result = hybrid_search(normalized, config, mesh=make_mesh(4, 2))
    assert result.solved
    assert result.engine in ("ode", "stoch")


def test_hybrid_sharded_runs(data_dir):
    from odesat_tpu.cnf import parse_dimacs_file
    from odesat_tpu.cnf import normalize_cnf_variables as _norm
    from odesat_tpu.models.hybrid import hybrid_search

    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    _, normalized = _norm(formula)
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=600), batch_size=16, seed=0,
        chunk_steps=64,
    )
    result = hybrid_search(normalized, config, mesh=make_mesh(8, 1))
    assert result.solved
    assert result.engine in ("ode", "stoch")


def test_hybrid_mesh_checkpoint_resume(data_dir, tmp_path):
    """Hybrid mesh snapshots resume on a mesh with the same trajectory
    device count (round-2 VERDICT: plain stoch already did; hybrid
    refused). A device-count mismatch and a no-mesh resume both raise."""
    import dataclasses

    import pytest

    from odesat_tpu.cnf import normalize_cnf_variables as _norm
    from odesat_tpu.cnf import parse_dimacs_file
    from odesat_tpu.models.hybrid import hybrid_search

    formula = parse_dimacs_file(os.path.join(data_dir, "hard.cnf"))
    _, normalized = _norm(formula)
    path = str(tmp_path / "hybrid_mesh.npz")
    mesh = make_mesh(8, 1)
    config = SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=64),
        batch_size=16,
        seed=3,
        chunk_steps=16,
        checkpoint_path=path,
        checkpoint_every_chunks=1,
    )
    hybrid_search(normalized, config, mesh=mesh)
    assert os.path.exists(path)

    resumed_cfg = dataclasses.replace(
        config, resume_from=path, checkpoint_path=None, checkpoint_every_chunks=0
    )
    result = hybrid_search(normalized, resumed_cfg, mesh=mesh)
    assert result.steps == 64  # budget counts from the snapshot

    half = make_mesh(4, 1, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="same --devices"):
        hybrid_search(normalized, resumed_cfg, mesh=half)
    with pytest.raises(ValueError, match="same --devices"):
        hybrid_search(normalized, resumed_cfg)


def test_shared_dt_on_traj_mesh(data_dir):
    """dt_mode='shared' under GSPMD trajectory sharding: the batch-wide
    max reduces globally, so every trajectory still carries one dt and
    it matches the unsharded shared-dt run."""
    ode = ODEConfig(tolerance=1e-3, dt_mode="shared")
    config = SolverConfig(ode=ode, chunk_steps=8)
    mesh = make_mesh(8, 1)

    fa, state, dev = _inputs(data_dir, config)
    ref = make_chunk_runner(fa, 0.001, ode, 8)(
        jax.tree.map(lambda x: x.copy(), state), dev
    )

    fa2, state2, dev2 = _inputs(data_dir, config, mesh=mesh)
    state2, dev2 = shard_inputs(state2, dev2, mesh)
    runner = make_sharded_chunk_runner(fa2, 0.001, ode, 8, mesh)
    out = runner(state2, dev2)

    # solved trajectories freeze their dt (no-advance semantics), so
    # uniformity holds among the still-active rows
    dts = np.asarray(out.dt)
    active = ~np.asarray(out.done)
    assert active.sum() > 1, "fixture must leave several active trajectories"
    assert np.allclose(dts[active], dts[active][0]), "shared dt must stay uniform"
    np.testing.assert_allclose(np.asarray(out.v), np.asarray(ref.v), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.dt), np.asarray(ref.dt), rtol=1e-6)


def test_shared_dt_on_clause_mesh(data_dir):
    """dt_mode='shared' inside shard_map with a clause axis: the error
    norm pmaxes over BOTH mesh axes."""
    ode = ODEConfig(tolerance=1e-3, dt_mode="shared", dv_strategy="segment_sum")
    config = SolverConfig(ode=ode, chunk_steps=8, clause_pad=8)
    mesh = make_mesh(2, 4)

    fa, state, dev = _inputs(data_dir, config, mesh=mesh, batch=4)
    ref = make_chunk_runner(fa, 0.001, ode, 8)(
        jax.tree.map(lambda x: x.copy(), state), dev
    )
    state2, dev2 = shard_inputs(state, dev, mesh)
    runner = make_sharded_chunk_runner(fa, 0.001, ode, 8, mesh)
    out = runner(state2, dev2)

    dts = np.asarray(out.dt)
    active = ~np.asarray(out.done)
    if active.sum() > 1:
        assert np.allclose(dts[active], dts[active][0])
    np.testing.assert_allclose(np.asarray(out.v), np.asarray(ref.v), rtol=1e-5, atol=1e-7)


def test_hybrid_clause_mesh_divisibility_precheck():
    """A caller-supplied plain FormulaArrays whose padded clause axis does
    not divide the clause mesh must fail with the same clear error as
    models/stoch.py, not a cryptic shard_map error."""
    import pytest

    from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu.models.hybrid import hybrid_search
    from odesat_tpu.parallel.mesh import make_mesh
    from odesat_tpu.utils.config import ODEConfig, SolverConfig
    from odesat_tpu.utils.generate import random_ksat

    _, normalized = normalize_cnf_variables(random_ksat(24, 97, k=3, seed=0))
    fa = compile_formula(normalized, clause_pad=4, var_pad=8)
    assert fa.n_clauses_padded % 8  # 97 -> padded 100; 100 % 8 = 4
    mesh = make_mesh(1, 8)
    config = SolverConfig(ode=ODEConfig(steps=8), batch_size=4, seed=1)
    with pytest.raises(ValueError, match="does not divide"):
        hybrid_search(fa, config, mesh=mesh)


def test_traj_mesh_device_loop_matches_host_paced(data_dir, interpret_kernel):
    """The trajectory-DP device loop (parallel/sharded.
    make_sharded_multi_runner): one dispatch runs many chunks per device
    with the stop flag pmax-reduced over the traj axis every chunk, so
    every device exits after the same chunk. Must report the same solve,
    steps, and assignments as host-paced chunking (a wall budget
    disables the loop), and build ONE shared program for two same-shaped
    formulas (planes as jit args). Fused kernel in interpret mode."""
    from odesat_tpu.cnf import normalize_cnf_variables, parse_dimacs_file
    from odesat_tpu.models.ode import simulate_batch
    from odesat_tpu.parallel import sharded as sh
    from odesat_tpu.parallel.mesh import make_mesh
    from odesat_tpu.utils.config import ODEConfig, SolverConfig

    formula = parse_dimacs_file(os.path.join(data_dir, "easy.cnf"))
    _, norm = normalize_cnf_variables(formula)
    mesh = make_mesh(8, 1)
    mk = lambda **kw: SolverConfig(  # noqa: E731
        ode=ODEConfig(step_size=0.05, steps=1024, dv_strategy="fused"),
        batch_size=16, chunk_steps=64, seed=3, **kw,
    )
    n0 = len(sh._SHARDED_PROGRAM_CACHE)
    r = simulate_batch(norm, mk(), key=jax.random.PRNGKey(3), mesh=mesh)
    r2 = simulate_batch(norm, mk(wall_clock_budget_s=1e6),
                        key=jax.random.PRNGKey(3), mesh=mesh)
    assert r.any_solved and r2.any_solved
    assert r.steps == r2.steps
    np.testing.assert_array_equal(r.assignment, r2.assignment)
    grew = len(sh._SHARDED_PROGRAM_CACHE) - n0
    assert grew >= 1  # the dp_multi program landed in the shared cache

    # a second same-shaped formula must NOT add programs (hard.cnf has
    # the same padded shape as easy.cnf: both aim-100-1_6)
    formula2 = parse_dimacs_file(os.path.join(data_dir, "hard.cnf"))
    _, norm2 = normalize_cnf_variables(formula2)
    n1 = len(sh._SHARDED_PROGRAM_CACHE)
    r3 = simulate_batch(norm2, mk(), key=jax.random.PRNGKey(3), mesh=mesh)
    assert len(sh._SHARDED_PROGRAM_CACHE) == n1
    assert not r3.any_solved and r3.steps == 1024  # UNSAT: full budget


def test_traj_mesh_device_loop_adaptive(data_dir, interpret_kernel):
    """The mesh device loop composes with the ADAPTIVE fused core too
    (two RHS passes + per-trajectory dt inside the kernel, error norm in
    the carry): parity with host-paced chunking on the same mesh."""
    from odesat_tpu.cnf import normalize_cnf_variables, parse_dimacs_file
    from odesat_tpu.models.ode import simulate_batch
    from odesat_tpu.parallel.mesh import make_mesh
    from odesat_tpu.utils.config import ODEConfig, SolverConfig

    formula = parse_dimacs_file(os.path.join(data_dir, "easy.cnf"))
    _, norm = normalize_cnf_variables(formula)
    mesh = make_mesh(8, 1)
    mk = lambda **kw: SolverConfig(  # noqa: E731
        ode=ODEConfig(tolerance=1e-3, steps=1024, dv_strategy="fused"),
        batch_size=16, chunk_steps=64, seed=4, **kw,
    )
    r = simulate_batch(norm, mk(), key=jax.random.PRNGKey(4), mesh=mesh)
    r2 = simulate_batch(norm, mk(wall_clock_budget_s=1e6),
                        key=jax.random.PRNGKey(4), mesh=mesh)
    assert r.any_solved == r2.any_solved
    assert r.steps == r2.steps
    np.testing.assert_array_equal(r.assignment, r2.assignment)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize(
    "family,mesh_shape",
    [
        ("uniform", (1, 8)),
        ("uniform", (2, 4)),
        ("uniform", (4, 2)),
        ("mixed_widths", (2, 4)),
        ("locality", (4, 2)),
    ],
)
def test_clause_mesh_scan_psum_matches_single(family, mesh_shape, mode, requires_8):
    """The clause mesh runs the scan step under shard_map with dv
    psum'd across the clause devices (XLA hands the psum to NCCL on
    GPUs). Against one device from the same state: the psum adds the
    shards' partial sums in another order, so agreement is to f32
    rounding grown over 12 steps (~3e-6 measured in adaptive mode), not
    bitwise."""
    from odesat_tpu.utils.generate import random_ksat, random_local_ksat
    from tests.conftest import random_formula

    if family == "uniform":
        formula = random_ksat(64, 256, k=3, seed=3)
    elif family == "mixed_widths":
        formula = random_formula(np.random.default_rng(4), 48, 200, max_width=4, min_width=2)
    else:
        formula = random_local_ksat(256, 1000, k=3, locality=32, seed=5)
    _, normalized = normalize_cnf_variables(formula)
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None, tolerance=1e-3)
    config = SolverConfig(ode=ode, clause_pad=16)
    mesh = make_mesh(*mesh_shape)
    fa = compile_for_mesh(normalized, config, mesh)
    assert fa.n_clauses_padded % mesh_shape[1] == 0
    state = init_state(fa, 8 * mesh_shape[0], jax.random.PRNGKey(7), ode)
    dev = formula_device(fa)
    ref = make_chunk_runner(fa, 0.01, ode, 12, donate=False)(state, dev)
    st, dv = shard_inputs(jax.tree.map(lambda x: x.copy(), state), dev, mesh)
    out = make_sharded_chunk_runner(fa, 0.01, ode, 12, mesh)(st, dv)
    for name in ("v", "xs", "xl", "dt"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)), rtol=1e-5, atol=2e-5
        )
    np.testing.assert_array_equal(np.asarray(out.done), np.asarray(ref.done))
