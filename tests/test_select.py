"""The one path chooser (ops/select.py) and the fused kernel's wrapper
arithmetic: block and tile choice, plane construction, eligibility."""

import numpy as np
import pytest

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables
from odesat_tpu.cnf.formula import CNFFormula, Literal
from odesat_tpu.ops import fused_pallas, select
from odesat_tpu.utils.config import ODEConfig
from odesat_tpu.utils.generate import random_ksat


def _fa(n=30, m=80, seed=0, **kw):
    _, normalized = normalize_cnf_variables(random_ksat(n, m, k=3, seed=seed))
    return compile_formula(normalized, **kw)


def _unit_fa():
    return compile_formula(CNFFormula([(Literal(0),), (Literal(0, True), Literal(1))], 2))


def _wide_occ_fa():
    # variable 0 in 40 clauses: max_occ > 32 -> segment_sum
    clauses = [(Literal(0), Literal(i + 1)) for i in range(40)]
    return compile_formula(CNFFormula(clauses, 41))


@pytest.mark.parametrize(
    "gpu,strategy,fa_kind,ode_kw,expected",
    [
        (True, "auto", "plain", {}, "fused"),
        (True, "auto", "plain", {"matmul_dtype": "bfloat16"}, "fused"),
        (True, "auto", "plain", {"dtype": "float64"}, "gather"),
        (True, "auto", "plain", {"dt_mode": "shared"}, "gather"),
        (True, "auto", "plain", {"dt_mode": "shared", "step_size": 0.01}, "fused"),
        (True, "auto", "unit", {}, "gather"),
        (True, "auto", "wide", {"dtype": "float64"}, "segment_sum"),
        (False, "auto", "plain", {}, "gather"),
        (False, "auto", "wide", {}, "segment_sum"),
        (True, "fused", "plain", {}, "fused"),
        (False, "gather", "plain", {}, "gather"),
        (True, "segment_sum", "plain", {}, "segment_sum"),
        (True, "onehot", "plain", {}, "onehot"),
    ],
)
def test_resolve_strategy(monkeypatch, gpu, strategy, fa_kind, ode_kw, expected):
    monkeypatch.setattr(select, "gpu_available", lambda: gpu)
    fa = {"plain": _fa, "unit": _unit_fa, "wide": _wide_occ_fa}[fa_kind]()
    ode = ODEConfig(dv_strategy=strategy, **ode_kw)
    assert select.resolve_strategy(fa, ode) == expected


@pytest.mark.parametrize("gpu", [True, False])
def test_auto_on_a_clause_mesh_takes_the_scan_path(monkeypatch, gpu):
    monkeypatch.setattr(select, "gpu_available", lambda: gpu)
    assert select.resolve_strategy(_fa(), ODEConfig(), clause_sharded=True) == "gather"


@pytest.mark.parametrize(
    "gpu,clause_sharded,match",
    [(False, False, "no GPU"), (True, True, "clause mesh"), (False, True, "clause mesh")],
)
def test_explicit_fused_refusals(monkeypatch, gpu, clause_sharded, match):
    monkeypatch.setattr(select, "gpu_available", lambda: gpu)
    with pytest.raises(ValueError, match=match):
        select.resolve_strategy(_fa(), ODEConfig(dv_strategy="fused"), clause_sharded=clause_sharded)


@pytest.mark.parametrize("bad", ["stream", "pallas", "fast"])
def test_unknown_strategy_raises(bad):
    with pytest.raises(ValueError, match="unknown dv_strategy"):
        select.resolve_strategy(_fa(), ODEConfig(dv_strategy=bad))


def test_gpu_available_is_false_on_the_test_host():
    assert select.gpu_available() is False


@pytest.mark.parametrize(
    "Mp,expected", [(128, 32), (256, 32), (1152, 32), (48, 16), (24, 0), (8, 0)]
)
def test_clause_tile(Mp, expected):
    assert fused_pallas.clause_tile(Mp) == expected


@pytest.mark.parametrize(
    "batch,np2,parts,expected",
    [
        (16384, 128, 3, 16),  # hard.cnf f32: 1024 programs
        (16384, 128, 1, 32),  # hard.cnf bf16: 512 programs
        (4096, 256, 1, 16),  # uf250: 256 programs (32 rows would give 128 < 132 SMs)
        (4096, 128, 1, 16),
        (100, 128, 1, 32),
        (5, 128, 3, 16),  # Triton's dot needs 16 rows
        (16384, 16, 1, 64),  # narrow formulas cap at 64 rows
    ],
)
def test_traj_block(batch, np2, parts, expected):
    bb = fused_pallas.traj_block(batch, np2, parts)
    assert bb == expected
    assert bb & (bb - 1) == 0 and bb >= 16


def test_traj_block_fills_the_card_at_uf250_width_in_f32():
    assert fused_pallas.traj_block(16384, 256, 3) == 16


def test_build_planes_reproduce_clause_values():
    """v @ G_k + bias_k is 1 - q v at each real literal slot and 1 + BIG
    at padding slots."""
    fa = _fa(20, 50, seed=3, bucket=False)
    K, Mp = fa.lit_var.shape
    G, bias, cmask = fused_pallas.build_planes(fa, 32)
    assert G.shape == (32, K * Mp) and set(np.unique(G)) <= {-1.0, 0.0, 1.0}
    v = np.random.default_rng(0).uniform(-1, 1, size=32).astype(np.float32)
    v[fa.n_vars_padded:] = 0.0
    vals = v @ G + bias
    for k in range(K):
        on = fa.lit_mask[k] > 0
        want = 1.0 - fa.sign[k] * v[fa.lit_var[k]]
        np.testing.assert_allclose(vals[k * Mp : (k + 1) * Mp][on], want[on], rtol=0, atol=1e-7)
        assert (vals[k * Mp : (k + 1) * Mp][~on] > 1e8).all()
    np.testing.assert_array_equal(cmask, fa.clause_mask)


@pytest.mark.parametrize(
    "kind,expected", [("plain", True), ("unit", False), ("odd_clause_pad", False), ("huge", False)]
)
def test_fused_supported(kind, expected):
    if kind == "plain":
        fa = _fa()
    elif kind == "unit":
        fa = _unit_fa()
    elif kind == "odd_clause_pad":
        fa = _fa(m=84, clause_pad=8)  # Mp=88: no power-of-two tile >= 16 divides it
    else:
        fa = _fa(4000, 17000, seed=1)  # bf16 plane 4096 * 3 * 17024 * 2 B > 8 MB
    assert fused_pallas.fused_supported(fa) is expected
