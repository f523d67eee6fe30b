"""The memcomputing ODE right-hand side as one fused XLA computation.

Batched redesign of the reference's per-clause scalar loop
(reference: src/system.rs:25-91). The reference walks each clause's
literal list with a scratch slab tracking min / second-min; here the same
math is expressed as dense masked array ops over the padded ``(K, M)``
incidence layout so XLA fuses the whole RHS into a handful of
vector-unit passes, and the per-variable accumulation of clause
contributions becomes a gather+sum (or one-hot matmul) instead of a
scatter.

Per clause m with literals (q_i, v_i):
  value_i = 1 - q_i * v_i                     (src/system.rs:49)
  C_m     = 0.5 * min_i value_i               (src/system.rs:60)
  g_{m,i} = 0.5 * q_i * min_{j != argmin} …   (src/system.rs:62-70: the
            min over the *other* literals == second_min at the argmin,
            min elsewhere)
  r_{m,i} = 0.5 * (q_i - v_i) gated           (src/system.rs:73-77; see
            rigidity note below)
  dv_i   += xl_m*xs_m*g_{m,i} + (1+zeta*xl_m)*(1-xs_m)*r_{m,i}   (:80)
  dxs_m   = BETA*(xs_m+EPS)*(C_m-GAMMA)       (:84)
  dxl_m   = ALPHA*(C_m-DELTA)                 (:85)
  allsat  = AND_m (C_m < GAMMA)               (:88-90)

Rigidity gate: the reference compares ``C_m == (1 - q_i v_i)`` with exact
float equality, which can only hold when the clause is exactly satisfied
at a corner, so its rigidity term is almost always zero (SURVEY.md §2a).
``rigidity="paper"`` implements the paper's argmin condition
(``value_i == min``); ``rigidity="reference"`` reproduces the reference
gate bit-for-bit in spirit (``value_i == 0.5*min``, i.e. both zero).

Tie semantics match the reference's running min/second-min scan: removing
one instance of the min leaves second_min == min for duplicated minima,
and every literal whose value equals the min receives second_min.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from odesat_tpu.constants import ALPHA, BETA, DELTA, EPSILON, GAMMA

# Masked-literal sentinel. Must be +inf, not a large finite number: the
# reference's second-min for a unit clause is f64::INFINITY, so a unit
# clause's own literal receives an *infinite* gradient g = 0.5*q*inf
# (src/system.rs:43-70) which the clamped Euler update then saturates to
# the corner. Padding slots are where-masked (never multiplied) so the
# inf cannot produce NaN.
_BIG = float("inf")


def clause_values(v, lit_var, sign, lit_mask):
    """Per-literal satisfaction degree ``1 - q_i v_i``; padded slots get a
    large sentinel so they never win the min. Shapes: v (..., N),
    lit_var/sign/lit_mask (K, M) -> (..., K, M)."""
    gathered = v[..., lit_var]  # (..., K, M)
    vals = 1.0 - sign * gathered
    return jnp.where(lit_mask > 0, vals, _BIG), gathered


def top2_min(vals):
    """Row-wise (min, second-min-after-removing-one-instance) over the
    literal axis (axis=-2), matching the reference's scan semantics
    (src/system.rs:50-55): duplicated minima leave second_min == min."""
    min1 = jnp.min(vals, axis=-2, keepdims=True)  # (..., 1, M)
    amin = jnp.argmin(vals, axis=-2, keepdims=True)  # first occurrence
    k_idx = jax.lax.broadcasted_iota(jnp.int32, vals.shape, vals.ndim - 2)
    vals_wo = jnp.where(k_idx == amin, _BIG, vals)
    min2 = jnp.min(vals_wo, axis=-2, keepdims=True)
    return min1, min2


def accumulate_dv_gather(contrib_flat, var_occ, occ_mask):
    """dv via variable-major gather+sum: contrib_flat (..., K*M),
    var_occ/occ_mask (N, D) -> (..., N). Deterministic: no atomics."""
    picked = contrib_flat[..., var_occ]  # (..., N, D)
    return jnp.sum(picked * occ_mask, axis=-1)


def accumulate_dv_segment(contrib_flat, lit_var_flat, n_vars_padded):
    """dv via segment-sum (scatter-add); correctness baseline."""
    seg = partial(jax.ops.segment_sum, segment_ids=lit_var_flat, num_segments=n_vars_padded)
    if contrib_flat.ndim == 1:
        return seg(contrib_flat)
    return jax.vmap(seg)(contrib_flat.reshape(-1, contrib_flat.shape[-1])).reshape(
        *contrib_flat.shape[:-1], n_vars_padded
    )


def accumulate_dv_onehot(contrib_flat, onehot):
    """dv via matmul against the constant one-hot incidence matrix
    (K*M, N). Wastes flops but rides the matrix units; for small N."""
    return jnp.dot(
        contrib_flat,
        onehot,
        preferred_element_type=contrib_flat.dtype,
        # true f32: a default-precision f32 matmul may run in TF32 on a
        # GPU, breaking parity with the gather/segment_sum strategies
        precision=jax.lax.Precision.HIGHEST,
    )


def _clause_terms(v, xs, xl, lit_var, sign, lit_mask, clause_mask, zeta, rigidity):
    """Per-clause math for one width bucket: returns (c, contrib_flat)
    where contrib_flat is the flattened (..., K*M) per-literal dv
    contribution in row-major (k, m) order."""
    vals, gathered = clause_values(v, lit_var, sign, lit_mask)  # (..., K, M)
    min1, min2 = top2_min(vals)
    c = 0.5 * jnp.squeeze(min1, axis=-2)  # (..., M)
    c = jnp.where(clause_mask > 0, c, 0.0)

    lit_on = lit_mask > 0
    is_min = vals <= min1  # exact: min1 is one of the vals
    # where-masked (not multiplied): g can be +-inf for a unit clause's
    # own literal and 0*inf would poison padding with NaN
    g = jnp.where(lit_on, 0.5 * sign * jnp.where(is_min, min2, min1), 0.0)

    if rigidity == "paper":
        r_gate = is_min
    elif rigidity == "reference":
        # C_m == value_i  <=>  0.5*min == value_i; exact-equality gate
        # faithful to src/system.rs:73.
        r_gate = vals == (0.5 * min1)
    else:
        raise ValueError(f"unknown rigidity mode: {rigidity!r}")
    r = jnp.where(r_gate & lit_on, 0.5 * (sign - gathered), 0.0)

    xs_b = xs[..., None, :]  # (..., 1, M)
    xl_b = xl[..., None, :]
    contrib = jnp.where(
        lit_on, xl_b * xs_b * g + (1.0 + zeta * xl_b) * (1.0 - xs_b) * r, 0.0
    )
    K, M = lit_var.shape
    return c, contrib.reshape(*contrib.shape[:-2], K * M)


def compute_derivatives(
    v,
    xs,
    xl,
    *,
    lit_var,
    sign,
    lit_mask,
    clause_mask,
    var_occ,
    occ_mask,
    zeta,
    rigidity: str = "paper",
    dv_strategy: str = "gather",
    onehot=None,
    bucket_slices=None,
):
    """One RHS evaluation. Batched via vmap over the leading axis of
    (v, xs, xl). Returns (dv, dxs, dxl, allsat).

    v: (..., N) variable values; xs, xl: (..., M) clause memories.

    ``bucket_slices``: static tuple of (m0, m1, K_b) width buckets over a
    clause axis pre-sorted by width (cnf/arrays.py). Each bucket's clause
    math runs at its own literal width K_b, so mixed-width formulas (VE
    resolvents) don't pay the max width on every clause. None = one
    bucket at full width. ``var_occ`` must index the matching flattened
    contribution layout (the compiler builds both consistently).
    """
    K, M = lit_var.shape
    if bucket_slices is None:
        bucket_slices = ((0, M, K),)

    c_parts = []
    contrib_parts = []
    seg_parts = []
    for m0, m1, Kb in bucket_slices:
        c_b, contrib_b = _clause_terms(
            v,
            xs[..., m0:m1],
            xl[..., m0:m1],
            lit_var[:Kb, m0:m1],
            sign[:Kb, m0:m1],
            lit_mask[:Kb, m0:m1],
            clause_mask[m0:m1],
            zeta,
            rigidity,
        )
        c_parts.append(c_b)
        contrib_parts.append(contrib_b)
        seg_parts.append(lit_var[:Kb, m0:m1].reshape(-1))

    c = c_parts[0] if len(c_parts) == 1 else jnp.concatenate(c_parts, axis=-1)
    contrib_flat = (
        contrib_parts[0]
        if len(contrib_parts) == 1
        else jnp.concatenate(contrib_parts, axis=-1)
    )

    if dv_strategy == "gather":
        dv = accumulate_dv_gather(contrib_flat, var_occ, occ_mask)
    elif dv_strategy == "segment_sum":
        seg_ids = seg_parts[0] if len(seg_parts) == 1 else jnp.concatenate(seg_parts)
        dv = accumulate_dv_segment(contrib_flat, seg_ids, v.shape[-1])
    elif dv_strategy == "onehot":
        if onehot is None:
            raise ValueError("dv_strategy='onehot' requires the onehot incidence matrix")
        if len(bucket_slices) > 1:
            raise ValueError("dv_strategy='onehot' does not support width buckets")
        dv = accumulate_dv_onehot(contrib_flat, onehot)
    else:
        raise ValueError(f"unknown dv_strategy: {dv_strategy!r}")

    dxs = BETA * (xs + EPSILON) * (c - GAMMA) * clause_mask
    dxl = ALPHA * (c - DELTA) * clause_mask
    allsat = jnp.all((c < GAMMA) | (clause_mask <= 0), axis=-1)
    return dv, dxs, dxl, allsat


def build_onehot(lit_var, lit_mask, n_vars_padded, dtype=jnp.float32):
    """Constant (K*M, N) one-hot incidence matrix for the onehot strategy."""
    flat_var = lit_var.reshape(-1)
    flat_mask = lit_mask.reshape(-1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (flat_var.shape[0], n_vars_padded), 1)
    return ((cols == flat_var[:, None]) & (flat_mask[:, None] > 0)).astype(dtype)
