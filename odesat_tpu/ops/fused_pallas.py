"""Multi-step fused ODE chunk kernel for NVIDIA Hopper (Pallas, Triton route).

The XLA scan path (models/ode.py over ops/rhs.py) writes the trajectory
state and the (B, K, M) step intermediates to device memory on every
step, and XLA cannot fuse across ``lax.scan`` iterations. This kernel
runs ``chunk_steps`` whole Euler steps per launch instead:

* **Grid**: one program per block of ``Bb`` trajectories (16-64 rows,
  chosen so a large batch fills every SM).
* **Chunk loop inside the kernel**: ``v``, ``dt`` and ``done`` of the
  block stay in registers for the whole chunk.
* **Clause tiles**: within a step the clause axis is walked in tiles of
  ``TM`` clauses. Per tile and literal slot k, a forward ``pl.dot`` of
  ``v`` against the tile's slice of the sign-baked plane ``G_k`` gives
  the literal values ``1 - q_i v_i`` directly; the top-2-min and the
  clause terms follow on the tile; a transposed ``pl.dot`` against the
  same slice adds the tile's share into ``dv``. The tile's clause
  memories ``xs``/``xl`` are read and written in device memory (the
  block's rows stay L2-resident); the planes are read through L2.
* **Precision**: the plane holds only -1, 0 and +1, which bf16 stores
  exactly, so every dot runs on bf16 tensor cores with f32
  accumulation. f32 mode splits each f32 operand into three bf16 parts
  (hi + mid + lo carry all 24 significand bits) and sums three dots:
  each product with the plane is exact, so the forward pass reproduces
  ``1 - q_i v_i`` exactly and dv differs from an IEEE f32 dot only in
  summation order. No TF32 anywhere. bf16 mode passes one bf16 part,
  rounding ``v`` and the contributions to 8 significand bits.

Plane k holds ``-q_i`` at the literal's variable row, so
``v @ G_k + bias`` is the clause value (bias 1, or 1 + BIG at padding
slots, which then lose every min) and the same plane scatters dv through
the identity ``r = q_i * value_i / 2`` (``q_i^2 = 1``,
reference: src/system.rs:73-77), with -1/2 folded into the per-clause
coefficients.

Freeze semantics match the scan path: fixed mode updates on the
detecting step and then freezes (src/system.rs:141-154); adaptive mode
never advances a satisfied state (src/system.rs:122) and clips dt into
[2^-7, 1e3] (src/system.rs:132-135). The adaptive step makes two passes
over the tiles: the first evaluates the RHS at the current state and
keeps each tile's clause value ``c`` in a scratch output; the second
rebuilds the half step from it, evaluates the RHS at the half step, and
writes the accepted state.

Applicability (``fused_supported``): no unit clauses (their infinite
gradients would meet the plane's zeros), f32 state, a bf16 plane of at
most 8 MB (aim/uf250-class formulas; larger formulas run the scan path),
and a padded clause axis divisible by a power-of-two tile of 16 or 32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from odesat_tpu.cnf.arrays import FormulaArrays
from odesat_tpu.constants import (
    ALPHA,
    BETA,
    DELTA,
    DT_MAX,
    DT_MIN,
    EPSILON,
    GAMMA,
    XL_CAP_PER_CLAUSE,
)
from odesat_tpu.ops.kernelctx import pallas_call_32bit, wrap_chunk_runner

_BIG = 1.0e9  # padding-slot clause value: loses every min, finite (0 * inf = NaN in a dot)
_PLANE_LIMIT = 8 * 1024 * 1024  # bytes of sign-baked plane the kernel reads per step
_BLOCK_ELEMS = 4096  # Bb * padded variables * bf16 parts per (Bb, Np) operand
_MIN_ROWS = 16  # Triton's dot needs at least 16 rows and columns
_FILL_PROGRAMS = 132  # SMs on one H100: large batches get at least this many programs
# clause tile and warps per program: the fastest of tiles 16/32 and 4/8
# warps on an H100 at hard.cnf and uf250 widths (chip_smoke.py cells);
# 128-clause f32 tiles overflowed shared memory
_TILE = 32
_NUM_WARPS = 4
_JIT_CACHE = {}  # static shape signature -> jitted kernel (see make_fused_chunk)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def clause_tile(Mp: int) -> int:
    """Largest power-of-two tile of at most ``_TILE`` clauses dividing
    the padded clause axis (0 when none of at least 16 does)."""
    t = _TILE
    while t >= _MIN_ROWS:
        if Mp % t == 0:
            return t
        t //= 2
    return 0


def fused_supported(fa: FormulaArrays) -> bool:
    """Build-free eligibility of a formula for the kernel."""
    K, Mp = fa.lit_var.shape
    return (
        fa.min_width >= 2
        and clause_tile(Mp) > 0
        and _next_pow2(fa.n_vars_padded) * K * Mp * 2 <= _PLANE_LIMIT
    )


def traj_block(batch: int, n_vars_pow2: int, parts: int = 1) -> int:
    """Rows per program: at most ``_BLOCK_ELEMS / (Np * parts)``
    (registers; f32 mode holds three bf16 parts of each dot operand), at
    least 16 (Triton's dot), and small enough that a batch of at least
    ``_FILL_PROGRAMS * 16`` rows launches ``_FILL_PROGRAMS`` programs.
    On an H100 at hard.cnf width this picks 16 rows in f32 mode and 32
    in bf16 mode, the fastest of 16/32/64 for each."""
    bb = max(_MIN_ROWS, min(64, _next_pow2(_BLOCK_ELEMS // (n_vars_pow2 * parts) + 1) // 2))
    while bb > _MIN_ROWS and batch >= _FILL_PROGRAMS * _MIN_ROWS and -(-batch // bb) < _FILL_PROGRAMS:
        bb //= 2
    while bb > _MIN_ROWS and bb >= 2 * batch:
        bb //= 2
    return bb


def build_planes(fa: FormulaArrays, n_vars_pow2: int):
    """Sign-baked planes (Np2, K*Mp), per-slot bias (K*Mp,) and clause
    mask (Mp,), as host arrays."""
    K, Mp = fa.lit_var.shape
    G = np.zeros((n_vars_pow2, K * Mp), dtype=np.float32)
    bias = np.full((K * Mp,), 1.0 + _BIG, dtype=np.float32)
    cols = np.arange(Mp)
    for k in range(K):
        on = fa.lit_mask[k] > 0
        G[fa.lit_var[k][on], k * Mp + cols[on]] = -fa.sign[k][on]
        bias[k * Mp + cols[on]] = 1.0
    return G, bias, fa.clause_mask.astype(np.float32)


def make_fused_chunk(
    fa: FormulaArrays,
    zeta: float,
    ode,
    chunk_steps: int,
    interpret: bool = False,
    donate: bool = False,
):
    """Build ``fn(state: ODEState, dev) -> ODEState`` advancing every
    trajectory ``chunk_steps`` steps in one kernel launch. ``dev`` is
    accepted for signature parity with the scan runner and ignored.

    The planes ride as jit *arguments* and the jitted kernel is cached on
    the formula's static shape signature, so same-shaped instances share
    one compiled program (ops/kernelctx.wrap_chunk_runner).
    ``interpret=True`` runs the kernel in the Pallas interpreter; only
    tests ask for it."""
    from odesat_tpu.ops.select import require_gpu

    if getattr(ode, "dtype", "float32") == "float64":
        # the kernel carries f32 state; silently downcasting a requested
        # f64 run would betray the reference-parity dtype
        raise ValueError(
            "dtype='float64' is not supported by the fused kernel; use "
            "dv_strategy='gather'/'segment_sum' (the scan path) for f64"
        )
    if ode.dt_mode == "shared" and ode.step_size is None:
        raise ValueError(
            "dt_mode='shared' is not supported by the fused kernel; use "
            "dv_strategy='auto' (scan path) or per-trajectory dt"
        )
    bf16 = getattr(ode, "matmul_dtype", "float32") == "bfloat16"
    if not fused_supported(fa):
        raise ValueError(
            "the fused kernel does not support this formula (unit clauses, "
            "plane beyond its 8 MB envelope, or no power-of-two clause "
            "tile); use the scan path"
        )
    if not interpret:
        require_gpu("dv_strategy='fused'")

    K, Mp = fa.lit_var.shape
    Np = fa.n_vars_padded
    Np2 = _next_pow2(max(Np, _MIN_ROWS))
    TM = clause_tile(Mp)
    n_tiles = Mp // TM
    paper = ode.rigidity == "paper"
    fixed = ode.step_size is not None
    dt_fixed = float(ode.step_size) if fixed else 0.0
    tol = float(ode.tolerance)
    zeta_c = float(zeta)
    xl_cap = float(XL_CAP_PER_CLAUSE * fa.n_clauses)
    n_parts = 1 if bf16 else 3  # bf16 pieces per f32 dot operand

    G_np, bias_np, cmask_np = build_planes(fa, Np2)
    G_host = jnp.asarray(G_np).astype(jnp.bfloat16)  # -1/0/+1: exact
    bias_host = jnp.asarray(bias_np)
    cmask_host = jnp.asarray(cmask_np)

    cache_key = (
        "fused", Np, Mp, K, fa.n_clauses, zeta_c, paper, fixed, dt_fixed,
        tol, bf16, chunk_steps, interpret, donate,
    )
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is not None:
        return wrap_chunk_runner(jitted, cache_key, G_host, bias_host, cmask_host)

    def barrier():
        # tile values stored in one thread layout are re-read in another:
        # make the block's global-memory writes visible before reuse
        if not interpret:
            plgpu.debug_barrier()

    def clamp_v(x):
        return jnp.minimum(jnp.maximum(x, -1.0), 1.0)

    def clamp_s(x):
        return jnp.minimum(jnp.maximum(x, EPSILON), 1.0 - EPSILON)

    def clamp_l(x):
        return jnp.minimum(jnp.maximum(x, 1.0), xl_cap)

    def kernel(v_ref, xs_ref, xl_ref, dt_ref, done_ref, g_ref, bias_ref, cmask_ref,
               v_out, xs_out, xl_out, dt_out, done_out, *scratch):
        def cols(t):
            return pl.ds(pl.multiple_of(t * TM, TM), TM)

        def plane(k, t):
            return g_ref[:, pl.ds(pl.multiple_of(k * Mp + t * TM, TM), TM)]

        def split(x):
            """bf16 parts of an f32 array, smallest first; they sum to x."""
            parts = []
            for _ in range(n_parts - 1):
                hi = x.astype(jnp.bfloat16)
                parts.append(hi)
                x = x - hi.astype(jnp.float32)
            parts.append(x.astype(jnp.bfloat16))
            return parts[::-1]

        def pdot(parts, g, trans_b=False):
            out = None
            for part in parts:
                d = pl.dot(part, g, trans_b=trans_b)
                out = d if out is None else out + d
            return out

        def terms(vm, xs, xl, t):
            """Clause value c (Bb, TM) and the tile's dv share (Bb, Np2);
            ``vm`` is ``split(v)``."""
            vals = []
            for k in range(K):
                b_k = bias_ref[pl.ds(pl.multiple_of(k * Mp + t * TM, TM), TM)]
                vals.append(pdot(vm, plane(k, t)) + b_k[None, :])
            m1 = vals[0]
            m2 = jnp.full_like(m1, _BIG * 4)
            for valk in vals[1:]:
                m2 = jnp.minimum(m2, jnp.maximum(m1, valk))
                m1 = jnp.minimum(m1, valk)
            c = 0.5 * m1
            a = -0.5 * (xl * xs)
            b = -0.5 * ((1.0 + zeta_c * xl) * (1.0 - xs))
            A1 = a * m1
            A2 = a * m2
            dv = None
            for k in range(K):
                valk = vals[k]
                is_min = valk <= m1
                if paper:
                    contrib = jnp.where(is_min, A2 + b * valk, A1)
                else:
                    contrib = jnp.where(is_min, A2, A1) + jnp.where(valk == c, b * valk, 0.0)
                share = pdot(split(contrib), plane(k, t), trans_b=True)
                dv = share if dv is None else dv + share
            return c, dv

        def unsat_rows(c, cm):
            return jnp.max(jnp.where((c >= GAMMA) & (cm > 0.0), 1.0, 0.0), axis=1)

        def dxs_of(xs, c, cm):
            return BETA * (xs + EPSILON) * (c - GAMMA) * cm

        def dxl_of(c, cm):
            return ALPHA * (c - DELTA) * cm

        Bb = v_ref.shape[0]

        def copy_in(t, carry):
            xs_out[:, cols(t)] = xs_ref[:, cols(t)]
            xl_out[:, cols(t)] = xl_ref[:, cols(t)]
            return carry

        jax.lax.fori_loop(0, n_tiles, copy_in, 0)
        barrier()
        zeros_v = jnp.zeros((Bb, Np2), jnp.float32)
        zeros_r = jnp.zeros((Bb,), jnp.float32)

        if fixed:

            def step(_, carry):
                v, done = carry
                dt_col = jnp.where(done < 0.5, dt_fixed, 0.0)[:, None]
                vm = split(v)

                def tile_body(t, acc):
                    dv, unsat = acc
                    xs = xs_out[:, cols(t)]
                    xl = xl_out[:, cols(t)]
                    cm = cmask_ref[cols(t)][None, :]
                    c, share = terms(vm, xs, xl, t)
                    xs_out[:, cols(t)] = clamp_s(xs + dt_col * dxs_of(xs, c, cm))
                    xl_out[:, cols(t)] = clamp_l(xl + dt_col * dxl_of(c, cm))
                    return dv + share, jnp.maximum(unsat, unsat_rows(c, cm))

                dv, unsat = jax.lax.fori_loop(0, n_tiles, tile_body, (zeros_v, zeros_r))
                barrier()
                v = clamp_v(v + dt_col * dv)
                return v, jnp.maximum(done, jnp.where(unsat < 0.5, 1.0, 0.0))

            v, done = jax.lax.fori_loop(0, chunk_steps, step, (v_ref[...], done_ref[...]))
            dt = dt_ref[...]

        else:
            (c_scr,) = scratch

            def step(_, carry):
                v, dt, done = carry
                live = done < 0.5
                dt_c = jnp.where(live, dt, 0.0)[:, None]
                h_c = 0.5 * dt_c
                vm = split(v)

                def pass1(t, acc):
                    dv, unsat = acc
                    xs = xs_out[:, cols(t)]
                    xl = xl_out[:, cols(t)]
                    cm = cmask_ref[cols(t)][None, :]
                    c, share = terms(vm, xs, xl, t)
                    c_scr[:, cols(t)] = c
                    return dv + share, jnp.maximum(unsat, unsat_rows(c, cm))

                dv1, unsat = jax.lax.fori_loop(0, n_tiles, pass1, (zeros_v, zeros_r))
                allsat = unsat < 0.5
                advance = live & ~allsat  # src/system.rs:122
                adv = advance[:, None]
                # the full trial step waits in v_out until pass 2 is done
                v_out[...] = clamp_v(v + dt_c * dv1)
                hv = clamp_v(v + h_c * dv1)
                hvm = split(hv)
                barrier()

                def pass2(t, acc):
                    dv, err = acc
                    xs = xs_out[:, cols(t)]
                    xl = xl_out[:, cols(t)]
                    c1 = c_scr[:, cols(t)]
                    cm = cmask_ref[cols(t)][None, :]
                    d_xs = dxs_of(xs, c1, cm)
                    d_xl = dxl_of(c1, cm)
                    hxs = clamp_s(xs + h_c * d_xs)
                    hxl = clamp_l(xl + h_c * d_xl)
                    c2, share = terms(hvm, hxs, hxl, t)
                    txs = clamp_s(hxs + h_c * dxs_of(hxs, c2, cm))
                    txl = clamp_l(hxl + h_c * dxl_of(c2, cm))
                    err = jnp.maximum(err, jnp.max(jnp.abs(clamp_s(xs + dt_c * d_xs) - txs), axis=1))
                    err = jnp.maximum(err, jnp.max(jnp.abs(clamp_l(xl + dt_c * d_xl) - txl), axis=1))
                    xs_out[:, cols(t)] = jnp.where(adv, txs, xs)
                    xl_out[:, cols(t)] = jnp.where(adv, txl, xl)
                    return dv + share, err

                dv2, err = jax.lax.fori_loop(0, n_tiles, pass2, (zeros_v, zeros_r))
                barrier()
                tv = clamp_v(hv + h_c * dv2)
                err = jnp.maximum(err, jnp.max(jnp.abs(v_out[...] - tv), axis=1))
                new_dt = jnp.minimum(
                    jnp.maximum(dt * jnp.sqrt(tol / jnp.maximum(err, 1e-30)), DT_MIN), DT_MAX
                )
                v = jnp.where(adv, tv, v)
                dt = jnp.where(advance, new_dt, dt)
                done = jnp.maximum(done, jnp.where(allsat, 1.0, 0.0))
                barrier()
                return v, dt, done

            v, dt, done = jax.lax.fori_loop(
                0, chunk_steps, step, (v_ref[...], dt_ref[...], done_ref[...])
            )

        v_out[...] = v
        dt_out[...] = dt
        done_out[...] = done

    def raw(state, G, bias, cmask):
        from odesat_tpu.models.ode import ODEState

        B_in = state.v.shape[0]
        Bb = traj_block(B_in, Np2, n_parts)
        pad = (-B_in) % Bb
        v = state.v.astype(jnp.float32)
        if Np2 != Np:
            v = jnp.pad(v, ((0, 0), (0, Np2 - Np)))
        xs, xl = state.xs, state.xl
        dt = state.dt.astype(jnp.float32)
        done = state.done.astype(jnp.float32)
        if pad:
            # frozen dummy rows: done, dt 0, in-range state
            v = jnp.pad(v, ((0, pad), (0, 0)))
            xs = jnp.pad(xs, ((0, pad), (0, 0)), constant_values=0.5)
            xl = jnp.pad(xl, ((0, pad), (0, 0)), constant_values=1.0)
            dt = jnp.pad(dt, (0, pad))
            done = jnp.pad(done, (0, pad), constant_values=1.0)
        B = B_in + pad

        rows = lambda shape: pl.BlockSpec(shape, lambda i: (i,) + (0,) * (len(shape) - 1))  # noqa: E731
        whole = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))  # noqa: E731
        out_specs = [rows((Bb, Np2)), rows((Bb, Mp)), rows((Bb, Mp)), rows((Bb,)), rows((Bb,))]
        out_shape = [
            jax.ShapeDtypeStruct((B, Np2), jnp.float32),
            jax.ShapeDtypeStruct((B, Mp), jnp.float32),
            jax.ShapeDtypeStruct((B, Mp), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
        ]
        if not fixed:
            out_specs.append(rows((Bb, Mp)))  # per-tile clause values between passes
            out_shape.append(jax.ShapeDtypeStruct((B, Mp), jnp.float32))
        passes = (1 if fixed else 2) * n_parts
        outs = pallas_call_32bit(
            kernel,
            grid=(B // Bb,),
            in_specs=[
                rows((Bb, Np2)), rows((Bb, Mp)), rows((Bb, Mp)), rows((Bb,)), rows((Bb,)),
                whole((Np2, K * Mp)), whole((K * Mp,)), whole((Mp,)),
            ],
            out_specs=out_specs,
            out_shape=out_shape,
            backend="triton",
            interpret=interpret,
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
            cost_estimate=pl.CostEstimate(
                flops=4 * K * B * Np2 * Mp * chunk_steps * passes,
                bytes_accessed=B * (Np2 + 2 * Mp) * 4 * 2,
                transcendentals=0,
            ),
            name="odesat_fused_chunk",
        )(v, xs, xl, dt, done, G, bias, cmask)
        v_o, xs_o, xl_o, dt_o, done_o = outs[:5]
        return ODEState(
            v=v_o[:B_in, :Np].astype(state.v.dtype),
            xs=xs_o[:B_in],
            xl=xl_o[:B_in],
            dt=dt_o[:B_in].astype(state.dt.dtype),
            done=done_o[:B_in] > 0.5,
        )

    jitted = jax.jit(raw, donate_argnums=0 if donate else ())
    _JIT_CACHE[cache_key] = jitted
    return wrap_chunk_runner(jitted, cache_key, G_host, bias_host, cmask_host)
