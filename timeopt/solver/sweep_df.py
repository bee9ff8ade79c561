"""Double-single (df32) lanes implementation of the one-pass value sweep.

Why: the one-pass baseline's backward value recursion
(reference horizon_selection.py:97-212) chains L = T_max + S ≈ 200-340
steps of Riccati-style updates. In plain f32 the accumulated error shifts the
one-pass J by ~0.3% and the final tracking error by ~6% — enough to flip
knife-edge outcomes (cartpole baseline2 lands at final_err 0.480 in f64 vs a
0.5 success tolerance; f32 pushes it to 0.509 → success 0.00 where the
reference scores 1.00). This gives the f32 one-pass sweep df32 arithmetic;
f64 solves take the plain XLA path.

Design: plain XLA — the problem batch rides the trailing axis (inputs
transposed to (L, rows, cols, B)) through the df32 helpers of ops/df32.py,
with one `lax.scan` over L carrying the df32 value function. The sweep is a
baseline, not the headline hot path.

Semantics are bit-compatible with onepass._sweep_impl's masking/ladder
logic (terminal injection at per-lane iT, static 3-rung LM ladder picking
the first SPD rung, ok-flag accumulation) — property-tested against the f64
oracle in tests/test_onepass.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from timeopt.ops import df32 as dfm


def _eye_lanes(p: int, b: int, dtype):
    rows = lax.broadcasted_iota(jnp.int32, (p, p, b), 0)
    cols = lax.broadcasted_iota(jnp.int32, (p, p, b), 1)
    return (rows == cols).astype(dtype)


def _wsel(mask, a, b):
    return (jnp.where(mask, a[0], b[0]), jnp.where(mask, a[1], b[1]))


def sweep_lanes_df(A, B, lx, lu, l0, Qs, eT, eT_fin, fin_in, QfT, R, iT, lam0):
    """Batched df32 sweep; batch-leading inputs, batch-leading outputs.

    A (Bb,L,n,n), B (Bb,L,n,m), lx (Bb,L,n), lu (Bb,L,m), l0 (Bb,L),
    Qs (Bb,L,n,n), eT (Bb,L,n), eT_fin/fin_in (Bb,L) 0/1 floats,
    QfT (Bb,n,n), R (Bb,m,m), iT (Bb,), lam0 (Bb,).
    Returns (Vxx (Bb,L,n,n), Vx (Bb,L,n), V0 (Bb,L), K (Bb,L,m,n),
    kff (Bb,L,m), ok (Bb,) 0/1 float).
    """
    Bb, L, n, _ = A.shape
    m = B.shape[-1]
    dtype = A.dtype

    t4 = lambda x: jnp.transpose(x, (1, 2, 3, 0))  # noqa: E731
    t3 = lambda x: jnp.transpose(x, (1, 2, 0))  # noqa: E731
    At, Qst = t4(A), t4(Qs)
    Bt = t4(B)
    lxt = t3(lx)[:, :, None, :]  # (L, n, 1, B)
    lut = t3(lu)[:, :, None, :]
    l0t = jnp.transpose(l0, (1, 0))[:, None, None, :]  # (L, 1, 1, B)
    eTt = t3(eT)[:, :, None, :]  # (L, n, 1, B)
    eTft = jnp.transpose(eT_fin, (1, 0))  # (L, B)
    fint = jnp.transpose(fin_in, (1, 0))
    Qft = jnp.transpose(QfT, (1, 2, 0))  # (n, n, B)
    Rt = jnp.transpose(R, (1, 2, 0))  # (m, m, B)

    eye_m = _eye_lanes(m, Bb, dtype)
    Qf_df = dfm.df_mat(Qft)
    R_df = dfm.df_mat(Rt)

    def f(carry, inp):
        Vx, Vxx, V0, ok = carry  # df pairs (n,1,B), (n,n,B), (1,1,B); ok (B,)
        i, Ai, Bi, lxi, lui, l0i, Qsi, eTi, eTfi, fini = inp

        is_term = ((i + 1).astype(dtype) == iT)[None, None, :]  # (1,1,B)
        eTd = dfm.df_mat(eTi)  # (n, 1, B)
        QfeT = dfm.df_matmul(Qf_df, eTd)
        V0term = dfm.df_mul(dfm.df_matmul_tn(eTd, QfeT), (0.5, 0.0))
        Vx_in = _wsel(is_term, QfeT, Vx)
        Vxx_in = _wsel(is_term, Qf_df, Vxx)
        V0_in = _wsel(is_term, V0term, V0)
        ok = ok * jnp.where(is_term[0, 0], eTfi, 1.0)

        Adf = dfm.df_mat(Ai)
        Bdf = dfm.df_mat(Bi)
        Qx = dfm.df_add(dfm.df_mat(lxi), dfm.df_matmul_tn(Adf, Vx_in))
        Qu = dfm.df_add(dfm.df_mat(lui), dfm.df_matmul_tn(Bdf, Vx_in))
        VA = dfm.df_matmul(Vxx_in, Adf)
        Qxx = dfm.df_add(dfm.df_mat(Qsi), dfm.df_matmul_tn(Adf, VA))
        VB = dfm.df_matmul(Vxx_in, Bdf)
        Quu = dfm.df_add(R_df, dfm.df_matmul_tn(Bdf, VB))
        Qux = dfm.df_matmul_tn(Bdf, VA)  # (m, n, B)

        # static 4-rung LM ladder, first SPD rung wins (same rungs as the
        # plain implementation: lam0, lam0*1e4, lam0*1e8, lam0*1e12 — reach
        # covers the reference's x10-up-to-12-tries escalation ceiling of
        # lam0*1e11, reference horizon_selection.py:179-200)
        Quu_s = dfm.df_sym_half(Quu)
        iQ = None
        chosen = jnp.zeros((Bb,), bool)
        for mult in (1.0, 1e4, 1e8, 1e12):
            lam = (lam0 * mult)[None, None, :] * eye_m
            reg = dfm.df_add(Quu_s, dfm.df_mat(lam))
            iQ_r, piv = dfm.df_gj_inv_pivots(reg, 0.0, eye_m)
            spd_r = jnp.all((piv > 0) & jnp.isfinite(piv), axis=0)  # (B,)
            take = (~chosen) & spd_r
            iQ = iQ_r if iQ is None else _wsel(take[None, None, :], iQ_r, iQ)
            chosen = chosen | spd_r
        any_spd = chosen

        iQQu = dfm.df_matmul(iQ, Qu)  # (m, 1, B)
        iQQux = dfm.df_matmul(iQ, Qux)  # (m, n, B)
        kff_i = dfm.df_neg(iQQu)
        K_i = dfm.df_neg(iQQux)
        Vx_new = dfm.df_sub(Qx, dfm.df_matmul_tn(Qux, iQQu))
        Vxx_new = dfm.df_sym_half(dfm.df_sub(Qxx, dfm.df_matmul_tn(Qux, iQQux)))
        V0_new = dfm.df_add(
            dfm.df_add(dfm.df_mat(l0i), V0_in),
            dfm.df_neg(dfm.df_mul(dfm.df_matmul_tn(Qu, iQQu), (0.5, 0.0))),
        )

        active = (i.astype(dtype) < iT)[None, None, :]  # (1,1,B)
        fin_new = (
            jnp.all(jnp.isfinite(Vx_new[0]), axis=(0, 1))
            & jnp.all(jnp.isfinite(Vxx_new[0]), axis=(0, 1))
            & jnp.isfinite(V0_new[0][0, 0])
        )
        step_ok = (any_spd & (fini > 0.5) & fin_new).astype(dtype)
        ok = ok * jnp.where(active[0, 0], step_ok, 1.0)

        Vx_out = _wsel(active, Vx_new, Vx_in)
        Vxx_out = _wsel(active, Vxx_new, Vxx_in)
        V0_out = _wsel(active, V0_new, V0_in)
        zero = jnp.asarray(0.0, dtype)
        act = active[0]
        ys = (
            Vxx_out[0] + Vxx_out[1],  # (n, n, B) f32
            Vx_out[0][:, 0, :] + Vx_out[1][:, 0, :],  # (n, B)
            V0_out[0][0, 0, :] + V0_out[1][0, 0, :],  # (B,)
            jnp.where(active, K_i[0] + K_i[1], zero),  # (m, n, B)
            jnp.where(act, kff_i[0][:, 0, :] + kff_i[1][:, 0, :], zero),  # (m, B)
        )
        return (Vx_out, Vxx_out, V0_out, ok), ys

    zdf = lambda shape: (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))  # noqa: E731
    init = (zdf((n, 1, Bb)), zdf((n, n, Bb)), zdf((1, 1, Bb)), jnp.ones((Bb,), dtype))
    idx = jnp.arange(L)
    (_, _, _, ok), (Vxx, Vx, V0, K, kff) = lax.scan(
        f, init, (idx, At, Bt, lxt, lut, l0t, Qst, eTt, eTft, fint), reverse=True
    )
    # back to batch-leading
    return (
        jnp.transpose(Vxx, (3, 0, 1, 2)),
        jnp.transpose(Vx, (2, 0, 1)),
        jnp.transpose(V0, (1, 0)),
        jnp.transpose(K, (3, 0, 1, 2)),
        jnp.transpose(kff, (2, 0, 1)),
        ok,
    )
