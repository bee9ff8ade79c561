"""Double-single (df32) lanes implementation of the brute-force J(T) oracle.

Why: in the reference, baseline1 (brute force) is the in-suite ground truth —
cost/time ratios key to it (reference run_suite.py:196-207) and the
propagator's exactness claim is "matches brute force". In f32 the plain XLA
value-expansion recursion is precision-broken exactly like the propagator
recursion (cartpole baseline1 T_median 232 vs the true 181; fp32 brute force
agrees with f64 on only 1.5% of problems), so f32 suites had no trustworthy
oracle column. This gives the f32 brute force df32 arithmetic; f64 solves
take the plain XLA path.

Design: plain XLA (like solver/sweep_df.py — the oracle is a baseline, not
the headline hot path), one `lax.scan` over the N time steps carrying the
df32 value triplet (Vxx, Vx, V0) for ALL candidate horizons at once: arrays
carry TWO trailing lane axes (T_max, B) — candidate horizon x problem — and
the per-step inputs enter as (rows, cols, 1, B), broadcasting over the
candidate axis inside every df op (ops/df32.py slices only the leading two
matrix axes, so arbitrary trailing lane dims broadcast for free). This keeps
the per-step HBM traffic at the per-problem size instead of materializing
(N, n, n, T_max*B) broadcast inputs.

Semantics match solver/horizon.value_expansion_V0 (reference inner loop
reference solver.py:316-356): terminal injection at k+1 == T, fixed
lm_lambda regularization (reference solver.py:348, default 1e-6), masked
pass-through for k >= T, J(T) = V0 at step 0.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from timeopt.ops import df32 as dfm


def _wsel(mask, a, b):
    return (jnp.where(mask, a[0], b[0]), jnp.where(mask, a[1], b[1]))


def bruteforce_lanes_df(A, B, lx, lu, l0, Qs, eTs, QfT, R, *, lm_lambda=1e-6):
    """Batched df32 brute-force J(T) curve; batch-leading in/outputs.

    A (Bb,Tm,n,n), B (Bb,Tm,n,m), lx (Bb,Tm,n), lu (Bb,Tm,m), l0 (Bb,Tm),
    Qs (Bb,Tm,n,n), eTs (Bb,Tm,n) = wrap(x_{k+1} - xg), QfT (Bb,n,n),
    R (Bb,m,m). Returns J (Bb, Tm) with J[b, T-1] the quadratic-model cost
    of horizon T.
    """
    Bb, Tm, n, _ = A.shape
    m = B.shape[-1]
    dtype = A.dtype

    # step-leading lanes layout with a singleton candidate axis: (Tm, r, c, 1, Bb)
    t4 = lambda x: jnp.transpose(x, (1, 2, 3, 0))[:, :, :, None, :]  # noqa: E731
    t3 = lambda x: jnp.transpose(x, (1, 2, 0))[:, :, None, None, :]  # noqa: E731
    At, Qst, Bt = t4(A), t4(Qs), t4(B)
    lxt = t3(lx)  # (Tm, n, 1, 1, Bb)
    lut = t3(lu)
    l0t = jnp.transpose(l0, (1, 0))[:, None, None, None, :]  # (Tm, 1, 1, 1, Bb)
    eTt = t3(eTs)  # (Tm, n, 1, 1, Bb)
    Qft = jnp.transpose(QfT, (1, 2, 0))[:, :, None, :]  # (n, n, 1, Bb)
    Rt = jnp.transpose(R, (1, 2, 0))[:, :, None, :]  # (m, m, 1, Bb)

    Qf_df = dfm.df_mat(Qft)
    R_df = dfm.df_mat(Rt)
    # candidate horizons T = 1..Tm on the third-from-last axis
    Ts = (jnp.arange(1, Tm + 1, dtype=jnp.int32))[None, None, :, None]  # (1,1,Tm,1)
    eye_m = jnp.broadcast_to(
        jnp.eye(m, dtype=dtype)[:, :, None, None], (m, m, Tm, Bb)
    )

    def f(carry, inp):
        Vx, Vxx, V0 = carry  # df pairs (n,1,Tm,Bb), (n,n,Tm,Bb), (1,1,Tm,Bb)
        k, Ak, Bk, lxk, luk, l0k, Qsk, eTk = inp

        is_term = (k + 1) == Ts  # (1,1,Tm,1)
        eTd = dfm.df_mat(eTk)  # (n, 1, 1, Bb)
        QfeT = dfm.df_matmul(Qf_df, eTd)  # (n, 1, 1, Bb)
        V0term = dfm.df_mul_f32(dfm.df_matmul_tn(eTd, QfeT), jnp.asarray(0.5, dtype))
        Vx_in = _wsel(is_term, QfeT, Vx)
        Vxx_in = _wsel(is_term, Qf_df, Vxx)
        V0_in = _wsel(is_term, V0term, V0)

        Adf = dfm.df_mat(Ak)  # (n, n, 1, Bb)
        Bdf = dfm.df_mat(Bk)
        Qx = dfm.df_add(dfm.df_mat(lxk), dfm.df_matmul_tn(Adf, Vx_in))
        Qu = dfm.df_add(dfm.df_mat(luk), dfm.df_matmul_tn(Bdf, Vx_in))
        VA = dfm.df_matmul(Vxx_in, Adf)  # (n, n, Tm, Bb)
        Qxx = dfm.df_add(dfm.df_mat(Qsk), dfm.df_matmul_tn(Adf, VA))
        VB = dfm.df_matmul(Vxx_in, Bdf)  # (n, m, Tm, Bb)
        Quu = dfm.df_add(R_df, dfm.df_matmul_tn(Bdf, VB))  # (m, m, Tm, Bb)
        Qux = dfm.df_matmul_tn(Bdf, VA)  # (m, n, Tm, Bb)

        # fixed regularization, folded exactly (reference solver.py:348)
        Quu_s = dfm.df_sym_half(Quu)
        iQ = dfm.df_gj_inv(Quu_s, float(lm_lambda), eye_m)

        iQQu = dfm.df_matmul(iQ, Qu)  # (m, 1, Tm, Bb)
        iQQux = dfm.df_matmul(iQ, Qux)  # (m, n, Tm, Bb)
        Vx_new = dfm.df_sub(Qx, dfm.df_matmul_tn(Qux, iQQu))
        Vxx_new = dfm.df_sym_half(dfm.df_sub(Qxx, dfm.df_matmul_tn(Qux, iQQux)))
        V0_new = dfm.df_add(
            dfm.df_add(dfm.df_mat(l0k), V0_in),
            dfm.df_neg(
                dfm.df_mul_f32(dfm.df_matmul_tn(Qu, iQQu), jnp.asarray(0.5, dtype))
            ),
        )

        active = k < Ts  # (1,1,Tm,1)
        Vx_out = _wsel(active, Vx_new, Vx_in)
        Vxx_out = _wsel(active, Vxx_new, Vxx_in)
        V0_out = _wsel(active, V0_new, V0_in)
        return (Vx_out, Vxx_out, V0_out), None

    zdf = lambda s: (jnp.zeros(s, dtype), jnp.zeros(s, dtype))  # noqa: E731
    init = (zdf((n, 1, Tm, Bb)), zdf((n, n, Tm, Bb)), zdf((1, 1, Tm, Bb)))
    ks = jnp.arange(Tm)
    (_, _, V0), _ = lax.scan(
        f, init, (ks, At, Bt, lxt, lut, l0t, Qst, eTt), reverse=True
    )
    return jnp.transpose(V0[0][0, 0] + V0[1][0, 0], (1, 0))  # (Bb, Tm)
