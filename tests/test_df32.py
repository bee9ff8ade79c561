"""Direct unit tests for the df32 extended-precision primitives
(timeopt/ops/df32.py) against float64 references. Run as plain XLA ops on
CPU, where f32 arithmetic is IEEE-exact, so the error bounds are the real
df32 bounds (~4e-15 relative) — unlike compiled XLA-CPU code, whose FP
contraction degrades the TwoSum/TwoProd tricks."""

import numpy as np
import jax.numpy as jnp

from timeopt.ops import df32 as dfm

P, B = 13, 8


def _spd(rng, p, b, kappa=1e5):
    """Random SPD batch (p, p, b) float64 with condition ~kappa."""
    out = np.zeros((p, p, b))
    for i in range(b):
        Q, _ = np.linalg.qr(rng.standard_normal((p, p)))
        ev = np.logspace(0, np.log10(kappa), p)
        out[:, :, i] = (Q * ev) @ Q.T
    return out


def _to_df(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def _to64(x):
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def test_df_ldl_matches_f64(rng):
    A64 = _spd(rng, P, B)
    L, d, inv_d = dfm.df_ldl(_to_df(A64), 0.0, jnp.eye(P, dtype=jnp.float32)[:, :, None] * jnp.ones((1, 1, B), jnp.float32))
    L64 = _to64(L)
    d64 = _to64(d)[:, 0, :]
    for i in range(B):
        rec = L64[:, :, i] @ np.diag(d64[:, i]) @ L64[:, :, i].T
        np.testing.assert_allclose(rec, A64[:, :, i], rtol=1e-8, atol=1e-7)
    # inv_d really is 1/d to df accuracy
    np.testing.assert_allclose(_to64(inv_d), 1.0 / _to64(d), rtol=1e-13)


def test_df_trisolve_roundtrip(rng):
    A64 = _spd(rng, P, B, kappa=1e4)
    R64 = rng.standard_normal((P, P, B))
    eye = jnp.eye(P, dtype=jnp.float32)[:, :, None] * jnp.ones((1, 1, B), jnp.float32)
    L, d, inv_d = dfm.df_ldl(_to_df(A64), 0.0, eye)
    # forward: L U = R
    U = dfm.df_trisolve_unit_lower(L, _to_df(R64))
    L64 = _to64(L)
    for i in range(B):
        np.testing.assert_allclose(
            L64[:, :, i] @ _to64(U)[:, :, i], R64[:, :, i], rtol=1e-11, atol=1e-9
        )
    # full solve A X = R via L' X = inv_d * U
    X = dfm.df_trisolve_unit_lower_t(L, dfm.df_scale_rows(U, inv_d))
    for i in range(B):
        ref = np.linalg.solve(A64[:, :, i], R64[:, :, i])
        np.testing.assert_allclose(_to64(X)[:, :, i], ref, rtol=1e-9, atol=1e-8)


def test_df_trisolve_bt_is_transpose_rhs(rng):
    A64 = _spd(rng, P, B, kappa=10.0)
    R64 = rng.standard_normal((P, P, B))
    eye = jnp.eye(P, dtype=jnp.float32)[:, :, None] * jnp.ones((1, 1, B), jnp.float32)
    L, _, _ = dfm.df_ldl(_to_df(A64), 0.0, eye)
    Xt = dfm.df_trisolve_unit_lower_bt(L, _to_df(R64))
    X = dfm.df_trisolve_unit_lower(L, _to_df(R64.swapaxes(0, 1)))
    np.testing.assert_allclose(_to64(Xt), _to64(X), rtol=0, atol=0)


def test_ldl_quadratic_form_matches_inverse(rng):
    """R' (A)^-1 R via trisolve + scaled Gram == f64 inverse (the pattern the
    select kernel uses for every W-product)."""
    A64 = _spd(rng, P, B)
    R64 = rng.standard_normal((P, P, B))
    eye = jnp.eye(P, dtype=jnp.float32)[:, :, None] * jnp.ones((1, 1, B), jnp.float32)
    L, d, inv_d = dfm.df_ldl(_to_df(A64), 0.0, eye)
    U = dfm.df_trisolve_unit_lower(L, _to_df(R64))
    QF = dfm.df_matmul_tn(U[0], dfm.df_scale_rows(U, inv_d)[0]) if False else dfm.df_matmul_tn(U, dfm.df_scale_rows(U, inv_d))
    for i in range(B):
        ref = R64[:, :, i].T @ np.linalg.solve(A64[:, :, i], R64[:, :, i])
        np.testing.assert_allclose(_to64(QF)[:, :, i], ref, rtol=1e-9, atol=1e-8)


def test_ldl_last_pivot_is_inv_corner(rng):
    """1/d_p == (A^-1)[p-1, p-1] — the factored J(T) query shortcut."""
    A64 = _spd(rng, P, B)
    eye = jnp.eye(P, dtype=jnp.float32)[:, :, None] * jnp.ones((1, 1, B), jnp.float32)
    _, d, inv_d = dfm.df_ldl(_to_df(A64), 0.0, eye)
    got = _to64(inv_d)[P - 1, 0, :]
    for i in range(B):
        ref = np.linalg.inv(A64[:, :, i])[P - 1, P - 1]
        np.testing.assert_allclose(got[i], ref, rtol=1e-10)


def test_trisym_products_match_full(rng):
    """Triangle-symmetric products (dense-kernel path): lower triangle is
    computed with the canonical per-entry op order of the full product —
    bitwise equal to it in plain XLA-CPU f32 — and the assembled matrix is
    exactly symmetric."""
    X64 = rng.standard_normal((P, P, B))
    D64 = np.abs(rng.standard_normal((P, 1, B))) + 0.1
    X = _to_df(X64)
    Xs = dfm.df_scale_rows(X, _to_df(D64))

    full = dfm.df_matmul_tn(X, Xs)
    tri = dfm.df_matmul_tn_trisym(X, Xs)
    fh, th = np.asarray(full[0]), np.asarray(tri[0])
    fl, tl = np.asarray(full[1]), np.asarray(tri[1])
    il, jl_ = np.tril_indices(P)
    np.testing.assert_array_equal(th[il, jl_], fh[il, jl_])
    np.testing.assert_array_equal(tl[il, jl_], fl[il, jl_])
    np.testing.assert_array_equal(th, np.swapaxes(th, 0, 1))
    np.testing.assert_array_equal(tl, np.swapaxes(tl, 0, 1))

    # A D A' form (df_matmul_trisym): X (p, k), Y = D X' (k, p)
    Y = dfm.df_matmul(_to_df(np.swapaxes(X64, 0, 1) * 0 + np.eye(P)[:, :, None] * D64[:, 0][None]), dfm.df_mat(jnp.asarray(np.swapaxes(X64, 0, 1), dtype=jnp.float32)))
    full2 = dfm.df_matmul(X, Y)
    tri2 = dfm.df_matmul_trisym(X, Y)
    f2h, t2h = np.asarray(full2[0]), np.asarray(tri2[0])
    np.testing.assert_array_equal(t2h[il, jl_], f2h[il, jl_])
    np.testing.assert_array_equal(t2h, np.swapaxes(t2h, 0, 1))

    # rank-1 outer (df_outer_trisym)
    u64 = rng.standard_normal((P, 1, B))
    u = _to_df(u64)
    us = dfm.df_mul(u, _to_df(np.full((1, 1, B), 0.37)))
    full3 = dfm.df_matmul_nt(us, u)
    tri3 = dfm.df_outer_trisym(us, u)
    f3h, t3h = np.asarray(full3[0]), np.asarray(tri3[0])
    np.testing.assert_array_equal(t3h[il, jl_], f3h[il, jl_])
    np.testing.assert_array_equal(t3h, np.swapaxes(t3h, 0, 1))
