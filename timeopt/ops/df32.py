"""Double-single ("df32") arithmetic: each value is an unevaluated sum
hi + lo of two float32s, giving ~48 mantissa bits (eps ~ 4e-15).

Why it exists: the LFT propagator recursion chains ~160 inversions of
matrices with kappa ~ 1e4..1e5; fp32 arithmetic (eps 6e-8) corrupts the
J(T) curve by O(100) and scrambles the horizon argmin entirely, while the
*inputs* rounded to fp32 perturb J by only ~1e-4 (measured — see
solver/horizon.py notes). On hardware without fp64 units the fix is
extended-precision arithmetic built from exact fp32 ops: Knuth TwoSum and
Dekker split-based TwoProd (no FMA requirement). All functions are
elementwise over arbitrary jnp arrays. On a machine with native f64 (CPU,
NVIDIA GPU) the f64 path is the reference precision and this module serves
only f32 solves.

References: Dekker (1971), "A floating-point technique for extending the
available precision"; the df64 pattern popularized for GPUs by the QD
library — implemented from the algorithms.

Backend caveat: the tricks require every a*b and a-b to round individually.
True in eager CPU ops, but XLA-*CPU* compilation breaks them:
LLVM FP contraction fuses a rematerialized multiply into a consumer
subtract (exact product where the algorithm needs the rounded one),
collapsing df32 to ~plain-f32 accuracy (measured: df_matmul 2e-14 eager vs
5e-8 jitted; only --xla_backend_optimization_level=0 restores it). Treat
compiled-CPU df32 as f32-quality; CPU correctness paths use f64. XLA-GPU
may contract mul+add into FMA too, so GPU df32 accuracy holds only as far
as it is measured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Dekker split constant for float32: 2^12 + 1
_SPLIT = 4097.0


def two_sum(a, b):
    """Exact addition: s + e == a + b, |e| <= ulp(s)/2 (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Exact addition assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact multiplication: p + e == a*b (Dekker split, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ----- df32 values are (hi, lo) tuples ---------------------------------------


def df(x):
    """Promote an f32 array to df32."""
    return x, jnp.zeros_like(x)


def df_neg(x):
    return -x[0], -x[1]


def df_add(x, y):
    sh, se = two_sum(x[0], y[0])
    se = se + (x[1] + y[1])
    return quick_two_sum(sh, se)


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    ph, pe = two_prod(x[0], y[0])
    pe = pe + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(ph, pe)


def df_mul_f32(x, c):
    """df * plain f32."""
    ph, pe = two_prod(x[0], c)
    pe = pe + x[1] * c
    return quick_two_sum(ph, pe)


def df_fma(acc, x, y):
    """acc + x*y in df32."""
    return df_add(acc, df_mul(x, y))


def df_recip(y):
    """1/y to df32 accuracy: f32 estimate + one df Newton step."""
    q1 = 1.0 / y[0]
    # r = 1 - q1*y (df)
    ph, pe = two_prod(q1, y[0])
    pe = pe + q1 * y[1]
    rh, re = two_sum(1.0 - ph, -pe)
    q2 = (rh + re) * q1
    return quick_two_sum(q1, q2)


def df_div(x, y):
    """x / y: f32 quotient + df residual correction."""
    q1 = x[0] / y[0]
    ph, pe = two_prod(q1, y[0])
    # r = x - q1*y
    rh, rl = df_add(x, (-ph, -(pe + q1 * y[1])))
    q2 = (rh + rl) / y[0]
    return quick_two_sum(q1, q2)


def df_to_f32(x):
    return x[0] + x[1]


def df_sum(x, axis: int = 0):
    """Compensated pairwise reduction of an f32 array along `axis`: returns
    the df32 pair of the sum, accurate to ~eps^2 regardless of length or
    reduction shape. Used where a plain f32 `jnp.sum` would inject
    O(log N * eps * sum|x|) noise into values that get COMPARED at that
    scale (e.g. the truncated true cost: J ~ 450 summed from ~160 stage
    terms carries ~2e-4 relative tree-sum noise, the same magnitude as the
    solver's rel_tol convergence threshold). log2(N) rounds of elementwise
    df adds — cheap and deterministic."""
    hi = jnp.moveaxis(x, axis, 0)
    lo = jnp.zeros_like(hi)
    n = hi.shape[0]
    while n > 1:
        m = n // 2
        hi2, lo2 = df_add((hi[:m], lo[:m]), (hi[m : 2 * m], lo[m : 2 * m]))
        if n % 2:
            hi = jnp.concatenate([hi2, hi[2 * m :]], axis=0)
            lo = jnp.concatenate([lo2, lo[2 * m :]], axis=0)
            n = m + 1
        else:
            hi, lo = hi2, lo2
            n = m
    return hi[0], lo[0]


# ----- small-matrix helpers in lanes layout ----------------------------------
# Matrices are (rows, cols, lanes) pairs of f32 arrays: (Ah, Al).


def df_mat(A):
    return A, jnp.zeros_like(A)


def _acc_step(acc, xk, yk):
    """One sloppy-accumulation FMA: exact TwoProd for the product hi, loose
    lo accumulation (renormalized once per output by the caller). |lo| grows
    to ~kdim ulps — harmless for kdim <= a few dozen."""
    ph, pe = two_prod(xk[0], yk[0])
    pe = pe + (xk[0] * yk[1] + xk[1] * yk[0])
    if acc is None:
        return ph, pe
    sh, se = two_sum(acc[0], ph)
    return sh, acc[1] + pe + se


def df_matmul(X, Y):
    """C[i,j,b] = sum_k X[i,k,b] Y[k,j,b] in df32; X: (a,k,b), Y: (k,c,b)."""
    Xh, Xl = X
    Yh, Yl = Y
    kdim = Xh.shape[1]
    acc = None
    for k in range(kdim):
        xk = (Xh[:, k : k + 1, :], Xl[:, k : k + 1, :])
        yk = (Yh[k : k + 1, :, :], Yl[k : k + 1, :, :])
        acc = _acc_step(acc, xk, yk)
    return quick_two_sum(*acc)


def df_matmul_nt(X, Y):
    """C = X Y^T: C[i,j,b] = sum_k X[i,k,b] Y[j,k,b]."""
    Xh, Xl = X
    Yh, Yl = Y
    kdim = Xh.shape[1]
    acc = None
    for k in range(kdim):
        xk = (Xh[:, k : k + 1, :], Xl[:, k : k + 1, :])
        yk = (
            Yh[:, k : k + 1, :].swapaxes(0, 1),
            Yl[:, k : k + 1, :].swapaxes(0, 1),
        )
        acc = _acc_step(acc, xk, yk)
    return quick_two_sum(*acc)


def df_matmul_tn(X, Y):
    """C = X^T Y: C[i,j,b] = sum_k X[k,i,b] Y[k,j,b]."""
    Xh, Xl = X
    Yh, Yl = Y
    kdim = Xh.shape[0]
    acc = None
    for k in range(kdim):
        xk = (
            Xh[k : k + 1, :, :].swapaxes(0, 1),
            Xl[k : k + 1, :, :].swapaxes(0, 1),
        )
        yk = (Yh[k : k + 1, :, :], Yl[k : k + 1, :, :])
        acc = _acc_step(acc, xk, yk)
    return quick_two_sum(*acc)


def _sym_from_tri(rows):
    """Assemble a full exactly-symmetric df (p, p, *b) matrix from lower-
    triangle rows (rows[i] a df (i+1, *b) pair holding entries j <= i):
    the strict upper triangle mirrors the lower — pure wiring, no flops."""
    p = len(rows)
    full_h, full_l = [], []
    for i in range(p):
        hs = [rows[i][0]]
        ls = [rows[i][1]]
        for j in range(i + 1, p):
            hs.append(rows[j][0][i : i + 1])
            ls.append(rows[j][1][i : i + 1])
        full_h.append(jnp.concatenate(hs, axis=0))
        full_l.append(jnp.concatenate(ls, axis=0))
    return jnp.stack(full_h, axis=0), jnp.stack(full_l, axis=0)


# ----- triangle-symmetric products -------------------------------------------
# For products whose result is symmetric up to df rounding (U' D U
# congruences, A D A' forms, rank-1 outer products), compute only the
# lower-triangle entries — with the SAME per-entry op order as the full
# product, so C_tri[i, j] == C_full[i, j] bitwise for i >= j — and mirror.
# This replaces "compute all p^2 entries, then df_sym_half" (which averages
# the two asymmetrically-rounded halves) with "compute p(p+1)/2 entries,
# exactly symmetric by construction": ~46% fewer product flops and no
# sym_half pass, at the same df accuracy class.
#
# Only the trisym=True options of ops/lft_df.py call it, and no solver
# route sets them.


def df_matmul_tn_trisym(X, Y):
    """Lower-triangle rows of C = X' Y (X: (k, p, *b), Y: (k, p, *b)),
    assembled to the full symmetric matrix. Caller guarantees symmetry of
    the exact product (e.g. Y = row-scaled X)."""
    Xh, Xl = X
    Yh, Yl = Y
    kdim, p = Xh.shape[0], Xh.shape[1]
    rows = []
    for i in range(p):
        acc = None
        for k in range(kdim):
            xk = (Xh[k, i][None], Xl[k, i][None])  # (1, *b)
            yk = (Yh[k, : i + 1], Yl[k, : i + 1])  # (i+1, *b)
            acc = _acc_step(acc, xk, yk)
        rows.append(quick_two_sum(*acc))
    return _sym_from_tri(rows)


def df_matmul_trisym(X, Y):
    """Lower-triangle rows of C = X Y (X: (p, k, *b), Y: (k, p, *b)),
    assembled to the full symmetric matrix (e.g. A (D A') with D
    symmetric)."""
    Xh, Xl = X
    Yh, Yl = Y
    p, kdim = Xh.shape[0], Xh.shape[1]
    rows = []
    for i in range(p):
        acc = None
        for k in range(kdim):
            xk = (Xh[i, k][None], Xl[i, k][None])  # (1, *b)
            yk = (Yh[k, : i + 1], Yl[k, : i + 1])  # (i+1, *b)
            acc = _acc_step(acc, xk, yk)
        rows.append(quick_two_sum(*acc))
    return _sym_from_tri(rows)


def df_matmul_nt_trisym(X, Y):
    """Lower-triangle rows of C = X Y' (X: (p, k, *b), Y: (p, k, *b)),
    assembled to the full symmetric matrix (e.g. (C G) C' with G
    symmetric)."""
    Xh, Xl = X
    Yh, Yl = Y
    p, kdim = Xh.shape[0], Xh.shape[1]
    rows = []
    for i in range(p):
        acc = None
        for k in range(kdim):
            xk = (Xh[i, k][None], Xl[i, k][None])  # (1, *b)
            yk = (Yh[: i + 1, k], Yl[: i + 1, k])  # (i+1, *b)
            acc = _acc_step(acc, xk, yk)
        rows.append(quick_two_sum(*acc))
    return _sym_from_tri(rows)


def df_outer_trisym(x, y):
    """Symmetric rank-1 outer product x y' from its lower triangle
    (x, y: df (p, 1, *b) column pairs, y a scalar multiple of x)."""
    xh, xl = x
    yh, yl = y
    p = xh.shape[0]
    rows = []
    for i in range(p):
        xi = (xh[i], xl[i])  # (1, *b)
        yi = (yh[: i + 1, 0], yl[: i + 1, 0])  # (i+1, *b)
        ph, pe = two_prod(xi[0], yi[0])
        pe = pe + (xi[0] * yi[1] + xi[1] * yi[0])
        rows.append(quick_two_sum(ph, pe))
    return _sym_from_tri(rows)


def df_gj_solve_elast(A, jitter: float, eye):
    """Solve (A + jitter I) y = e_last for the LAST unit vector in df32; GJ
    elimination on a (p, p+1, b) augmented system (≈ half the work of the
    full inverse). Returns y as a df (p, 1, b) pair."""
    Ah, Al = A
    p = Ah.shape[0]
    jh, jl = two_sum(Ah, jitter * eye)
    rhs = eye[:, p - 1 : p, :]  # (p, 1, b) = e_last
    Mh = jnp.concatenate([jh, rhs], axis=1)  # (p, p+1, b)
    Ml = jnp.concatenate([Al + jl, jnp.zeros_like(rhs)], axis=1)
    rows = [(Mh[i], Ml[i]) for i in range(p)]
    for i in range(p):
        piv = (rows[i][0][i][None, :], rows[i][1][i][None, :])
        inv_piv = df_recip(piv)
        r = df_mul(rows[i], inv_piv)
        new_rows = []
        for j in range(p):
            if j == i:
                new_rows.append(r)
            else:
                coeff = (rows[j][0][i][None, :], rows[j][1][i][None, :])
                new_rows.append(df_sub(rows[j], df_mul(coeff, r)))
        rows = new_rows
    yh = jnp.stack([rows[i][0][p:] for i in range(p)], axis=0)  # (p, 1, b)
    yl = jnp.stack([rows[i][1][p:] for i in range(p)], axis=0)
    return yh, yl


def df_scale_rows(X, s):
    """Row-scale a df (p, q, b) matrix by a df (p, 1, b) vector: out[i] =
    X[i] * s[i] (broadcast over q)."""
    Xh, Xl = X
    sh, sl = s
    ph, pe = two_prod(Xh, sh)
    pe = pe + (Xh * sl + Xl * sh)
    return quick_two_sum(ph, pe)


def df_ldl(A, jitter: float, eye):
    """Unpivoted LDL' factorization of an SPD df32 (p, p, b) matrix
    + jitter*I (same pivot sequence as the pivot-free GJ elimination, ~p^3/6
    of its work). Returns (L, d, inv_d): L unit-lower (p, p, b) df pair
    (explicit unit diagonal, zero strict upper), d the pivots (p, 1, b) df,
    inv_d their df reciprocals (p, 1, b).

    Replaces df_gj_inv wherever only the *action* of the inverse is needed:
    (A+jI)^-1 R = L'^-1 (inv_d * (L^-1 R)), and quadratic forms
    R'(A+jI)^-1 R = U' (inv_d * U) with U = L^-1 R (df_trisolve_*)."""
    Ah, Al = A
    p = Ah.shape[0]
    # fold the jitter in exactly (see df_gj_inv)
    jh, jl = two_sum(Ah, jitter * eye)
    rows = [(jh[i], jl[i] + Al[i]) for i in range(p)]  # each (p, b)
    zero = jnp.zeros_like(rows[0][0][:1])  # (1, b)
    one = jnp.ones_like(zero)
    Lcoef = [[None] * p for _ in range(p)]
    dh, dl, idh, idl = [], [], [], []
    for i in range(p):
        # renormalize the pivot row before it is read p-i times: severe
        # cancellation (small pivots from large entries, kappa ~ 1e5) leaves
        # the sloppy lo comparable to hi, which breaks the normalized-input
        # assumption of df_recip/df_mul
        rows[i] = two_sum(rows[i][0], rows[i][1])
        piv = (rows[i][0][i][None, :], rows[i][1][i][None, :])
        inv_piv = df_recip(piv)
        dh.append(piv[0])
        dl.append(piv[1])
        idh.append(inv_piv[0])
        idl.append(inv_piv[1])
        for j in range(i + 1, p):
            c = two_sum(rows[j][0][i][None, :], rows[j][1][i][None, :])
            lji = df_mul(c, inv_piv)
            Lcoef[j][i] = lji
            # sloppy row update: exact product hi, loose lo accumulation
            ph, pe = two_prod(lji[0], rows[i][0])
            pe = pe + (lji[0] * rows[i][1] + lji[1] * rows[i][0])
            sh, se = two_sum(rows[j][0], -ph)
            rows[j] = (sh, rows[j][1] - pe + se)
    Lh_rows, Ll_rows = [], []
    for j in range(p):
        hs, ls = [], []
        for i in range(p):
            if i < j:
                hs.append(Lcoef[j][i][0])
                ls.append(Lcoef[j][i][1])
            elif i == j:
                hs.append(one)
                ls.append(zero)
            else:
                hs.append(zero)
                ls.append(zero)
        Lh_rows.append(jnp.concatenate(hs, axis=0))
        Ll_rows.append(jnp.concatenate(ls, axis=0))
    L = (jnp.stack(Lh_rows, axis=0), jnp.stack(Ll_rows, axis=0))
    d = (jnp.stack(dh, axis=0), jnp.stack(dl, axis=0))
    inv_d = (jnp.stack(idh, axis=0), jnp.stack(idl, axis=0))
    return L, d, inv_d


def _df_trisolve_rows(L, rhs_rows):
    """Forward-substitute L X = RHS for unit-lower df L given the RHS as a
    list of p df (q, b) rows; returns X rows (list of df (q, b)).

    Right-looking: once x_i is final, all remaining rows update with
    INDEPENDENT df-FMAs (the left-looking form chains i dependent small ops
    per row, which stalls the VPU pipeline — measured 30% slower end-to-end
    despite identical flops)."""
    Lh, Ll = L
    p = Lh.shape[0]
    rows = list(rhs_rows)
    xs = []
    for i in range(p):
        # exact two_sum normalization: under cancellation |lo| can exceed
        # |hi|, and the normalized x_i is read up to p-1 times
        xi = two_sum(rows[i][0], rows[i][1])
        xs.append(xi)
        for j in range(i + 1, p):
            lji = (Lh[j, i][None, :], Ll[j, i][None, :])
            ph, pe = two_prod(lji[0], xi[0])
            pe = pe + (lji[0] * xi[1] + lji[1] * xi[0])
            sh, se = two_sum(rows[j][0], -ph)
            rows[j] = (sh, rows[j][1] - pe + se)
    return xs


def _stack_rows(rows):
    return (
        jnp.stack([r[0] for r in rows], axis=0),
        jnp.stack([r[1] for r in rows], axis=0),
    )


def df_trisolve_unit_lower(L, B):
    """Solve L X = B, L unit-lower df (p, p, b), B df (p, q, b)."""
    Bh, Bl = B
    p = Bh.shape[0]
    return _stack_rows(_df_trisolve_rows(L, [(Bh[i], Bl[i]) for i in range(p)]))


def df_trisolve_unit_lower_bt(L, A):
    """Solve L X = A' (A df (q, p, b)) without materializing the transpose:
    RHS row i is A[:, i, :]."""
    Ah, Al = A
    p = Ah.shape[1]
    return _stack_rows(_df_trisolve_rows(L, [(Ah[:, i, :], Al[:, i, :]) for i in range(p)]))


def df_trisolve_unit_lower_t(L, B):
    """Back-substitute L' X = B, L unit-lower df (p, p, b), B df (p, q, b).
    Right-looking (see _df_trisolve_rows)."""
    Lh, Ll = L
    Bh, Bl = B
    p = Lh.shape[0]
    rows = [(Bh[i], Bl[i]) for i in range(p)]
    xs = [None] * p
    for i in range(p - 1, -1, -1):
        xi = two_sum(rows[i][0], rows[i][1])
        xs[i] = xi
        for j in range(i):
            # (L')[j, i] = L[i, j]
            lij = (Lh[i, j][None, :], Ll[i, j][None, :])
            ph, pe = two_prod(lij[0], xi[0])
            pe = pe + (lij[0] * xi[1] + lij[1] * xi[0])
            sh, se = two_sum(rows[j][0], -ph)
            rows[j] = (sh, rows[j][1] - pe + se)
    return _stack_rows(xs)


# rows-list RHS utilities: build (possibly merged) trisolve right-hand sides
# without materializing transposes — one L-chain walk serves several RHS
# matrices at double slab width.


def df_rows(B):
    return [(B[0][i], B[1][i]) for i in range(B[0].shape[0])]


def df_rows_bt(A):
    """Rows of A' without a transpose: row i is A[:, i, :]."""
    return [(A[0][:, i, :], A[1][:, i, :]) for i in range(A[0].shape[1])]


def df_rows_concat(ra, rb):
    return [
        (jnp.concatenate([a[0], b[0]], axis=0), jnp.concatenate([a[1], b[1]], axis=0))
        for a, b in zip(ra, rb)
    ]


def df_trisolve_unit_lower_rows(L, rows):
    """Solve L X = RHS given RHS as a list of df (q, b) rows."""
    return _stack_rows(_df_trisolve_rows(L, rows))


def df_sym(X):
    h, l = X
    half = 0.5
    return (
        half * (h + h.swapaxes(0, 1)) + half * (l + l.swapaxes(0, 1)),
        jnp.zeros_like(h),
    )


def df_gj_inv(A, jitter: float, eye):
    """Pivot-free Gauss-Jordan inverse of a df32 (p, p, b) matrix + jitter*I.

    `eye` is the f32 identity of matching shape. Row-list formulation; one
    df reciprocal per pivot, df FMAs for the row updates.
    """
    Ah, Al = A
    p = Ah.shape[0]
    # fold the jitter in exactly (a plain f32 add would discard a rounding
    # residual that, kappa-amplified, costs ~7 digits of the df accuracy)
    jh, jl = two_sum(Ah, jitter * eye)
    Mh = jnp.concatenate([jh, eye], axis=1)  # (p, 2p, b)
    Ml = jnp.concatenate([Al + jl, jnp.zeros_like(eye)], axis=1)
    rows = [(Mh[i], Ml[i]) for i in range(p)]  # each (2p, b)
    for i in range(p):
        piv = (rows[i][0][i][None, :], rows[i][1][i][None, :])
        inv_piv = df_recip(piv)
        r = df_mul(rows[i], inv_piv)
        new_rows = []
        for j in range(p):
            if j == i:
                new_rows.append(r)
            else:
                coeff = (rows[j][0][i][None, :], rows[j][1][i][None, :])
                new_rows.append(df_sub(rows[j], df_mul(coeff, r)))
        rows = new_rows
    Ih = jnp.stack([rows[i][0][p:] for i in range(p)], axis=0)
    Il = jnp.stack([rows[i][1][p:] for i in range(p)], axis=0)
    return Ih, Il


def df_gj_inv_pivots(A, jitter: float, eye):
    """Like df_gj_inv but also returns the stacked pivot hi-parts (p, b) —
    positive pivots certify SPD-ness (jittable Cholesky-check analogue)."""
    Ah, Al = A
    p = Ah.shape[0]
    jh, jl = two_sum(Ah, jitter * eye)
    Mh = jnp.concatenate([jh, eye], axis=1)
    Ml = jnp.concatenate([Al + jl, jnp.zeros_like(eye)], axis=1)
    rows = [(Mh[i], Ml[i]) for i in range(p)]
    pivots = []
    for i in range(p):
        piv = (rows[i][0][i][None, :], rows[i][1][i][None, :])
        pivots.append(piv[0][0])
        inv_piv = df_recip(piv)
        r = df_mul(rows[i], inv_piv)
        new_rows = []
        for j in range(p):
            if j == i:
                new_rows.append(r)
            else:
                coeff = (rows[j][0][i][None, :], rows[j][1][i][None, :])
                new_rows.append(df_sub(rows[j], df_mul(coeff, r)))
        rows = new_rows
    Ih = jnp.stack([rows[i][0][p:] for i in range(p)], axis=0)
    Il = jnp.stack([rows[i][1][p:] for i in range(p)], axis=0)
    return (Ih, Il), jnp.stack(pivots, axis=0)  # pivots: (p, b)


def df_sym_half(X):
    """0.5 (X + X^T) in df (proper df add of the transpose)."""
    h, l = X
    t = (h.swapaxes(0, 1), l.swapaxes(0, 1))
    s = df_add(X, t)
    return df_mul_f32(s, 0.5)
