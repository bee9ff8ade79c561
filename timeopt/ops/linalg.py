"""Small-matrix linear algebra for batched solves.

The workload inverts/solves chains of tiny symmetric matrices ((n+1) <= 13)
batched over time steps and over thousands of independent problems. LAPACK-style
factorizations with per-element pivot searches do not vectorize across such a
batch, so the core primitive here is an *unrolled, pivot-free Gauss-Jordan elimination*:
n static elimination steps, each a rank-1 update over the trailing two axes.
Every operation is a broadcasted elementwise multiply-add, so under `vmap`
/ `scan` the batch dimension maps straight onto vector lanes.

For symmetric positive-definite inputs (all inputs here are PD by
construction: regularized cost blocks, information matrices with positive
Schur complements), elimination without pivoting is numerically sound — the
pivots are the positive Schur-complement diagonals, which we also expose for
SPD checks (this replaces the reference's `np.linalg.cholesky` try/except at
reference solver.py:213-216).

Robustness model (replacing reference utils.py:69-120's jitter-escalation
loops, which are data-dependent control flow and hence not jittable): a fixed
jitter *ladder*. Level 0 uses the base jitter; each further level multiplies
the jitter by 1e4 and is only selected where the previous level produced
non-finite output. All levels are computed unconditionally (branchless — under
vmap a per-problem branch would be a select anyway); the number of levels is a
static compile-time knob so the fast path can use a single level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def sym(A: jax.Array) -> jax.Array:
    """Symmetrize: 0.5 (A + A^T) over the trailing two axes."""
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))


def _eye_like(A: jax.Array) -> jax.Array:
    n = A.shape[-1]
    return jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)


def gj_inv_pivots(A: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Pivot-free Gauss-Jordan inverse of (..., n, n).

    Returns (A_inv, pivots) where pivots has shape (..., n): the elimination
    pivots (Schur-complement diagonals). For a symmetric matrix, A is PD iff
    all pivots are strictly positive (same information as an LDL^T / Cholesky
    factorization succeeding).
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, _eye_like(A)], axis=-1)  # (..., n, 2n)
    pivots = []
    for i in range(n):
        piv = M[..., i, i]
        pivots.append(piv)
        row = M[..., i, :] / piv[..., None]  # (..., 2n)
        col = M[..., :, i]  # (..., n)
        M = M - col[..., :, None] * row[..., None, :]
        M = M.at[..., i, :].set(row)
    return M[..., :, n:], jnp.stack(pivots, axis=-1)


def gj_inv(A: jax.Array) -> jax.Array:
    return gj_inv_pivots(A)[0]


def gj_solve(A: jax.Array, B: jax.Array) -> jax.Array:
    """Solve A X = B via pivot-free Gauss-Jordan on the augmented system.

    A: (..., n, n); B: (..., n, k) or (..., n). Cheaper than inverse+matmul
    when k < n, and avoids materializing the inverse.
    """
    vec = B.ndim == A.ndim - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    M = jnp.concatenate([A, B], axis=-1)  # (..., n, n+k)
    for i in range(n):
        piv = M[..., i, i]
        row = M[..., i, :] / piv[..., None]
        col = M[..., :, i]
        M = M - col[..., :, None] * row[..., None, :]
        M = M.at[..., i, :].set(row)
    X = M[..., :, n:]
    return X[..., 0] if vec else X


def _ladder(fn, A: jax.Array, jitter: float, levels: int):
    """Apply `fn(A + eps*I)` over a fixed jitter ladder, selecting the first
    finite result per batch element. Branchless; `levels` is static."""
    A = sym(A)
    I = _eye_like(A)
    out = fn(A + jnp.asarray(jitter, A.dtype) * I)
    if levels <= 1:
        return out
    for lv in range(1, levels):
        eps = jnp.asarray(jitter * (1e4**lv), A.dtype)
        nxt = fn(A + eps * I)
        ok = jnp.all(jnp.isfinite(out), axis=(-2, -1), keepdims=True)
        out = jnp.where(ok, out, nxt)
    return out


def psd_inv(A: jax.Array, jitter: float = 1e-9, levels: int = 2) -> jax.Array:
    """Inverse of a symmetric (nominally PD) matrix with a fixed jitter ladder.

    Reference counterpart: `chol_inv` (reference utils.py:69-93) — there,
    jitter escalates x10 up to 8 tries with an LU fallback; here a static
    ladder of `levels` rungs spaced 1e4 apart covers the same range without
    data-dependent control flow.
    """
    return _ladder(gj_inv, A, jitter, levels)


def psd_solve(A: jax.Array, B: jax.Array, jitter: float = 1e-9, levels: int = 2) -> jax.Array:
    """Solve A X = B for symmetric (nominally PD) A with a jitter ladder.

    Reference counterpart: `chol_solve` (reference utils.py:96-120).
    Unlike the reference (which raises after the ladder), failures surface as
    non-finite values that downstream accept/reject logic treats as rejection
    — the jittable analogue of the reference's typed-exception policy.
    """
    vec = B.ndim == A.ndim - 1
    Bm = B[..., None] if vec else B

    def f(Areg):
        return gj_solve(Areg, Bm)

    X = _ladder(f, A, jitter, levels)
    return X[..., 0] if vec else X


def spd_check(A: jax.Array) -> jax.Array:
    """True where the symmetric matrix (..., n, n) is SPD (finite, positive
    elimination pivots). Jittable replacement for a try/except Cholesky."""
    _, piv = gj_inv_pivots(sym(A))
    finite = jnp.all(jnp.isfinite(A), axis=(-2, -1))
    return finite & jnp.all(piv > 0, axis=-1) & jnp.all(jnp.isfinite(piv), axis=-1)


def chol_lower(A: jax.Array) -> jax.Array:
    """Unrolled batched Cholesky factor L (A = L L^T) of (..., n, n) SPD
    matrices — right-looking outer-product form, n static steps of
    broadcasted elementwise ops (same batch-vectorization rationale as
    gj_inv)."""
    n = A.shape[-1]
    M = sym(A)
    idx = jnp.arange(n)
    cols = []
    for j in range(n):
        d = jnp.sqrt(M[..., j, j])
        c = M[..., :, j] / d[..., None]
        c = c * (idx >= j)
        M = M - c[..., :, None] * c[..., None, :]
        cols.append(c)
    return jnp.stack(cols, axis=-1)


def as_terminal_weight(alpha, n: int, dtype=np.float64) -> np.ndarray:
    """Host-side helper: scalar / diag-vector / matrix terminal weight -> (n, n).

    Reference counterpart: reference utils.py:49-62. Runs at problem
    construction time (NumPy), so the traced program only ever sees a full
    (n, n) terminal weight matrix.
    """
    A = np.asarray(alpha, dtype=dtype)
    if A.ndim == 0:
        return (float(A) * np.eye(n)).astype(dtype)
    if A.ndim == 1:
        if A.shape[0] != n:
            raise ValueError(f"terminal weight vector has shape {A.shape}, expected ({n},)")
        return np.diag(A).astype(dtype)
    if A.ndim == 2:
        if A.shape != (n, n):
            raise ValueError(f"terminal weight matrix has shape {A.shape}, expected ({n},{n})")
        return (0.5 * (A + A.T)).astype(dtype)
    raise ValueError(f"unsupported terminal weight ndim={A.ndim}")
