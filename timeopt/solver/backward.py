"""Truncated iLQR backward pass as a masked reverse scan.

Reference counterpart: backward_pass_truncated (reference solver.py:156-230).
The horizon T* is a *traced* value: the scan always runs over the full static
N steps; the terminal expansion is injected where k+1 == T*, steps with
k >= T* pass the value function through unchanged, and their gains are zeroed.
SPD failure of Quu_reg at any active step clears the `ok` flag (the jittable
analogue of the reference's early `return None, None, False`).

The core is an array-only function (`_backward_arrays`); under a
problem-batch `vmap` XLA batches it like any other function.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from timeopt.models.base import Problem, System
from timeopt.ops.precision import full_matmul_precision
from timeopt.ops.linalg import gj_solve, spd_check, sym
from timeopt.ops.wrap import wrap_error
from timeopt.solver.cost import extra_cost_terms


class BackwardResult(NamedTuple):
    kappa: jax.Array  # (N, m) feedforward gains (zero where k >= T*)
    K: jax.Array  # (N, m, n) feedback gains
    ok: jax.Array  # () bool — all active steps SPD & finite


@full_matmul_precision
def stage_expansion(system: System, prob: Problem, X: jax.Array, U: jax.Array):
    """Per-step cost expansion terms along the trajectory:
    e, du, lx, lu, l0, Qstage — (N, ...) arrays."""
    e = wrap_error(X[:-1] - prob.xg, prob.wrap_mask)  # (N, n)
    du = U - prob.u_ref  # (N, m)
    lx = e @ prob.Q.T  # (N, n)
    lu = du @ prob.R.T  # (N, m)
    l0 = (
        0.5 * jnp.einsum("ki,ij,kj->k", e, prob.Q, e)
        + 0.5 * jnp.einsum("ki,ij,kj->k", du, prob.R, du)
        + prob.w
    )
    N = U.shape[0]
    Qstage = jnp.broadcast_to(prob.Q, (N,) + prob.Q.shape)

    extra = extra_cost_terms(system, X[:-1], U)
    if extra is not None:
        c, cx, cxx = extra
        l0 = l0 + c
        lx = lx + cx
        Qstage = sym(Qstage + cxx)
    return e, du, lx, lu, l0, Qstage


def _backward_arrays(A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok_in, Qf, R, T_star, lm_lambda):
    """Array-only masked reverse scan (unbatched reference implementation).

    QfeT[k] = Qf @ wrap(x_{k+1} - xg) (terminal gradient if T* == k+1);
    eT_ok[k] / step_ok_in[k]: finiteness flags (1.0/0.0)."""
    N, n = A.shape[0], A.shape[1]
    m = B.shape[2]
    dtype = A.dtype
    I_m = jnp.eye(m, dtype=dtype)

    def f(carry, inp):
        Vx, Vxx, ok = carry
        k, Ak, Bk, lxk, luk, Qsk, QfeTk, eTokk, sokk = inp

        is_term = (k + 1) == T_star
        Vx_in = jnp.where(is_term, QfeTk, Vx)
        Vxx_in = jnp.where(is_term, Qf, Vxx)
        ok = ok & jnp.where(is_term, eTokk > 0.5, True)

        Qx = lxk + Ak.T @ Vx_in
        Qu = luk + Bk.T @ Vx_in
        Qxx = Qsk + Ak.T @ Vxx_in @ Ak
        Quu = R + Bk.T @ Vxx_in @ Bk
        Qux = Bk.T @ Vxx_in @ Ak

        Quu_reg = sym(Quu) + lm_lambda * I_m
        pd = spd_check(Quu_reg)

        kap = -gj_solve(Quu_reg, Qu)
        Kk = -gj_solve(Quu_reg, Qux)

        Vx_new = Qx + Kk.T @ Qu + Qux.T @ kap + Kk.T @ (Quu @ kap)
        Vxx_new = sym(Qxx + Kk.T @ Qux + Qux.T @ Kk + Kk.T @ Quu @ Kk)

        active = k < T_star
        step_ok = (
            pd
            & (sokk > 0.5)
            & jnp.all(jnp.isfinite(Vx_new))
            & jnp.all(jnp.isfinite(Vxx_new))
        )
        ok = ok & jnp.where(active, step_ok, True)

        Vx_out = jnp.where(active, Vx_new, Vx_in)
        Vxx_out = jnp.where(active, Vxx_new, Vxx_in)
        zero = jnp.asarray(0.0, dtype)
        return (Vx_out, Vxx_out, ok), (
            jnp.where(active, kap, zero),
            jnp.where(active, Kk, zero),
        )

    init = (
        jnp.zeros(n, dtype=dtype),
        jnp.zeros((n, n), dtype=dtype),
        (T_star > 0),
    )
    ks = jnp.arange(N)
    (_, _, ok), (kappa, K) = lax.scan(
        f, init, (ks, A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok_in), reverse=True
    )
    return kappa, K, ok


@full_matmul_precision
def backward_truncated(
    system: System,
    prob: Problem,
    A: jax.Array,
    B: jax.Array,
    X: jax.Array,
    U: jax.Array,
    T_star: jax.Array,
    lm_lambda: jax.Array,
) -> BackwardResult:
    e, du, lx, lu, _, Qstage = stage_expansion(system, prob, X, U)
    # sym() is a bitwise no-op for already-symmetric inputs (0.5*(a+a) ==
    # a), so this costs nothing for every built-in model and makes
    # user-supplied asymmetric Q/R follow the symmetrized semantics.
    Qstage = sym(Qstage)
    QfT = sym(prob.Qf)
    eTs = wrap_error(X[1:] - prob.xg, prob.wrap_mask)  # (N, n)
    QfeT = eTs @ QfT.T
    dtype = X.dtype
    eT_ok = jnp.all(jnp.isfinite(eTs), axis=-1).astype(dtype)
    step_ok = (
        jnp.all(jnp.isfinite(e), axis=-1) & jnp.all(jnp.isfinite(du), axis=-1)
    ).astype(dtype)

    kappa, K, ok = _backward_arrays(
        A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok,
        QfT, sym(prob.R), T_star.astype(jnp.int32), jnp.asarray(lm_lambda, dtype),
    )
    return BackwardResult(kappa=kappa, K=K, ok=ok)
