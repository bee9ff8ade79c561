"""Forward pass with line search, vectorized over step sizes.

Reference counterpart: forward_linesearch_fixedT
(reference solver.py:233-286). The reference tries step sizes
sequentially and stops at the first improvement; here all candidate alphas
roll out concurrently under `vmap` (fixed shapes, no early exit) and the
*first* improving alpha in the original ordering is selected — identical
accept semantics, better hardware shape (the alpha axis batches with the
problem axis).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from timeopt.models.base import Problem, System
from timeopt.ops.precision import full_matmul_precision
from timeopt.ops.wrap import wrap_error
from timeopt.solver.cost import cost_true


class LinesearchResult(NamedTuple):
    X: jax.Array
    U: jax.Array
    J: jax.Array
    accepted: jax.Array  # () bool


def rollout_with_gains(
    system: System,
    prob: Problem,
    X: jax.Array,
    U: jax.Array,
    K: jax.Array,
    kappa: jax.Array,
    T_star: jax.Array,
    alpha: jax.Array,
):
    """Roll x+ = f(x, u + [k<T*](K wrap(x - x̄) + alpha kappa)); controls keep
    their nominal values beyond T* (reference solver.py:274-279).
    Uses the raw step (finite-ness is judged on the whole trajectory by the
    caller, as in the reference)."""
    ks = jnp.arange(prob.N)

    def f(x, inp):
        k, Xk, Uk, Kk, kapk = inp
        active = k < T_star
        dx = wrap_error(x - Xk, prob.wrap_mask)
        du = Kk @ dx + alpha * kapk
        u = Uk + jnp.where(active, du, jnp.zeros_like(du))
        xn = system.step(x, u)
        return xn, (xn, u)

    _, (Xtail, Un) = lax.scan(f, X[0], (ks, X[:-1], U, K, kappa))
    Xn = jnp.concatenate([X[:1], Xtail], axis=0)
    return Xn, Un


def _linesearch_impl(system, prob, X, U, K, kappa, T_star, J_old, alphas, roll):
    """Shared all-alphas evaluation + first-improving selection (the
    reference-parity accept rule, reference solver.py:247-284) for both
    the plain and the df32 rollout."""

    def try_alpha(a):
        Xn, Un = roll(system, prob, X, U, K, kappa, T_star, a)
        # reference rejects an alpha whose rollout goes non-finite anywhere
        # on [0, N], even beyond T* (reference solver.py:267-280)
        finite = jnp.all(jnp.isfinite(Xn))
        Jn = cost_true(system, prob, Xn, Un, T_star)
        Jn = jnp.where(finite, Jn, jnp.asarray(jnp.inf, Jn.dtype))
        return Xn, Un, Jn

    a_vec = jnp.asarray(alphas, dtype=X.dtype)
    Xs, Us, Js = jax.vmap(try_alpha)(a_vec)

    improved = Js < J_old
    accepted = jnp.any(improved)
    idx = jnp.argmax(improved)  # first improving alpha, preserving order
    Xn = jnp.where(accepted, Xs[idx], X)
    Un = jnp.where(accepted, Us[idx], U)
    Jn = jnp.where(accepted, Js[idx], J_old)
    return Xn, Un, Jn, accepted


@full_matmul_precision
def forward_linesearch(
    system: System,
    prob: Problem,
    X: jax.Array,
    U: jax.Array,
    K: jax.Array,
    kappa: jax.Array,
    T_star: jax.Array,
    alphas=(1.0, 0.5, 0.25, 0.1, 0.05),
    df_forward: bool = False,
) -> LinesearchResult:
    if df_forward:
        from timeopt.solver.rollout_df import rollout_with_gains_df as _roll
    else:
        _roll = rollout_with_gains

    J_old = cost_true(system, prob, X, U, T_star)
    Xn, Un, Jn, accepted = _linesearch_impl(
        system, prob, X, U, K, kappa, T_star, J_old, alphas, _roll
    )
    return LinesearchResult(X=Xn, U=Un, J=Jn, accepted=accepted)
