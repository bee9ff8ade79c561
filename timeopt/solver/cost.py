"""Objective evaluation: rollout, stage costs, truncated true cost, nominal
cost curve — all static-shape, masked at a traced horizon T*.

Reference counterparts: rollout (reference solver.py:42-62),
cost_timeopt_true (reference solver.py:65-105), nominal_cost_curve
(reference solver.py:108-149).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from timeopt.models.base import Problem, System
from timeopt.ops.precision import full_matmul_precision
from timeopt.ops.wrap import wrap_error


def rollout(system: System, prob: Problem, x0: jax.Array, U: jax.Array) -> jax.Array:
    """Forward rollout with divergence poisoning (`safe_step`): once a state
    goes non-finite / exceeds the norm guard, all later states are NaN —
    matching the reference's break-and-fill-NaN semantics
    (reference solver.py:54-61) without data-dependent control flow.
    """

    def f(x, u):
        xn = system.safe_step(x, u)
        # NaN propagates: once poisoned, stays poisoned
        return xn, xn

    _, Xtail = lax.scan(f, x0, U)
    return jnp.concatenate([x0[None, :], Xtail], axis=0)


def extra_cost_terms(system: System, X: jax.Array, U: jax.Array):
    """Per-step (c, cx, cxx) of the optional extra stage cost via AD.

    The reference takes a user-supplied analytic triple
    (reference systems.py:271-293); here `jax.grad` / `jax.hessian` of
    the scalar penalty give the exact triple, vmapped over the trajectory.
    Returns None if the system has no extra cost.
    """
    if system.extra_cost is None:
        return None
    fn = system.extra_cost
    c = jax.vmap(fn)(X, U)
    cx = jax.vmap(jax.grad(fn, argnums=0))(X, U)
    cxx = jax.vmap(jax.hessian(fn, argnums=0))(X, U)
    return c, cx, cxx


@full_matmul_precision
def stage_costs(system: System, prob: Problem, X: jax.Array, U: jax.Array) -> jax.Array:
    """l_k = 0.5 e_k'Q e_k + 0.5 du_k'R du_k + w (+ extra), k = 0..N-1."""
    e = wrap_error(X[:-1] - prob.xg, prob.wrap_mask)  # (N, n)
    du = U - prob.u_ref  # (N, m)
    l = (
        0.5 * jnp.einsum("ki,ij,kj->k", e, prob.Q, e)
        + 0.5 * jnp.einsum("ki,ij,kj->k", du, prob.R, du)
        + prob.w
    )
    if system.extra_cost is not None:
        l = l + jax.vmap(system.extra_cost)(X[:-1], U)
    return l


@full_matmul_precision
def terminal_cost(prob: Problem, xT: jax.Array) -> jax.Array:
    eT = wrap_error(xT - prob.xg, prob.wrap_mask)
    return 0.5 * eT @ (prob.Qf @ eT)


@full_matmul_precision
def cost_true(
    system: System, prob: Problem, X: jax.Array, U: jax.Array, T_star: jax.Array
) -> jax.Array:
    """Exact objective truncated at (traced) T*: masked running sum over
    k < T* plus terminal at X[T*]. Non-finite states/controls inside the
    active window -> +inf (reference solver.py:83-103)."""
    N = prob.N
    k = jnp.arange(N)
    active = k < T_star
    l = stage_costs(system, prob, X, U)
    masked = jnp.where(active, l, jnp.zeros_like(l))

    xT = jnp.take(X, T_star, axis=0, mode="clip")
    term = terminal_cost(prob, xT)
    if X.dtype == jnp.float32:
        # compensated accumulation: a plain f32 tree-sum of ~N stage terms
        # carries O(log N * eps * J) ~ 2e-4 relative noise (measured at
        # B=1024 quadrotor) — the same scale as the accept/convergence
        # comparisons this value feeds. df32 keeps the cost consistent with
        # the f64 reference semantics.
        from timeopt.ops.df32 import df_add, df_sum

        sh, sl = df_add(df_sum(masked, axis=0), (term, jnp.zeros_like(term)))
        total = sh + sl
    else:
        total = jnp.sum(masked) + term

    x_ok = jnp.all(
        jnp.where(jnp.arange(N + 1) <= T_star, jnp.all(jnp.isfinite(X), axis=-1), True)
    )
    u_ok = jnp.all(jnp.where(active, jnp.all(jnp.isfinite(U), axis=-1), True))
    ok = x_ok & u_ok & (T_star > 0) & jnp.isfinite(total)
    return jnp.where(ok, total, jnp.asarray(jnp.inf, total.dtype))


@full_matmul_precision
def nominal_cost_curve(system: System, prob: Problem, X: jax.Array, U: jax.Array) -> jax.Array:
    """J_nom(T) for T = 1..T_max of the current nominal (running cumsum +
    terminal at each step); +inf below T_min or when the nominal is
    non-finite. Used only to seed T̄ for the one-pass baseline
    (reference solver.py:108-149)."""
    T_max = prob.T_max
    l = stage_costs(system, prob, X, U)[:T_max]  # (T_max,)
    run = jnp.cumsum(l)  # run[T-1] = sum_{k<T} l_k
    term = jax.vmap(lambda x: terminal_cost(prob, x))(X[1 : T_max + 1])
    J = run + term
    Ts = jnp.arange(1, T_max + 1)
    ok = jnp.all(jnp.isfinite(X[: T_max + 1])) & jnp.all(jnp.isfinite(U[:T_max]))
    J = jnp.where((Ts >= prob.T_min) & ok & jnp.isfinite(J), J, jnp.inf)
    return J


def argmin_T(J_curve: jax.Array, T_min: int, T_max: int) -> jax.Array:
    """T* = argmin_{T in [T_min, T_max]} J(T) (first minimum, like np.argmin
    over the slice — reference solver.py:522)."""
    return jnp.argmin(J_curve[T_min - 1 : T_max]).astype(jnp.int32) + T_min
