"""Compensated (double-single "df32") forward rollouts.

Why: an f32 solve cannot use fp64; a plain-f32 rollout re-rounds the *full
state* every step (noise eps32*|x| per step), and for long strongly-nonlinear
horizons the dynamics amplify that noise exponentially — the cartpole
swing-up (N=360) lands in a different local optimum than the f64 solve
(measured: T*=85/J=1691 f32 vs T*=181/J=117.5 f64 on identical inputs).
This module gives the f32 forward pass extended precision (docs/DESIGN.md
§5). f64 solves do not use it.

Design: the state is carried as an unevaluated f32 pair (hi, lo) ≈ 48
mantissa bits. Each step integrates the system's *native increment*
dt*xdot(x,u) (models/base.py `System.xdot`) with an exact TwoSum update, so
per-step rounding is O(eps32*|dt*xdot|) — ~1/ (dt*||df/dx||) smaller than
re-rounding x. A jvp term propagates the lo half through the dynamics
(xdot(hi+lo) ≈ xdot(hi) + J·lo), keeping the leftover error second order.
Angle wrapping subtracts an exact df32 multiple of 2π instead of the
(+π mod 2π)−π form, which would re-round at eps32*π.

Only hi leaves the rollout: downstream consumers (cost, linearization,
storage between outer iterations) only need f32-relative accuracy of a
*given* trajectory; it is the step-to-step error feedback inside one rollout
that must stay extended-precision.

Reference counterparts: rollout (reference solver.py:42-62) and the
line-search rollout (reference solver.py:233-286) — both fp64 there.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from timeopt.models.base import Problem, System
from timeopt.ops.precision import full_matmul_precision
from timeopt.ops.df32 import df_add, quick_two_sum, two_prod
from timeopt.ops.wrap import wrap_error

_TWO_PI = 2.0 * np.pi
TWO_PI_HI = np.float32(_TWO_PI)
TWO_PI_LO = np.float32(_TWO_PI - np.float64(TWO_PI_HI))
INV_TWO_PI = np.float32(1.0 / _TWO_PI)


def supports_df(system: System) -> bool:
    return system.xdot is not None


def _wrap_vec(system: System, n: int):
    mask = np.zeros(n, dtype=np.float32)
    for i in system.wrap_idx or ():
        mask[int(i)] = 1.0
    return jnp.asarray(mask)


def _df_wrap(xh, xl, wrap_vec):
    """Subtract the nearest df32 multiple of 2π from the wrapped components.
    k is a small integer (|k| <= a few), so k*(TWO_PI_HI, TWO_PI_LO) is
    representable exactly via TwoProd; the state keeps its full hi/lo
    accuracy across the wrap (unlike angle_normalize, which re-rounds at
    eps*π). Ends in [-π, π] — a measure-zero boundary difference from the
    reference's (-π, π]."""
    k = jnp.round(xh * INV_TWO_PI) * wrap_vec
    ph, pe = two_prod(k, TWO_PI_HI)
    return df_add((xh, xl), (-ph, -(pe + k * TWO_PI_LO)))


def df_step(system: System, xh, xl, u, *, norm_guard: bool, wrap_vec):
    """One compensated Euler step. Matches `step` + (optionally) `safe_step`
    poisoning semantics: the model guard is evaluated on the input like the
    reference's in-dynamics guards (reference systems.py:165-191);
    `norm_guard` adds the rollout-level divergence poison
    (reference solver.py:54-59)."""
    dt64 = float(system.dt)
    dt_hi = jnp.asarray(np.float32(dt64), xh.dtype)
    dt_lo = jnp.asarray(np.float32(dt64 - float(np.float32(dt64))), xh.dtype)
    d, dj = jax.jvp(lambda x: system.xdot(x, u), (xh,), (xl,))
    # dt is carried as an f32 hi/lo pair and dt*d formed with an exact
    # TwoProd: both the per-step rounding of the product AND the systematic
    # f32 rounding of dt itself (which acts as a time-scale perturbation of
    # the whole discrete system, measured 3.7e-7 over a 120-step
    # double-integrator rollout) stay out of the state. The remaining floor
    # is the f32 evaluation of xdot (model constants, transcendentals).
    ph, pe = two_prod(dt_hi, d)
    nh, nl = df_add((xh, xl), (ph, pe + (dt_hi * dj + dt_lo * d)))
    if system.wrap_idx:
        nh, nl = _df_wrap(nh, nl, wrap_vec)

    bad = jnp.asarray(False)
    if system.guard is not None:
        bad = bad | system.guard(xh, u)
    if norm_guard:
        bad = bad | (~jnp.all(jnp.isfinite(nh))) | (
            jnp.sqrt(jnp.sum(jnp.square(nh))) > 1e6
        )
    poison = jnp.where(bad, jnp.asarray(jnp.nan, nh.dtype), jnp.asarray(0.0, nh.dtype))
    return nh + poison, nl + poison


@full_matmul_precision
def rollout_df(system: System, prob: Problem, x0: jax.Array, U: jax.Array) -> jax.Array:
    """df32 analogue of cost.rollout (same NaN-poisoning semantics)."""
    wrap_vec = _wrap_vec(system, prob.n)

    def f(carry, u):
        xh, xl = carry
        nh, nl = df_step(system, xh, xl, u, norm_guard=True, wrap_vec=wrap_vec)
        return (nh, nl), nh

    _, Xtail = lax.scan(f, (x0, jnp.zeros_like(x0)), U)
    return jnp.concatenate([x0[None, :], Xtail], axis=0)


@full_matmul_precision
def rollout_with_gains_df(
    system: System,
    prob: Problem,
    X: jax.Array,
    U: jax.Array,
    K: jax.Array,
    kappa: jax.Array,
    T_star: jax.Array,
    alpha: jax.Array,
):
    """df32 analogue of forward.rollout_with_gains: closed-loop on [0, T*),
    nominal controls beyond (reference solver.py:274-279). The state
    deviation dx is formed from the full hi/lo pair (wrap via the df
    multiple-of-2π subtraction), so the feedback sees the extended-precision
    state; u itself is f32 — its rounding enters only through dt*xdot."""
    ks = jnp.arange(prob.N)
    wrap_vec = _wrap_vec(system, prob.n)

    def f(carry, inp):
        xh, xl = carry
        k, Xk, Uk, Kk, kapk = inp
        active = k < T_star
        dh, dl = _df_wrap(xh - Xk, xl, jnp.asarray(prob.wrap_mask, xh.dtype))
        dx = dh + dl
        du = Kk @ dx + alpha * kapk
        u = Uk + jnp.where(active, du, jnp.zeros_like(du))
        nh, nl = df_step(system, xh, xl, u, norm_guard=False, wrap_vec=wrap_vec)
        return (nh, nl), (nh, u)

    _, (Xtail, Un) = lax.scan(
        f, (X[0], jnp.zeros_like(X[0])), (ks, X[:-1], U, K, kappa)
    )
    Xn = jnp.concatenate([X[:1], Xtail], axis=0)
    return Xn, Un
