"""Trajectory linearization: AD (default) and finite-difference (parity) modes.

The reference linearizes with per-dimension finite differences
(reference linearization.py:177-262) — its dominant wall-clock cost
(2.15 s of the 2.54 s quadrotor solve, reference plots/summary.csv:11).
The default here is one fused forward-mode AD pass (`jax.jacfwd` on the
combined (x, u) input): exact Jacobians, n+m tangents evaluated as one batched
program, vmapped over all N trajectory steps at once. The FD modes reproduce
the reference's stencils (including relative step sizes and NaN propagation)
for numerical-parity testing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def linearize_ad(step, X: jax.Array, U: jax.Array):
    """Exact Jacobians A_k = df/dx, B_k = df/du along (X, U) via jacfwd.

    X: (N+1, n); U: (N, m). Returns A: (N, n, n), B: (N, n, m).
    """
    n = X.shape[-1]

    def joint(xu):
        return step(xu[:n], xu[n:])

    def jac_one(x, u):
        J = jax.jacfwd(joint)(jnp.concatenate([x, u]))
        return J[:, :n], J[:, n:]

    return jax.vmap(jac_one)(X[:-1], U)


def _fd_steps(v: jax.Array, eps: float, rel: float) -> jax.Array:
    return jnp.maximum(eps, rel * jnp.maximum(1.0, jnp.abs(v)))


def linearize_fd(
    step,
    X: jax.Array,
    U: jax.Array,
    *,
    mode: str = "central",
    epsx: float = 1e-5,
    epsu: float = 1e-5,
    relx: float = 1e-6,
    relu: float = 1e-6,
):
    """Finite-difference Jacobians with relative per-dimension steps.

    mode="central": (f(x+h e_i) - f(x-h e_i)) / 2h — reference
      linearize_central_diff_traj (reference linearization.py:177-211).
    mode="forward": (f(x+h e_i) - f(x)) / h with NaN-poisoned rows when the
      base evaluation is non-finite — reference linearize_forward_diff_traj
      (reference linearization.py:216-262).
    """
    n = X.shape[-1]
    m = U.shape[-1]

    def one(x, u):
        hx = _fd_steps(x, epsx, relx)  # (n,)
        hu = _fd_steps(u, epsu, relu)  # (m,)
        Dx = jnp.eye(n, dtype=x.dtype) * hx  # row i = hx[i] * e_i
        Du = jnp.eye(m, dtype=u.dtype) * hu

        if mode == "central":
            fxp = jax.vmap(lambda d: step(x + d, u))(Dx)  # (n, n)
            fxm = jax.vmap(lambda d: step(x - d, u))(Dx)
            fup = jax.vmap(lambda d: step(x, u + d))(Du)  # (m, n)
            fum = jax.vmap(lambda d: step(x, u - d))(Du)
            A = ((fxp - fxm) / (2.0 * hx[:, None])).T
            B = ((fup - fum) / (2.0 * hu[:, None])).T
        elif mode == "forward":
            f0 = step(x, u)
            fxp = jax.vmap(lambda d: step(x + d, u))(Dx)
            fup = jax.vmap(lambda d: step(x, u + d))(Du)
            A = ((fxp - f0[None, :]) / hx[:, None]).T
            B = ((fup - f0[None, :]) / hu[:, None]).T
            # reference guard: non-finite base evaluation poisons the block
            bad = ~jnp.all(jnp.isfinite(f0))
            poison = jnp.where(bad, jnp.asarray(jnp.nan, x.dtype), jnp.asarray(0.0, x.dtype))
            A = A + poison
            B = B + poison
        else:
            raise ValueError(f"unknown fd mode {mode!r}")
        return A, B

    return jax.vmap(one)(X[:-1], U)


def linearize(step, X: jax.Array, U: jax.Array, mode: str = "ad"):
    """Dispatch: mode in {"ad", "central", "forward"}."""
    if mode == "ad":
        return linearize_ad(step, X, U)
    return linearize_fd(step, X, U, mode=mode)
