"""Shared test utilities: tiny problem instances (fast compiles on the CPU
test host) and an independent NumPy Riccati oracle for the quadratic-model
J(T) curve."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from timeopt.models import get_system
from timeopt.models.base import make_problem


def tiny_double_integrator(N: int = 24, T_min: int = 4, T_max: int = 16):
    """Small-horizon double integrator for fast-compile tests."""
    system, _ = get_system("DoubleIntegrator")
    prob = make_problem(
        x0=[1.0, 0.0],
        xg=[2.0, 0.0],
        u_ref=[0.0],
        Q=[[1.0, 0.0], [0.0, 0.1]],
        R=[[1e-2]],
        alpha=50.0,
        w=0.02,
        N=N,
        T_min=T_min,
        T_max=T_max,
    )
    return system, prob


def riccati_J_curve_oracle(
    A, B, X, U, xg, u_ref, Q, R, Qf, w, T_max, lm_lambda=0.0, wrap_idx=()
):
    """Independent NumPy oracle: exact quadratic-model J(T) for T = 1..T_max
    via a per-T backward Riccati value expansion (the math of SURVEY.md §2 C8;
    implemented from the Bellman recursion, plain np.linalg)."""

    def wrap(e):
        e = np.array(e, dtype=float)
        for i in wrap_idx:
            e[i] = (e[i] + np.pi) % (2 * np.pi) - np.pi
        return e

    n = X.shape[1]
    m = U.shape[1]
    J = np.zeros(T_max)
    for T in range(1, T_max + 1):
        eT = wrap(X[T] - xg)
        Vxx = 0.5 * (Qf + Qf.T)
        Vx = Qf @ eT
        V0 = 0.5 * eT @ Qf @ eT
        for t in range(T - 1, -1, -1):
            e = wrap(X[t] - xg)
            du = U[t] - u_ref
            l0 = 0.5 * e @ Q @ e + 0.5 * du @ R @ du + w
            Qx = Q @ e + A[t].T @ Vx
            Qu = R @ du + B[t].T @ Vx
            Qxx = Q + A[t].T @ Vxx @ A[t]
            Quu = R + B[t].T @ Vxx @ B[t]
            Qux = B[t].T @ Vxx @ A[t]
            iQ = np.linalg.inv(0.5 * (Quu + Quu.T) + lm_lambda * np.eye(m))
            Vx = Qx - Qux.T @ iQ @ Qu
            Vxx_new = Qxx - Qux.T @ iQ @ Qux
            Vxx = 0.5 * (Vxx_new + Vxx_new.T)
            V0 = l0 + V0 - 0.5 * Qu @ iQ @ Qu
        J[T - 1] = V0
    return J


def random_ltv_problem(rng, n=3, m=2, N=12, dt=0.1):
    """A random stable LTI system wrapped as (system-step, Problem) with a
    rolled-out nominal trajectory (zero affine residuals)."""
    Ad = np.eye(n) + dt * rng.standard_normal((n, n)) * 0.3
    Bd = dt * rng.standard_normal((n, m))

    def step(x, u):
        return jnp.asarray(Ad) @ x + jnp.asarray(Bd) @ u

    Qh = rng.standard_normal((n, n)) * 0.3
    Q = Qh @ Qh.T + np.eye(n)
    Rh = rng.standard_normal((m, m)) * 0.3
    R = Rh @ Rh.T + 0.5 * np.eye(m)
    Qf = 5.0 * np.eye(n)

    x0 = rng.standard_normal(n)
    xg = rng.standard_normal(n) * 0.5
    u_ref = rng.standard_normal(m) * 0.1
    U = 0.1 * rng.standard_normal((N, m)) + u_ref

    X = np.zeros((N + 1, n))
    X[0] = x0
    for k in range(N):
        X[k + 1] = Ad @ X[k] + Bd @ U[k]

    prob = make_problem(
        x0=x0, xg=xg, u_ref=u_ref, Q=Q, R=R, alpha=Qf, w=0.05,
        N=N, T_min=1, T_max=N, wrap_idx=(),
    )
    return step, prob, np.asarray(Ad), np.asarray(Bd), X, U
