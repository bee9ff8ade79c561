"""Regression tests for the dtype-aware q_reg default.

Cartpole's stage cost has Q[2,2] == 0 (theta is weighted only terminally),
so Q_aug's smallest pivot is q_reg and kappa(Q_aug) ~ max/q_reg. With
q_reg = 1e-9 a df32 selection (eps ~ 4e-15) produces a J(T) curve wrong by
up to 54x and picks T* ~ 100 instead of 129 (an f32 suite then scored
T*=100, success 0.00, against the f64 oracle's 181). q_reg = 1e-5 keeps
kappa ~ 1e7, restores the argmin, and perturbs the f64 J(T) by < 0.6%
(argmin itself is q_reg-insensitive in f64 up to 1e-4 — measured)."""

import jax
import numpy as np
import jax.numpy as jnp

from timeopt.models import cartpole
from timeopt.solver.augmented import build_augmented, build_terminal_factors
from timeopt.solver.cost import rollout
from timeopt.solver.ilqr import SolveOptions, _select_curve, default_U_init, resolve_q_reg
from timeopt.solver.linearize import linearize
from timeopt.solver.select_assoc import propagator_select_assoc_df


def test_resolve_q_reg_defaults():
    assert resolve_q_reg(SolveOptions(), jnp.float64) == 1e-9
    assert resolve_q_reg(SolveOptions(), jnp.float32) == 1e-5
    assert resolve_q_reg(SolveOptions(q_reg=3e-7), jnp.float32) == 3e-7


def test_f64_argmin_insensitive_to_f32_qreg():
    """The f32 default q_reg must not move the f64 selection argmin."""
    system = cartpole.SYSTEM
    prob = cartpole.default_problem(dtype=jnp.float64)
    U = default_U_init(prob)
    X = rollout(system, prob, prob.x0, U)
    A, B = linearize(system.step, X, U, "ad")
    lo, hi = prob.T_min, prob.T_max
    c_tight = np.asarray(_select_curve(system, prob, SolveOptions(q_reg=1e-9), X, U, A, B))
    c_loose = np.asarray(_select_curve(system, prob, SolveOptions(q_reg=1e-5), X, U, A, B))
    am_t = np.argmin(c_tight[lo - 1 : hi]) + lo
    am_l = np.argmin(c_loose[lo - 1 : hi]) + lo
    assert am_t == am_l == 129
    rel = np.abs(c_loose[lo - 1 : hi] - c_tight[lo - 1 : hi]) / np.abs(c_tight[lo - 1 : hi])
    assert rel.max() < 0.01


def test_df32_select_cartpole_with_default_qreg():
    """The XLA df32 select (scan_mode="assoc_df") on cartpole's singular-Q
    problem: with the resolved f32 q_reg the argmin lands within +-2 of the
    f64 oracle; with 1e-9 it was off by ~20 with O(1) relative J errors.
    (Compiled CPU XLA degrades the df tricks, ops/df32.py; the tolerance is
    loose accordingly.)"""
    system = cartpole.SYSTEM
    prob64 = cartpole.default_problem(dtype=jnp.float64)
    U = default_U_init(prob64)
    X = rollout(system, prob64, prob64.x0, U)
    A, B = linearize(system.step, X, U, "ad")
    lo, hi = prob64.T_min, prob64.T_max
    c64 = np.asarray(_select_curve(system, prob64, SolveOptions(), X, U, A, B))
    am64 = np.argmin(c64[lo - 1 : hi]) + lo

    prob32 = cartpole.default_problem(dtype=jnp.float32)
    Tm = prob32.T_max
    f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
    Xh, Uh, Ah, Bh = f32(X[: Tm + 1]), f32(U[:Tm]), f32(A[:Tm]), f32(B[:Tm])
    qr = resolve_q_reg(SolveOptions(), jnp.float32)
    blocks = build_augmented(
        system, prob32, Xh, Uh, Ah, Bh, q_reg=qr, rho_reg=1e-12, psd_levels=2, scale=True
    )
    C = build_terminal_factors(prob32, Xh, rho_reg=1e-12, s=blocks.s)
    # op-by-op (eager) execution rounds every df32 step individually, as the
    # df tricks require; compiled CPU XLA would contract them (ops/df32.py)
    with jax.disable_jit():
        Jb = propagator_select_assoc_df(
            blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv, C, t_min=prob32.T_min
        )
    J = np.asarray(Jb, np.float64) * float(blocks.s[0]) ** 2
    am32 = np.argmin(J[lo - 1 : hi]) + lo
    assert abs(int(am32) - int(am64)) <= 2
    rel = np.abs(J[lo - 1 : hi] - c64[lo - 1 : hi]) / np.abs(c64[lo - 1 : hi])
    assert np.median(rel) < 5e-3
