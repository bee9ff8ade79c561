"""Ballbot balance (body balancing on a ball).

Reference counterpart: `make_ballbot` in the legacy monolith,
reference ilqr_propagator.py:685-698 (the modular reference never ported
it, but it is part of the committed benchmark suite — plots/summary.csv:8-10).
State x = [ball_pos, ball_vel, theta, theta_dot], control u = [wheel torque]
(force = tau / r). Cartpole-style nonlinear balance dynamics with an effective
ball mass M_eff = m_ball + I_ball / r^2; theta = 0 is upright.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from timeopt.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.02
G = 9.81
R_BALL = 0.12
M_BALL = 1.2
I_BALL = (2.0 / 5.0) * M_BALL * R_BALL * R_BALL
M_EFF = M_BALL + I_BALL / (R_BALL * R_BALL)
M_BODY = 2.0
L_BODY = 0.55

TOTAL_MASS = M_EFF + M_BODY
POLEMASS_LENGTH = M_BODY * L_BODY
# Constant divisions are written as multiplications by the precomputed
# reciprocal (see the models/quadrotor.py note): the committed f64 artifacts
# were generated with this form, so changing it back moves their last bits.
_INV_TOTAL_MASS = 1.0 / TOTAL_MASS
_INV_R_BALL = 1.0 / R_BALL


def xdot(x: jax.Array, u: jax.Array) -> jax.Array:
    x_dot, th, th_dot = x[1], x[2], x[3]
    force = u[0] * _INV_R_BALL
    s, c = jnp.sin(th), jnp.cos(th)
    temp = (force + POLEMASS_LENGTH * th_dot * th_dot * s) * _INV_TOTAL_MASS
    th_acc = (G * s - c * temp) / (L_BODY * (4.0 / 3.0 - M_BODY * c * c * _INV_TOTAL_MASS))
    x_acc = temp - POLEMASS_LENGTH * th_acc * c * _INV_TOTAL_MASS
    return jnp.stack([x_dot, x_acc, th_dot, th_acc])


step = euler_step_fn(xdot, DT, wrap_idx=(2,))

SYSTEM = System(
    name="Ballbot_Balance",
    n=4,
    m=1,
    dt=DT,
    step=step,
    xdot=xdot,
    wrap_idx=(2,),
    sigma_x0=(0.02, 0.02, 0.02, 0.02),
    sigma_xg=(0.0, 0.0, 0.0, 0.0),
)


def default_problem(dtype=jnp.float64, N: int = 260) -> Problem:
    return make_problem(
        x0=[0.05, 0.0, 0.08, 0.0],
        xg=[0.0, 0.0, 0.0, 0.0],
        u_ref=[0.0],
        Q=jnp.diag(jnp.asarray([1.0, 0.1, 25.0, 1.0])),
        R=[[0.25]],
        alpha=220.0,
        w=1e-4,
        N=N,
        T_min=60,
        T_max=200,
        wrap_idx=(2,),
        dtype=dtype,
    )
