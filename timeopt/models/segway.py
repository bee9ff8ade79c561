"""Segway balance (inverted pendulum on a wheel), linearized-pendulum form.

Reference counterpart: make_segway_balance, reference systems.py:303-348.
State x = [wheel_pos, wheel_vel, theta, theta_dot], control u = [torque].
The continuous dynamics are affine in (theta, tau) with closed-form
coefficients derived from the (M, m, l, I, r) parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from timeopt.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.02
G = 9.81
R_WHEEL = 0.15
M_BASE = 1.0
M_PEND = 2.0
L_PEND = 0.5
I_PEND = (1.0 / 3.0) * M_PEND * L_PEND * L_PEND

_A1 = M_BASE + M_PEND
_A2 = M_PEND * L_PEND
_A3 = I_PEND + M_PEND * L_PEND * L_PEND
_DEN = _A1 * _A3 - _A2 * _A2

A_TAU = _A3 / (R_WHEEL * _DEN) - _A2 / _DEN
A_TH = -(_A2 * M_PEND * G * L_PEND) / _DEN
B_TAU = -_A2 / (R_WHEEL * _DEN) + _A1 / _DEN
B_TH = (_A1 * M_PEND * G * L_PEND) / _DEN


def xdot(x: jax.Array, u: jax.Array) -> jax.Array:
    x_dot, th, th_dot = x[1], x[2], x[3]
    tau = u[0]
    xdd = A_TAU * tau + A_TH * th
    thdd = B_TAU * tau + B_TH * th
    return jnp.stack([x_dot, xdd, th_dot, thdd])


step = euler_step_fn(xdot, DT, wrap_idx=(2,))

SYSTEM = System(
    name="Segway_Balance",
    n=4,
    m=1,
    dt=DT,
    step=step,
    xdot=xdot,
    wrap_idx=(2,),
    sigma_x0=(0.02, 0.02, 0.02, 0.02),
    sigma_xg=(0.0, 0.0, 0.0, 0.0),
)


def default_problem(dtype=jnp.float64, N: int = 240) -> Problem:
    return make_problem(
        x0=[0.05, 0.0, 0.08, 0.0],
        xg=[0.0, 0.0, 0.0, 0.0],
        u_ref=[0.0],
        Q=jnp.diag(jnp.asarray([1.0, 0.1, 25.0, 1.0])),
        R=[[0.25]],
        alpha=[20.0, 2.0, 250.0, 10.0],
        w=1e-4,
        N=N,
        T_min=40,
        T_max=200,
        wrap_idx=(2,),
        dtype=dtype,
    )
