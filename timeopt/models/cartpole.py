"""Cart-pole swing-up.

Reference counterpart: make_cartpole_swingup, reference systems.py:57-112.
State x = [cart_pos, cart_vel, theta, theta_dot] with theta stored so that 0 is
*down* and pi is *upright* (internal shift th_u = theta - pi puts the dynamics
in the standard theta=0-upright form). Control u = [force].
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from timeopt.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.02
G = 9.81
M_CART = 1.0
M_POLE = 0.1
LENGTH = 0.5  # half-length
TOTAL_MASS = M_CART + M_POLE
POLEMASS_LENGTH = M_POLE * LENGTH
# Constant divisions are written as multiplications by the precomputed
# reciprocal (see the models/quadrotor.py note): the committed f64 artifacts
# were generated with this form, so changing it back moves their last bits.
_INV_TOTAL_MASS = 1.0 / TOTAL_MASS


def xdot(x: jax.Array, u: jax.Array) -> jax.Array:
    x_dot, th, th_dot = x[1], x[2], x[3]
    force = u[0]

    th_u = th - math.pi
    costh = jnp.cos(th_u)
    sinth = jnp.sin(th_u)

    temp = (force + POLEMASS_LENGTH * th_dot * th_dot * sinth) * _INV_TOTAL_MASS
    denom = LENGTH * (4.0 / 3.0 - M_POLE * costh * costh * _INV_TOTAL_MASS)

    th_acc = (G * sinth - costh * temp) / denom
    x_acc = temp - POLEMASS_LENGTH * th_acc * costh * _INV_TOTAL_MASS

    return jnp.stack([x_dot, x_acc, th_dot, th_acc])


step = euler_step_fn(xdot, DT, wrap_idx=(2,))

SYSTEM = System(
    name="Cartpole_SwingUp",
    n=4,
    m=1,
    dt=DT,
    step=step,
    xdot=xdot,
    wrap_idx=(2,),
    sigma_x0=(0.0, 0.0, 0.0, 0.0),
    sigma_xg=(0.0, 0.0, 0.0, 0.0),
)


def default_problem(dtype=jnp.float64, N: int = 360) -> Problem:
    return make_problem(
        x0=[0.0, 0.0, 0.0, 0.0],
        xg=[0.0, 0.0, math.pi, 0.0],
        u_ref=[0.0],
        Q=jnp.diag(jnp.asarray([0.01, 0.2, 0.0, 0.2])),
        R=[[0.02]],
        alpha=[5.0, 5.0, 800.0, 40.0],
        w=0.03,
        N=N,
        T_min=40,
        T_max=320,
        wrap_idx=(2,),
        dtype=dtype,
    )
