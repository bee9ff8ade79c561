"""1D double integrator (linear benchmark).

Reference counterpart: make_double_integrator, reference systems.py:28-50.
State x = [pos, vel], control u = [acc]; explicit-Euler discretization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from timeopt.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.05


def xdot(x: jax.Array, u: jax.Array) -> jax.Array:
    return jnp.stack([x[1], u[0]])


step = euler_step_fn(xdot, DT)

SYSTEM = System(
    name="DoubleIntegrator",
    n=2,
    m=1,
    dt=DT,
    step=step,
    xdot=xdot,
    sigma_x0=(0.2, 0.2),
    sigma_xg=(0.0, 0.0),
)


def default_problem(dtype=jnp.float64, N: int = 120) -> Problem:
    return make_problem(
        x0=[1.0, 0.0],
        xg=[2.0, 0.0],
        u_ref=[0.0],
        Q=[[1.0, 0.0], [0.0, 0.1]],
        R=[[1e-2]],
        alpha=50.0,
        w=0.02,
        N=N,
        T_min=10,
        T_max=80,
        wrap_idx=(),
        dtype=dtype,
    )
