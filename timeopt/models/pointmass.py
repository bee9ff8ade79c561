"""2D point-mass navigation with soft Gaussian obstacle penalties.

Reference counterpart: make_pointmass_navigation,
reference systems.py:237-296 — the only system exercising the
`extra_stage_cost` hook. The reference supplies a hand-derived
gradient/Hessian of the obstacle penalty; here the penalty is a scalar jnp
function and the solver obtains exact derivatives with `jax.grad`/`jax.hessian`
(see timeopt/solver/cost.py), which removes a whole class of
hand-derivation bugs and fuses into the surrounding program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from timeopt.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.05

# (cx, cy, radius, weight) per obstacle
OBSTACLES = (
    (-1.0, -0.5, 0.65, 6.0),
    (0.0, 0.2, 0.70, 6.0),
    (1.0, 1.0, 0.65, 6.0),
)

# NumPy f64, so their values do not depend on whether x64 was on at import
_CENTERS = np.asarray([[o[0], o[1]] for o in OBSTACLES], np.float64)
_RADII = np.asarray([o[2] for o in OBSTACLES], np.float64)
_WEIGHTS = np.asarray([o[3] for o in OBSTACLES], np.float64)


def xdot(x: jax.Array, u: jax.Array) -> jax.Array:
    return jnp.stack([x[2], x[3], u[0], u[1]])


step = euler_step_fn(xdot, DT)


def obstacle_cost(x: jax.Array, u: jax.Array) -> jax.Array:
    """Soft obstacle penalty sum_i w_i exp(-||p - o_i||^2 / (2 r_i^2))."""
    p = x[:2]
    d2 = jnp.sum(jnp.square(p[None, :] - _CENTERS.astype(x.dtype)), axis=-1)
    r = _RADII.astype(x.dtype)
    return jnp.sum(_WEIGHTS.astype(x.dtype) * jnp.exp(-d2 / (2.0 * r * r)))


SYSTEM = System(
    name="PointMass_Navigation",
    n=4,
    m=2,
    dt=DT,
    step=step,
    xdot=xdot,
    extra_cost=obstacle_cost,
    sigma_x0=(0.1, 0.1, 0.0, 0.0),
    sigma_xg=(0.0, 0.0, 0.0, 0.0),
)


def default_problem(dtype=jnp.float64, N: int = 240) -> Problem:
    return make_problem(
        x0=[-2.0, -2.0, 0.0, 0.0],
        xg=[2.0, 2.0, 0.0, 0.0],
        u_ref=[0.0, 0.0],
        Q=jnp.diag(jnp.asarray([0.0, 0.0, 0.15, 0.15])),
        R=jnp.diag(jnp.asarray([0.05, 0.05])),
        alpha=[250.0, 250.0, 30.0, 30.0],
        w=0.06,
        N=N,
        T_min=30,
        T_max=220,
        wrap_idx=(),
        dtype=dtype,
    )
