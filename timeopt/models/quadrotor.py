"""12-DoF Euler-angle quadrotor (flagship benchmark model).

Reference counterpart: make_quadrotor, reference systems.py:119-230.
State x = [pos(3), vel(3), euler(3: phi,theta,psi), omega(3)], control
u = [thrust, tau_x, tau_y, tau_z]; explicit Euler at dt=0.05.

Guard semantics: the reference returns an all-NaN state near the Euler
singularity (|cos(theta)| < 1e-3), for |omega| > 1e3, for non-finite input, or
for ||x|| > 1e6, so that line searches self-reject bad rollouts
(reference systems.py:165-191). Here the guard is a branchless additive
NaN poison on the *value* — the payload is `where(bad, nan, 0)` added to the
finite computation, so forward values match the reference's rejection
semantics while AD Jacobians at guarded-but-finite states remain finite
(finite-difference mode reproduces the reference's NaN Jacobians exactly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from timeopt.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.05
MASS = 1.0
G = 9.81
IX, IY, IZ = 0.02, 0.02, 0.04
KV, KW = 0.05, 0.01

COS_PITCH_MIN = 1e-3
OMG_ABS_MAX = 1e3
STATE_NORM_MAX = 1e6

# NumPy f64, so their values do not depend on whether x64 was on at import
_INERTIA = np.asarray([IX, IY, IZ], np.float64)
# Division by the (constant) inertia is written as multiplication by the
# precomputed reciprocal: compilers fold a divide-by-constant differently
# from one backend to the next, while a constant multiply rounds the same
# everywhere. The committed f64 artifacts were generated with this form.
# The reference divides (reference systems.py:119-230); the difference is a
# ~1e-8 relative reparameterization of the inertia, far below model
# accuracy (and the f32 reciprocals are exactly 50, 50, 25).
_INV_IX, _INV_IY, _INV_IZ = 1.0 / IX, 1.0 / IY, 1.0 / IZ
_INV_INERTIA = np.asarray([_INV_IX, _INV_IY, _INV_IZ], np.float64)


def _body_z_world(phi, th, psi):
    """Third column of R = Rz(psi) Ry(th) Rx(phi) — the body z-axis in world
    frame (the only column the thrust model needs)."""
    sph, cph = jnp.sin(phi), jnp.cos(phi)
    sth, cth = jnp.sin(th), jnp.cos(th)
    sps, cps = jnp.sin(psi), jnp.cos(psi)
    return jnp.stack(
        [
            cps * sth * cph + sps * sph,
            sps * sth * cph - cps * sph,
            cth * cph,
        ]
    )


def _euler_rate_matrix(phi, th):
    """T(phi, th): body rates omega -> Euler-angle rates."""
    sph, cph = jnp.sin(phi), jnp.cos(phi)
    tth = jnp.tan(th)
    sec = 1.0 / jnp.cos(th)
    return jnp.asarray(
        [
            [1.0, sph * tth, cph * tth],
            [0.0, cph, -sph],
            [0.0, sph * sec, cph * sec],
        ]
    )


def xdot(x: jax.Array, u: jax.Array) -> jax.Array:
    vel = x[3:6]
    phi, th, psi = x[6], x[7], x[8]
    omg = x[9:12]
    thrust = u[0]
    tau = u[1:4]

    inertia = _INERTIA.astype(x.dtype)
    acc = (
        (thrust / MASS) * _body_z_world(phi, th, psi)
        - jnp.asarray([0.0, 0.0, G], dtype=x.dtype)
        - KV * vel
    )
    eulerdot = _euler_rate_matrix(phi, th).astype(x.dtype) @ omg
    omgdot = (tau - jnp.cross(omg, inertia * omg)) * _INV_INERTIA.astype(
        x.dtype
    ) - KW * omg

    return jnp.concatenate([vel, acc, eulerdot, omgdot])


def guard(x: jax.Array, u: jax.Array) -> jax.Array:
    th = x[7]
    omg = x[9:12]
    return (
        (~jnp.all(jnp.isfinite(x)))
        | (~jnp.all(jnp.isfinite(u)))
        | (jnp.sqrt(jnp.sum(jnp.square(x))) > STATE_NORM_MAX)
        | (jnp.abs(jnp.cos(th)) < COS_PITCH_MIN)
        | jnp.any(jnp.abs(omg) > OMG_ABS_MAX)
    )


step = euler_step_fn(xdot, DT, guard=guard)

SYSTEM = System(
    name="Quadrotor",
    n=12,
    m=4,
    dt=DT,
    step=step,
    xdot=xdot,
    guard=guard,
    sigma_x0=(0.4, 0.4, 0.4) + (0.0,) * 9,
    sigma_xg=(0.0,) * 12,
)


def default_problem(dtype=jnp.float64, N: int = 160) -> Problem:
    return make_problem(
        x0=[2.0, 2.0, 2.0] + [0.0] * 9,
        xg=[0.0] * 12,
        u_ref=[MASS * G, 0.0, 0.0, 0.0],
        Q=jnp.diag(jnp.asarray([5.0, 5, 5, 1, 1, 1, 20, 20, 10, 1, 1, 1])),
        R=jnp.diag(jnp.asarray([1e-3, 1e-2, 1e-2, 1e-2])),
        alpha=300.0,
        w=0.005,
        N=N,
        T_min=40,
        T_max=160,
        wrap_idx=(6, 7, 8),
        dtype=dtype,
    )
