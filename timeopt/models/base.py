"""Problem/system abstractions.

Reference counterpart: the `make_*` factories in reference systems.py
return a positional 13-tuple `(F, x0, xg, u_ref, Q, R, alpha, w, N, T_min,
T_max, wrap_idx, extra)` with `F` a NumPy closure. Here the same information
splits into:

- `System` — a static description: the pure `step(x, u) -> x_next` dynamics
  (jnp, differentiable), dims, dt, optional extra stage cost. Static so `jit`
  can specialize on the dynamics function.
- `Problem` — a frozen-dataclass pytree of arrays (x0, xg, u_ref, Q, R, Qf,
  w, wrap_mask) plus static ints (N, T_min, T_max). Array leaves batch with
  `vmap`; static fields fix the program shapes.

All trajectory shapes are functions of the static `N`/`T_max` only; variable
horizons are handled by masking, never by dynamic shapes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from timeopt.ops.linalg import as_terminal_weight
from timeopt.ops.wrap import wrap_mask_from_idx

# step: (x, u) -> x_next, pure jnp, shape (n,), (m,) -> (n,)
StepFn = Callable[[jax.Array, jax.Array], jax.Array]
# xdot: (x, u) -> continuous-time state derivative, shape (n,)
XdotFn = Callable[[jax.Array, jax.Array], jax.Array]
# guard: (x, u) -> () bool, True when the state/control is invalid (poisoned)
GuardFn = Callable[[jax.Array, jax.Array], jax.Array]
# extra stage cost: (x, u) -> scalar c (value; gradient/Hessian via AD)
ExtraCostFn = Callable[[jax.Array, jax.Array], jax.Array]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["x0", "xg", "u_ref", "Q", "R", "Qf", "w", "wrap_mask"],
    meta_fields=["N", "T_min", "T_max"],
)
@dataclasses.dataclass(frozen=True)
class Problem:
    """One horizon-optimal trajectory-optimization problem instance.

    min_{U,T} sum_{k<T} [0.5 e_k' Q e_k + 0.5 du_k' R du_k + w] + 0.5 e_T' Qf e_T
    s.t. x_{k+1} = step(x_k, u_k), x_0 = x0, T in [T_min, T_max].
    (reference problem statement: reference README.md:9-14)
    """

    x0: jax.Array  # (n,)
    xg: jax.Array  # (n,)
    u_ref: jax.Array  # (m,)
    Q: jax.Array  # (n, n)
    R: jax.Array  # (m, m)
    Qf: jax.Array  # (n, n) full terminal weight
    w: jax.Array  # () time penalty per step
    wrap_mask: jax.Array  # (n,) bool, angular state components
    N: int
    T_min: int
    T_max: int

    def replace(self, **changes) -> "Problem":
        """Copy with the given fields replaced (e.g. a batch of new x0)."""
        return dataclasses.replace(self, **changes)

    @property
    def n(self) -> int:
        return self.x0.shape[-1]

    @property
    def m(self) -> int:
        return self.u_ref.shape[-1]


@dataclasses.dataclass(frozen=True)
class System:
    """Static dynamics description (hashable; safe as a jit static argument)."""

    name: str
    n: int
    m: int
    dt: float
    step: StepFn = dataclasses.field(compare=False)
    extra_cost: Optional[ExtraCostFn] = dataclasses.field(default=None, compare=False)
    # Continuous-time derivative: step(x,u) == wrap(x + dt*xdot(x,u)) (+ guard
    # poisoning). Optional; when present it enables the compensated df32
    # forward rollout (solver/rollout_df.py) — in f32, integrating native
    # increments in hi/lo double-single form injects per-step noise
    # O(eps*|dt*xdot|) instead of O(eps*|x|), which is what keeps long
    # nonlinear rollouts (cartpole swing-up, N=360) on the f64 trajectory.
    xdot: Optional[XdotFn] = dataclasses.field(default=None, compare=False)
    # Invalid-state predicate poisoned to NaN inside step (e.g. the
    # quadrotor's Euler-singularity / divergence guards —
    # reference systems.py:165-191).
    guard: Optional[GuardFn] = dataclasses.field(default=None, compare=False)
    # State components step() angle-normalizes into (-pi, pi].
    wrap_idx: tuple = ()
    # default perturbation sigmas for benchmark trials
    # (reference run_suite.py:69-74)
    sigma_x0: tuple = ()
    sigma_xg: tuple = ()

    def safe_step(self, x: jax.Array, u: jax.Array, max_state_norm: float = 1e6) -> jax.Array:
        """step() with divergence poisoning: non-finite or exploding next
        states become all-NaN so downstream line searches self-reject.
        (reference: rollout guards at reference solver.py:54-59)
        """
        xn = self.step(x, u)
        bad = (~jnp.all(jnp.isfinite(xn))) | (
            jnp.sqrt(jnp.sum(jnp.square(xn))) > max_state_norm
        )
        return xn + jnp.where(bad, jnp.asarray(jnp.nan, xn.dtype), jnp.asarray(0.0, xn.dtype))


def euler_step_fn(
    xdot: XdotFn,
    dt: float,
    wrap_idx: tuple = (),
    guard: Optional[GuardFn] = None,
) -> StepFn:
    """Build the canonical discrete step every benchmark system uses:
    x+ = x + dt*xdot(x,u), selected components angle-normalized, optional
    guard predicate poisoning the result to NaN (reference pattern:
    reference systems.py:28-348 — each `make_*` closure hand-writes
    this composition). Arithmetic is element-for-element identical to the
    hand-written forms, so f64 trajectories are bit-stable across the
    refactor."""
    from timeopt.ops.wrap import angle_normalize

    def step(x: jax.Array, u: jax.Array) -> jax.Array:
        xn = x + dt * xdot(x, u)
        for i in wrap_idx:
            xn = xn.at[i].set(angle_normalize(xn[i]))
        if guard is not None:
            bad = guard(x, u)
            xn = xn + jnp.where(
                bad, jnp.asarray(jnp.nan, xn.dtype), jnp.asarray(0.0, xn.dtype)
            )
        return xn

    return step


def make_problem(
    *,
    x0,
    xg,
    u_ref,
    Q,
    R,
    alpha,
    w,
    N: int,
    T_min: int,
    T_max: int,
    wrap_idx=(),
    dtype=jnp.float64,
) -> Problem:
    """Assemble a Problem from reference-style ingredients (host-side)."""
    x0 = np.asarray(x0, dtype=dtype).reshape(-1)
    n = x0.size
    return Problem(
        x0=jnp.asarray(x0, dtype=dtype),
        xg=jnp.asarray(np.reshape(xg, -1), dtype=dtype),
        u_ref=jnp.asarray(np.reshape(u_ref, -1), dtype=dtype),
        Q=jnp.asarray(Q, dtype=dtype),
        R=jnp.asarray(np.atleast_2d(R), dtype=dtype),
        Qf=jnp.asarray(as_terminal_weight(alpha, n), dtype=dtype),
        w=jnp.asarray(w, dtype=dtype),
        wrap_mask=jnp.asarray(wrap_mask_from_idx(wrap_idx, n)),
        N=int(N),
        T_min=int(T_min),
        T_max=int(T_max),
    )
