"""Fused-input select route (the default: augmented blocks assembled from
(n,)-sized inputs) vs the assembled XLA route."""

import jax
import jax.numpy as jnp
import numpy as np

from tests.helpers import random_ltv_problem
from timeopt.models.base import System
from timeopt.solver.augmented import build_augmented, build_fused_inputs, build_terminal_factors
from timeopt.solver.horizon import (
    propagator_select_fused,
    propagator_select_single_jitter,
)


def _problems(rng, B=8, n=3, m=2, N=6, dtype=np.float64):
    out = []
    for i in range(B):
        step, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=n, m=m, N=N)
        system = System(name=f"ltv{i}", n=n, m=m, dt=0.1, step=step)
        A = jnp.broadcast_to(jnp.asarray(Ad, dtype), (N, n, n))
        Bm = jnp.broadcast_to(jnp.asarray(Bd, dtype), (N, n, m))
        probd = jax.tree.map(
            lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            prob,
        )
        out.append((system, probd, A, Bm, jnp.asarray(X, dtype), jnp.asarray(U, dtype)))
    return out


def test_fused_fallback_matches_assembled_f64(rng):
    """XLA assembly from fused inputs == build_augmented + factored select."""
    for system, prob, A, Bm, X, U in _problems(rng, B=4):
        blocks = build_augmented(system, prob, X, U, A, Bm, psd_levels=1)
        C = build_terminal_factors(prob, X, s=blocks.s)
        J_ref = blocks.s[0] ** 2 * propagator_select_single_jitter(
            blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv, C
        )
        fi = build_fused_inputs(system, prob, X, U, A, Bm, psd_levels=1)
        J_fused = fi.s[0] ** 2 * propagator_select_fused(
            fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt
        )
        np.testing.assert_allclose(
            np.asarray(J_fused), np.asarray(J_ref), rtol=1e-9, atol=1e-12
        )


def test_fused_path_e2e_quadrotor(rng):
    """The default route's J(T) curve on a solved quadrotor trajectory ==
    the assembled propagator_select route (build_augmented +
    build_terminal_factors + the psd_levels=2 sequential scan)."""
    from timeopt.models import quadrotor
    from timeopt.solver.cost import argmin_T
    from timeopt.solver.horizon import propagator_select
    from timeopt.solver.ilqr import SolveOptions, _select_curve, resolve_q_reg, solve
    from timeopt.solver.linearize import linearize

    system = quadrotor.SYSTEM
    prob = quadrotor.default_problem(dtype=jnp.float64)
    opts = SolveOptions(max_iter=6)
    res = solve(system, prob, options=opts)
    X, U = res.X, res.U
    A, B = linearize(system.step, X, U, "ad")
    J_default = _select_curve(system, prob, opts, X, U, A, B)

    blocks = build_augmented(
        system, prob, X, U, A, B, q_reg=resolve_q_reg(opts, X.dtype),
        rho_reg=opts.rho_reg, psd_levels=opts.psd_levels,
    )
    C = build_terminal_factors(prob, X, rho_reg=opts.rho_reg, s=blocks.s)
    J_assembled = blocks.s[0] ** 2 * propagator_select(blocks, C, psd_levels=opts.psd_levels)

    lo, hi = prob.T_min, prob.T_max
    assert int(argmin_T(J_default, lo, hi)) == int(argmin_T(J_assembled, lo, hi)) == int(res.T_star)
    np.testing.assert_allclose(
        np.asarray(J_default)[lo - 1 : hi], np.asarray(J_assembled)[lo - 1 : hi], rtol=1e-8
    )
