"""Mesh/sharding tests on the 8-virtual-device CPU backend (SURVEY.md §4:
multi-chip validation without a pod)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.helpers import tiny_double_integrator
from timeopt.parallel.mesh import (
    make_mesh,
    propagator_select_sharded,
    shard_problems,
    solve_batch_sharded,
)
from timeopt.parallel.stats import batch_summary, t_star_histogram
from timeopt.solver.ilqr import SolveOptions, solve_batch, stack_problems


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _batched_problems(B=8):
    system, prob = tiny_double_integrator()
    rng = np.random.default_rng(7)
    probs = []
    for _ in range(B):
        dx = rng.standard_normal(2) * 0.2
        probs.append(prob.replace(x0=prob.x0 + jnp.asarray(dx)))
    return system, stack_problems(probs)


def test_sharded_solve_matches_unsharded():
    system, probs = _batched_problems(8)
    opts = SolveOptions(method="propagator", max_iter=6)
    mesh = make_mesh(8, axis_names=("dp",))
    r_sharded = solve_batch_sharded(system, probs, options=opts, mesh=mesh)
    r_local = solve_batch(system, probs, options=opts)
    np.testing.assert_array_equal(np.asarray(r_sharded.T_star), np.asarray(r_local.T_star))
    np.testing.assert_allclose(
        np.asarray(r_sharded.J_star), np.asarray(r_local.J_star), rtol=1e-9
    )


def test_t_star_histogram_psum():
    system, probs = _batched_problems(8)
    opts = SolveOptions(method="propagator", max_iter=4)
    mesh = make_mesh(8, axis_names=("dp",))
    res = solve_batch_sharded(system, probs, options=opts, mesh=mesh)
    T_max = probs.T_max
    h_mesh = np.asarray(t_star_histogram(res.T_star, T_max, mesh=mesh))
    h_local = np.asarray(t_star_histogram(res.T_star, T_max))
    np.testing.assert_array_equal(h_mesh, h_local)
    assert h_mesh.sum() == 8


def test_batch_summary_psum():
    mesh = make_mesh(8, axis_names=("dp",))
    J = jnp.asarray([1.0, 2.0, jnp.inf, 3.0, 1.0, 2.0, 3.0, 4.0])
    errs = jnp.asarray([0.1, 0.2, 0.1, 9.0, 0.3, 0.4, 0.2, 0.1])
    s = batch_summary(J, errs, success_tol=0.5, mesh=mesh)
    assert int(s["n"]) == 8
    assert int(s["n_success"]) == 6
    np.testing.assert_allclose(float(s["success_rate"]), 6 / 8)


def test_propagator_select_sharded_matches_local():
    from timeopt.solver.augmented import build_augmented, build_terminal_factors
    from timeopt.solver.cost import rollout
    from timeopt.solver.horizon import propagator_select
    from timeopt.solver.ilqr import default_U_init
    from timeopt.solver.linearize import linearize

    system, prob = tiny_double_integrator()
    U = default_U_init(prob)
    X = rollout(system, prob, prob.x0, U)
    A, B = linearize(system.step, X, U, "ad")
    Tm = prob.T_max
    blocks = build_augmented(system, prob, X[: Tm + 1], U[:Tm], A[:Tm], B[:Tm])
    C = build_terminal_factors(prob, X[: Tm + 1], s=blocks.s)

    mesh = make_mesh(8, axis_names=("hs",))
    J_sharded = np.asarray(propagator_select_sharded(blocks, C, mesh, hs_axis="hs"))
    J_local = np.asarray(propagator_select(blocks, C))
    np.testing.assert_allclose(J_sharded, J_local, rtol=1e-8)
