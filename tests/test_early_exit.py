"""Early-exit while_loop parity: per-problem results must be bit-identical
to the fixed max_iter scan (the loop transform only changes when the batch
STOPS, never what a lane computes — reference convergence break:
reference solver.py:745-753)."""

import numpy as np
import jax.numpy as jnp
import pytest

from timeopt.models import get_system
from timeopt.solver.ilqr import SolveOptions, broadcast_problem, solve, solve_batch
from tests.helpers import tiny_double_integrator


@pytest.mark.parametrize("method", ["propagator", "bruteforce", "onepass"])
def test_early_exit_matches_scan_batch(method):
    system, base = tiny_double_integrator()
    rng = np.random.default_rng(3)
    B = 4
    x0s = np.tile(np.asarray(base.x0), (B, 1)) + 0.1 * rng.standard_normal((B, 2))
    probs = broadcast_problem(base, B).replace(x0=jnp.asarray(x0s))

    kw = dict(method=method, max_iter=6, S_window=4)
    r_ee = solve_batch(system, probs, options=SolveOptions(early_exit=True, **kw))
    r_sc = solve_batch(system, probs, options=SolveOptions(early_exit=False, **kw))

    assert np.array_equal(np.asarray(r_ee.T_star), np.asarray(r_sc.T_star))
    assert np.array_equal(np.asarray(r_ee.J_star), np.asarray(r_sc.J_star))
    assert np.array_equal(np.asarray(r_ee.X), np.asarray(r_sc.X))
    assert np.array_equal(np.asarray(r_ee.U), np.asarray(r_sc.U))
    assert np.array_equal(
        np.asarray(r_ee.J_hist), np.asarray(r_sc.J_hist), equal_nan=True
    )
    assert np.array_equal(np.asarray(r_ee.T_hist), np.asarray(r_sc.T_hist))
    assert np.array_equal(np.asarray(r_ee.n_accept), np.asarray(r_sc.n_accept))


def test_early_exit_matches_scan_single():
    system, base = tiny_double_integrator()
    r_ee = solve(system, base, options=SolveOptions(max_iter=6, early_exit=True))
    r_sc = solve(system, base, options=SolveOptions(max_iter=6, early_exit=False))
    assert int(r_ee.T_star) == int(r_sc.T_star)
    assert float(r_ee.J_star) == float(r_sc.J_star)


def test_early_exit_converges_before_budget():
    # sanity: the tiny problem actually converges well before max_iter, so
    # the while_loop path exercises a genuinely shortened trip count
    system, base = tiny_double_integrator()
    res = solve(system, base, options=SolveOptions(max_iter=10, early_exit=True))
    assert int(res.n_accept) < 10
    assert np.isfinite(float(res.J_star))
