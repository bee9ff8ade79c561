"""Flat-tie sets (SolveResult.T_ties): the landscape tie criterion
|J(t) - J(T*)| <= w * (|t - T*| + 1) surfaced as a first-class solver
output (the post-hoc criterion of scripts/oracle_match.py computed
on the device, so exact-or-tied agreement needs no f64 oracle run)."""

import jax.numpy as jnp
import numpy as np

from timeopt.models import get_system
from timeopt.solver.ilqr import SolveOptions, flat_tie_set, solve


def test_flat_tie_set_synthetic():
    # horizons 1..8, T_min=2, w=0.1; T*=4 at J=1.0
    J = jnp.asarray([np.inf, 5.0, 1.05, 1.0, 1.15, 1.0, 2.0, np.nan])
    ties = flat_tie_set(J, jnp.asarray(4), 2, 0.1)
    # t=3: |1.05-1| = .05 <= .1*2 -> tied; t=4: itself; t=5: .15 <= .2 tied;
    # t=6: 0 <= .3 tied; t=2: 4 > .3; t=7: 1 > .4; t=1: < T_min and inf;
    # t=8: nan never ties
    np.testing.assert_array_equal(
        np.asarray(ties), [False, False, True, True, True, True, False, False]
    )


def test_flat_tie_set_strict_minimum():
    # strongly convex curve: singleton tie set {T*}
    t = np.arange(1, 31, dtype=float)
    J = jnp.asarray((t - 17.0) ** 2)
    ties = flat_tie_set(J, jnp.asarray(17), 1, 0.4)
    assert np.asarray(ties).sum() == 1 and bool(ties[16])


def test_solve_reports_ties():
    system, mk = get_system("DoubleIntegrator")
    prob = mk(dtype=jnp.float64)
    res = solve(system, prob, options=SolveOptions(method="propagator", max_iter=12))
    ties = np.asarray(res.T_ties)
    assert ties.shape == (int(prob.T_max),)
    T_star = int(res.T_star)
    # T* is always in its own tie set; no tie below T_min
    assert ties[T_star - 1]
    assert not ties[: int(prob.T_min) - 1].any()
    # DI reference case has a unique, well-separated minimum (T*=25):
    # neighbors differ by more than the w-step resolution
    J = np.asarray(res.J_curve)
    w = float(prob.w)
    for t in range(1, int(prob.T_max) + 1):
        expected = (
            t >= int(prob.T_min)
            and np.isfinite(J[t - 1])
            and abs(J[t - 1] - J[T_star - 1]) <= w * (abs(t - T_star) + 1)
        )
        assert bool(ties[t - 1]) == expected
