"""Phase-profiler tests (reference 4-phase timer parity, SURVEY.md §5)."""

import numpy as np

from tests.helpers import tiny_double_integrator
from timeopt.solver.ilqr import SolveOptions, solve
from timeopt.utils.timing import profile_solve


def test_profile_solve_timers_and_result():
    system, prob = tiny_double_integrator()
    opts = SolveOptions(method="propagator", max_iter=6)
    result, timers = profile_solve(system, prob, opts)
    assert set(timers) == {"linearize", "select", "backward", "forward"}
    assert all(t >= 0 for t in timers.values())
    assert sum(timers.values()) > 0
    # profiled solve agrees with the fused solve
    fused = solve(system, prob, options=opts)
    assert result["T_star"] == int(fused.T_star)
    np.testing.assert_allclose(
        result["J_hist"][-1], float(fused.J_star), rtol=1e-8
    )


def test_profile_solve_bruteforce():
    system, prob = tiny_double_integrator()
    result, timers = profile_solve(
        system, prob, SolveOptions(method="bruteforce", max_iter=4)
    )
    assert timers["select"] > 0
    assert np.isfinite(result["J_hist"][-1])
