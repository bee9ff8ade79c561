"""End-to-end solver tests.

The headline parity check reproduces the reference's committed artifact:
DoubleIntegrator T* = 25, J* = 6.5444 (reference plots/summary.csv:2-4,
BASELINE.md). N is shortened from 120 to 80 (= T_max): the tail
beyond T_max affects neither selection nor the truncated cost, so results are
identical while compiles stay fast on the CPU test host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.helpers import tiny_double_integrator
from timeopt.models import get_system
from timeopt.solver.ilqr import SolveOptions, solve, solve_batch, stack_problems


def test_double_integrator_matches_reference_artifact():
    system, mk = get_system("DoubleIntegrator")
    prob = mk(N=80)
    res = solve(system, prob, options=SolveOptions(method="propagator", max_iter=20))
    assert int(res.T_star) == 25
    assert abs(float(res.J_star) - 6.5444) < 5e-3
    assert int(res.n_accept) >= 2


def test_propagator_bruteforce_T_star_agree_tiny():
    system, prob = tiny_double_integrator()
    rp = solve(system, prob, options=SolveOptions(method="propagator", max_iter=8))
    rb = solve(system, prob, options=SolveOptions(method="bruteforce", max_iter=8))
    assert int(rp.T_star) == int(rb.T_star)
    np.testing.assert_allclose(float(rp.J_star), float(rb.J_star), rtol=1e-6)
    # selection curves on the final (identical) trajectories agree too
    np.testing.assert_allclose(
        np.asarray(rp.J_curve), np.asarray(rb.J_curve), rtol=1e-4
    )


def test_associative_scan_solve_matches_sequential():
    system, prob = tiny_double_integrator()
    r1 = solve(system, prob, options=SolveOptions(method="propagator", scan_mode="sequential"))
    r2 = solve(system, prob, options=SolveOptions(method="propagator", scan_mode="associative"))
    assert int(r1.T_star) == int(r2.T_star)
    np.testing.assert_allclose(float(r1.J_star), float(r2.J_star), rtol=1e-8)


def test_fd_modes_run():
    system, prob = tiny_double_integrator()
    for mode in ("central", "forward"):
        res = solve(
            system, prob,
            options=SolveOptions(method="propagator", linearize_mode=mode, max_iter=6),
        )
        assert np.isfinite(float(res.J_star))


def test_result_histories_consistent():
    system, prob = tiny_double_integrator()
    res = solve(system, prob, options=SolveOptions(method="propagator", max_iter=8))
    n = int(res.n_accept)
    J_hist = np.asarray(res.J_hist)
    T_hist = np.asarray(res.T_hist)
    assert np.all(np.isfinite(J_hist[:n])) and np.all(np.isnan(J_hist[n:]))
    assert np.all(T_hist[:n] >= prob.T_min) and np.all(T_hist[n:] == -1)
    assert float(res.J_star) == J_hist[n - 1]
    assert int(res.T_star) == T_hist[n - 1]
    # accepted costs are non-increasing
    assert np.all(np.diff(J_hist[:n]) <= 1e-9)


def test_batched_solve_matches_individual():
    system, prob = tiny_double_integrator()
    probs = []
    rng = np.random.default_rng(42)
    for _ in range(4):
        dx = rng.standard_normal(2) * 0.2
        probs.append(prob.replace(x0=prob.x0 + jnp.asarray(dx)))
    batched = stack_problems(probs)
    opts = SolveOptions(method="propagator", max_iter=8)
    rb = solve_batch(system, batched, options=opts)
    for i, p in enumerate(probs):
        ri = solve(system, p, options=opts)
        assert int(rb.T_star[i]) == int(ri.T_star)
        np.testing.assert_allclose(float(rb.J_star[i]), float(ri.J_star), rtol=1e-9)


def test_quadrotor_small_prop_equals_bruteforce():
    """Nonlinear 12-DoF quadrotor (reduced horizon for test speed):
    propagator and brute-force agree on T* and J*."""
    from timeopt.models.base import make_problem

    system, _ = get_system("Quadrotor")
    prob = make_problem(
        x0=[1.0, 1.0, 1.0] + [0.0] * 9,
        xg=[0.0] * 12,
        u_ref=[9.81, 0.0, 0.0, 0.0],
        Q=np.diag([5.0, 5, 5, 1, 1, 1, 20, 20, 10, 1, 1, 1]),
        R=np.diag([1e-3, 1e-2, 1e-2, 1e-2]),
        alpha=300.0,
        w=0.005,
        N=48,
        T_min=10,
        T_max=48,
        wrap_idx=(6, 7, 8),
    )
    rp = solve(system, prob, options=SolveOptions(method="propagator", max_iter=8))
    rb = solve(system, prob, options=SolveOptions(method="bruteforce", max_iter=8))
    assert int(rp.T_star) == int(rb.T_star)
    np.testing.assert_allclose(float(rp.J_star), float(rb.J_star), rtol=1e-6)
    assert np.isfinite(float(rp.J_star))


def test_pointmass_extra_cost_solve():
    """The extra-stage-cost hook (obstacle penalties) runs end-to-end and the
    solution avoids obstacle centers."""
    from timeopt.models.pointmass import OBSTACLES

    from timeopt.models.base import make_problem

    system, _ = get_system("PointMass_Navigation")
    prob = make_problem(
        x0=[-2.0, -2.0, 0.0, 0.0],
        xg=[2.0, 2.0, 0.0, 0.0],
        u_ref=[0.0, 0.0],
        Q=np.diag([0.0, 0.0, 0.15, 0.15]),
        R=np.diag([0.05, 0.05]),
        alpha=[250.0, 250.0, 30.0, 30.0],
        w=0.06,
        N=120,
        T_min=30,
        T_max=120,
    )
    res = solve(system, prob, options=SolveOptions(method="propagator", max_iter=8))
    assert np.isfinite(float(res.J_star))
    T = int(res.T_star)
    X = np.asarray(res.X)[: T + 1]
    for cx, cy, r, _ in OBSTACLES:
        d = np.sqrt((X[:, 0] - cx) ** 2 + (X[:, 1] - cy) ** 2)
        assert d.min() > 0.2 * r


def test_option_variants_agree():
    """inverse-terminal, unscaled, and FD-linearized variants all find the
    same horizon on the tiny problem."""
    system, prob = tiny_double_integrator()
    base = solve(system, prob, options=SolveOptions(method="propagator", max_iter=6))
    for opts in (
        SolveOptions(method="propagator", max_iter=6, terminal_mode="inverse"),
        SolveOptions(method="propagator", max_iter=6, homogeneous_scaling=False),
        SolveOptions(method="propagator", max_iter=6, psd_levels=1),
    ):
        r = solve(system, prob, options=opts)
        assert int(r.T_star) == int(base.T_star), opts
        np.testing.assert_allclose(float(r.J_star), float(base.J_star), rtol=1e-5)


def test_onepass_preimage_modes():
    system, prob = tiny_double_integrator()
    for mode in ("fixedpoint", "newton", "copy"):
        r = solve(
            system, prob,
            options=SolveOptions(method="onepass", max_iter=4, S_window=4,
                                 onepass_preimage=mode),
        )
        assert np.isfinite(float(r.J_star)), mode
