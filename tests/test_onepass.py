"""One-pass baseline tests: prefix construction, sweep vs backward-pass
consistency, pick semantics, end-to-end solve."""

import jax
import jax.numpy as jnp
import numpy as np

from tests.helpers import tiny_double_integrator
from timeopt.solver.cost import rollout
from timeopt.solver.ilqr import SolveOptions, default_U_init, solve
from timeopt.solver.linearize import linearize
from timeopt.solver.onepass import (
    extend_nominal_backward,
    fixedpoint_preimage_step,
    onepass_pick,
    value_sweep_prefix,
)


def test_fixedpoint_preimage_linear_exact():
    """For the double integrator the preimage equation is linear; the damped
    fixed-point iteration should land close to a true preimage."""
    system, prob = tiny_double_integrator()
    x_next = jnp.asarray([1.0, 0.5])
    u = jnp.asarray([0.2])
    x_prev = fixedpoint_preimage_step(system.step, x_next, u, n_iter=30)
    np.testing.assert_allclose(
        np.asarray(system.step(x_prev, u)), np.asarray(x_next), atol=1e-4
    )


def test_extend_nominal_backward_shapes_and_feasibility():
    system, prob = tiny_double_integrator()
    U = default_U_init(prob)
    X = rollout(system, prob, prob.x0, U)
    S = 5
    X_ext, U_ext = extend_nominal_backward(system, X, U, U[0], S, n_iter=30)
    assert X_ext.shape == (S + prob.N + 1, 2)
    assert U_ext.shape == (S + prob.N, 1)
    np.testing.assert_allclose(np.asarray(X_ext[S:]), np.asarray(X))
    # prefix is approximately dynamically feasible
    for s in range(S):
        xn = np.asarray(system.step(X_ext[s], U_ext[s]))
        np.testing.assert_allclose(xn, np.asarray(X_ext[s + 1]), atol=1e-3)


def test_value_sweep_matches_bruteforce_V0():
    """V0 at i = T̄ - T + S from the single sweep equals the brute-force
    value expansion J(T̄) when queried at the nominal start (T = T̄ ⇒ dx0=0,
    prefix unused)."""
    from timeopt.solver.horizon import value_expansion_V0

    system, prob = tiny_double_integrator()
    U = default_U_init(prob) + 0.05
    X = rollout(system, prob, prob.x0, U)
    A, B = linearize(system.step, X, U, "ad")
    S = 4
    X_ext, U_ext = extend_nominal_backward(system, X, U, U[0], S)
    A_pre, B_pre = linearize(system.step, X_ext[: S + 1], U_ext[:S], "ad")
    A_ext = jnp.concatenate([A_pre, A], 0)
    B_ext = jnp.concatenate([B_pre, B], 0)

    T_bar = jnp.int32(10)
    sweep = value_sweep_prefix(
        system, prob, A_ext, B_ext, X_ext, U_ext, T_bar, S, jnp.float64(1e-6)
    )
    assert bool(sweep.ok)
    # i = T_bar - T + S with T = T_bar -> i = S: V0 there is J(T̄) of the
    # quadratic model built on the same trajectory
    V0_at_S = float(sweep.V0[S])
    J_bf = float(
        value_expansion_V0(system, prob, A, B, X, U, jnp.int32(10), lm_lambda=1e-6)
    )
    np.testing.assert_allclose(V0_at_S, J_bf, rtol=1e-6)


def test_onepass_pick_window_and_center_out():
    system, prob = tiny_double_integrator()
    U = default_U_init(prob)
    X = rollout(system, prob, prob.x0, U)
    A, B = linearize(system.step, X, U, "ad")
    S = 4
    X_ext, U_ext = extend_nominal_backward(system, X, U, U[0], S)
    A_pre, B_pre = linearize(system.step, X_ext[: S + 1], U_ext[:S], "ad")
    A_ext = jnp.concatenate([A_pre, A], 0)
    B_ext = jnp.concatenate([B_pre, B], 0)
    T_bar = jnp.int32(10)
    sweep = value_sweep_prefix(
        system, prob, A_ext, B_ext, X_ext, U_ext, T_bar, S, jnp.float64(1e-6)
    )
    T_star, Jw = onepass_pick(
        prob, sweep, X_ext, X_ext[S], T_bar, S, jnp.int32(3), jnp.int32(3)
    )
    Jw = np.asarray(Jw)
    # only window candidates evaluated
    lo, hi = max(prob.T_min, 10 - 3), min(prob.T_max, 10 + 3)
    for T in range(1, prob.T_max + 1):
        if T < lo or T > hi:
            assert np.isnan(Jw[T - 1])
    # T* is the argmin over evaluated entries
    vals = {T: Jw[T - 1] for T in range(lo, hi + 1) if np.isfinite(Jw[T - 1])}
    assert int(T_star) == min(vals, key=lambda T: (vals[T], abs(T - 10), T))


def test_onepass_solve_e2e():
    system, prob = tiny_double_integrator()
    res = solve(
        system, prob,
        options=SolveOptions(method="onepass", max_iter=8, S_window=5),
    )
    assert np.isfinite(float(res.J_star))
    assert prob.T_min <= int(res.T_star) <= prob.T_max
    # one-pass should land near the propagator optimum on this easy problem
    rp = solve(system, prob, options=SolveOptions(method="propagator", max_iter=8))
    assert abs(int(res.T_star) - int(rp.T_star)) <= 3
    assert float(res.J_star) <= 1.1 * float(rp.J_star)
