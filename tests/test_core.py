"""Tests for rollout / cost / linearization / backward / forward primitives
on tiny problems (fast compiles)."""

import jax
import jax.numpy as jnp
import numpy as np

from tests.helpers import tiny_double_integrator
from timeopt.solver.backward import backward_truncated
from timeopt.solver.cost import argmin_T, cost_true, nominal_cost_curve, rollout
from timeopt.solver.forward import forward_linesearch
from timeopt.solver.ilqr import default_U_init
from timeopt.solver.linearize import linearize, linearize_ad, linearize_fd


def _setup():
    system, prob = tiny_double_integrator()
    U = default_U_init(prob) + 0.1
    X = rollout(system, prob, prob.x0, U)
    return system, prob, X, U


def test_rollout_matches_manual():
    system, prob, X, U = _setup()
    x = np.asarray(prob.x0)
    for k in range(prob.N):
        x = np.array([x[0] + 0.05 * x[1], x[1] + 0.05 * float(U[k, 0])])
        np.testing.assert_allclose(np.asarray(X[k + 1]), x, rtol=1e-12)


def test_rollout_nan_poisons_tail():
    system, prob, _, U = _setup()
    Ubad = U.at[3, 0].set(jnp.nan)
    X = rollout(system, prob, prob.x0, Ubad)
    assert bool(jnp.all(jnp.isfinite(X[:4])))
    assert bool(jnp.all(jnp.isnan(X[4:])))


def test_cost_true_manual():
    system, prob, X, U = _setup()
    T = 7
    J = float(cost_true(system, prob, X, U, jnp.int32(T)))
    Xn, Un = np.asarray(X), np.asarray(U)
    Q, R = np.asarray(prob.Q), np.asarray(prob.R)
    xg, uref = np.asarray(prob.xg), np.asarray(prob.u_ref)
    ref = 0.0
    for k in range(T):
        e = Xn[k] - xg
        du = Un[k] - uref
        ref += 0.5 * e @ Q @ e + 0.5 * du @ R @ du + float(prob.w)
    eT = Xn[T] - xg
    ref += 0.5 * eT @ np.asarray(prob.Qf) @ eT
    np.testing.assert_allclose(J, ref, rtol=1e-12)


def test_cost_true_inf_on_bad_or_zero_T():
    system, prob, X, U = _setup()
    assert float(cost_true(system, prob, X, U, jnp.int32(0))) == np.inf
    Xbad = X.at[2, 0].set(jnp.nan)
    assert float(cost_true(system, prob, Xbad, U, jnp.int32(5))) == np.inf
    # NaN beyond T* does not matter
    Xok = X.at[-1, 0].set(jnp.nan)
    assert np.isfinite(float(cost_true(system, prob, Xok, U, jnp.int32(5))))


def test_linearize_ad_vs_fd():
    system, prob, X, U = _setup()
    A1, B1 = linearize_ad(system.step, X, U)
    A2, B2 = linearize_fd(system.step, X, U, mode="central")
    A3, B3 = linearize_fd(system.step, X, U, mode="forward")
    np.testing.assert_allclose(np.asarray(A1), np.asarray(A2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(B1), np.asarray(B2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(A1), np.asarray(A3), atol=1e-4)
    # linear system: AD jacobian is the exact discrete map
    np.testing.assert_allclose(
        np.asarray(A1[0]), [[1.0, 0.05], [0.0, 1.0]], rtol=1e-12
    )


def test_nominal_cost_curve_and_argmin():
    system, prob, X, U = _setup()
    J = nominal_cost_curve(system, prob, X, U)
    assert J.shape == (prob.T_max,)
    Jn = np.asarray(J)
    assert np.all(np.isinf(Jn[: prob.T_min - 1]))
    assert np.all(np.isfinite(Jn[prob.T_min - 1 :]))
    T = int(argmin_T(J, prob.T_min, prob.T_max))
    assert prob.T_min <= T <= prob.T_max
    assert Jn[T - 1] == Jn[prob.T_min - 1 :].min()


def test_backward_forward_decreases_cost():
    system, prob, X, U = _setup()
    A, B = linearize(system.step, X, U, "ad")
    T_star = jnp.int32(10)
    bw = backward_truncated(system, prob, A, B, X, U, T_star, jnp.float64(1e-3))
    assert bool(bw.ok)
    # gains zero beyond T*
    assert np.allclose(np.asarray(bw.K[10:]), 0.0)
    assert np.allclose(np.asarray(bw.kappa[10:]), 0.0)
    ls = forward_linesearch(system, prob, X, U, bw.K, bw.kappa, T_star)
    assert bool(ls.accepted)
    assert float(ls.J) < float(cost_true(system, prob, X, U, T_star))


def test_backward_not_ok_on_nan_traj():
    system, prob, X, U = _setup()
    A, B = linearize(system.step, X, U, "ad")
    Xbad = X.at[5].set(jnp.nan)
    bw = backward_truncated(system, prob, A, B, Xbad, U, jnp.int32(10), jnp.float64(1e-3))
    assert not bool(bw.ok)
