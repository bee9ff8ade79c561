"""Tests for the compensated df32 forward rollout (solver/rollout_df.py) and
the euler_step_fn/System.xdot refactor that enables it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from timeopt.models import cartpole, double_integrator, quadrotor
from timeopt.solver.cost import rollout
from timeopt.solver.ilqr import SolveOptions, default_U_init, solve
from timeopt.solver.rollout_df import rollout_df, supports_df


def test_step_consistency_with_xdot():
    """step(x,u) == wrap(x + dt*xdot(x,u)) for every system exposing xdot."""
    from timeopt.models import SYSTEMS, get_system

    for name in SYSTEMS:
        system, mk = get_system(name)
        if not supports_df(system):
            continue
        prob = mk()
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.standard_normal(system.n) * 0.3)
        u = jnp.asarray(rng.standard_normal(system.m) * 0.3)
        xn = system.step(x, u)
        expect = x + system.dt * system.xdot(x, u)
        keep = np.ones(system.n, bool)
        for i in system.wrap_idx:
            keep[i] = False
        np.testing.assert_allclose(np.asarray(xn)[keep], np.asarray(expect)[keep])


def test_df_rollout_beats_f32_double_integrator():
    """Linear system, deterministic: the df32 carry keeps the trajectory at
    ~f64 accuracy while plain f32 accumulates eps*|x| per step. The oracle
    rolls the *same f32-cast controls* in f64 arithmetic, so the comparison
    isolates rollout arithmetic noise from input rounding."""
    prob64 = double_integrator.default_problem(dtype=jnp.float64)
    prob32 = double_integrator.default_problem(dtype=jnp.float32)
    N = prob64.N
    U32 = jnp.asarray(np.sin(np.linspace(0.0, 6.0, N))[:, None]).astype(jnp.float32)
    X64 = np.asarray(
        rollout(double_integrator.SYSTEM, prob64, prob64.x0, U32.astype(jnp.float64))
    )
    X32 = np.asarray(rollout(double_integrator.SYSTEM, prob32, prob32.x0, U32), np.float64)
    Xdf = np.asarray(rollout_df(double_integrator.SYSTEM, prob32, prob32.x0, U32), np.float64)
    err32 = np.abs(X32 - X64).max()
    errdf = np.abs(Xdf - X64).max()
    # the df32 output is the f32 hi part, so ~2 ulp of max|x| (≈2.4e-7 here)
    # is the representation floor of this comparison; the point is that the
    # df error does NOT accumulate beyond it while plain f32 drifts.
    assert errdf < err32 * 0.5
    assert errdf < 4e-7


def test_df_rollout_cartpole_accuracy():
    """Nonlinear 360-step swing-up rollout: df32 strictly tighter than f32
    (both floored by the f32 rounding of the input controls)."""
    prob64 = cartpole.default_problem(dtype=jnp.float64)
    prob32 = cartpole.default_problem(dtype=jnp.float32)
    res64 = solve(cartpole.SYSTEM, prob64, options=SolveOptions(max_iter=6))
    T = int(res64.T_star)
    U32 = res64.U.astype(jnp.float32)
    # oracle: f64 arithmetic on the f32-cast controls
    X64 = np.asarray(rollout(cartpole.SYSTEM, prob64, prob64.x0, U32.astype(jnp.float64)))
    X32 = np.asarray(rollout(cartpole.SYSTEM, prob32, prob32.x0, U32), np.float64)
    Xdf = np.asarray(rollout_df(cartpole.SYSTEM, prob32, prob32.x0, U32), np.float64)

    def err(Xc):
        d = Xc[: T + 1] - X64[: T + 1]  # beyond T* the open-loop tail is chaotic
        d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi  # modulo-2pi angle
        return np.abs(d).max()

    assert err(Xdf) < err(X32) * 0.2
    assert err(Xdf) < 2e-5


def test_df_wrap_crosses_pi():
    """Spinning pole: the df wrap keeps theta bounded and equal to the f64
    trajectory modulo 2pi."""
    prob32 = cartpole.default_problem(dtype=jnp.float32)
    prob64 = cartpole.default_problem(dtype=jnp.float64)
    N = prob32.N
    U = jnp.full((N, 1), 2.5)  # constant push -> pole wraps repeatedly
    Xdf = np.asarray(rollout_df(cartpole.SYSTEM, prob32, prob32.x0, U.astype(jnp.float32)), np.float64)
    X64 = np.asarray(rollout(cartpole.SYSTEM, prob64, prob64.x0, U))
    assert np.all(np.abs(Xdf[:, 2]) <= np.pi + 1e-6)
    d = Xdf[:150] - X64[:150]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() < 1e-3


def test_df_rollout_guard_poisons():
    """Quadrotor NaN-poisoning semantics carry over to the df path."""
    prob32 = quadrotor.default_problem(dtype=jnp.float32)
    N = prob32.N
    # absurd torque drives |omega| past the guard -> poisoned tail
    U = jnp.zeros((N, 4), jnp.float32).at[:, 1].set(500.0).at[:, 0].set(9.81)
    Xdf = np.asarray(rollout_df(quadrotor.SYSTEM, prob32, prob32.x0, U))
    Xpl = np.asarray(rollout(quadrotor.SYSTEM, prob32, prob32.x0, U))
    assert np.isnan(Xdf[-1]).all()
    # poisoning starts at the same step as the plain path
    first_df = int(np.argmax(np.isnan(Xdf).any(axis=1)))
    first_pl = int(np.argmax(np.isnan(Xpl).any(axis=1)))
    assert abs(first_df - first_pl) <= 1


def test_cartpole_f32_solve_with_f64_selection():
    """The round-1 'cartpole is an f32 failure' diagnosis decomposed: with an
    f64-quality selection the f32 solve reproduces the f64 horizon sequence
    exactly — forward-pass f32 noise does not flip any accept decision.
    (The f64 selection stands in for an exact df32 selection.)"""
    opts64 = SolveOptions(max_iter=12)
    res64 = solve(cartpole.SYSTEM, cartpole.default_problem(dtype=jnp.float64), options=opts64)
    opts32 = SolveOptions(max_iter=12, select_dtype="float64")
    res32 = solve(cartpole.SYSTEM, cartpole.default_problem(dtype=jnp.float32), options=opts32)
    assert int(res32.T_star) == int(res64.T_star) == 181
    assert float(res32.J_star) == pytest.approx(float(res64.J_star), rel=1e-4)
    np.testing.assert_array_equal(np.asarray(res32.T_hist), np.asarray(res64.T_hist))


def test_df_forward_auto_resolution():
    """df_forward='auto' -> on for f32 + xdot, off for f64; 'on' without xdot
    raises."""
    from timeopt.solver.ilqr import _df_on
    import dataclasses

    assert _df_on(cartpole.SYSTEM, SolveOptions(), jnp.float32)
    assert not _df_on(cartpole.SYSTEM, SolveOptions(), jnp.float64)
    assert not _df_on(cartpole.SYSTEM, SolveOptions(df_forward="off"), jnp.float32)
    no_xdot = dataclasses.replace(cartpole.SYSTEM, xdot=None)
    assert not _df_on(no_xdot, SolveOptions(), jnp.float32)
    with pytest.raises(ValueError):
        _df_on(no_xdot, SolveOptions(df_forward="on"), jnp.float32)
