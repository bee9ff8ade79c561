"""Model sanity tests: equilibria, guard semantics, shapes, registry."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from timeopt.models import SYSTEMS, get_system


def test_registry_complete():
    assert set(SYSTEMS) == {
        "DoubleIntegrator",
        "Cartpole_SwingUp",
        "Quadrotor",
        "Segway_Balance",
        "Ballbot_Balance",
        "PointMass_Navigation",
    }


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_step_shapes_and_problem(name):
    system, mk = get_system(name)
    prob = mk()
    assert prob.x0.shape == (system.n,)
    assert prob.u_ref.shape == (system.m,)
    assert prob.Q.shape == (system.n, system.n)
    assert prob.R.shape == (system.m, system.m)
    assert prob.Qf.shape == (system.n, system.n)
    assert 1 <= prob.T_min <= prob.T_max <= prob.N
    xn = system.step(prob.x0, prob.u_ref)
    assert xn.shape == (system.n,)
    assert bool(jnp.all(jnp.isfinite(xn)))


def test_double_integrator_exact():
    system, mk = get_system("DoubleIntegrator")
    x = jnp.asarray([1.0, 2.0])
    u = jnp.asarray([3.0])
    xn = np.asarray(system.step(x, u))
    np.testing.assert_allclose(xn, [1.0 + 0.05 * 2.0, 2.0 + 0.05 * 3.0])


def test_quadrotor_hover_equilibrium():
    """At the origin with hover thrust, the quadrotor stays put."""
    system, mk = get_system("Quadrotor")
    prob = mk()
    x = jnp.zeros(12)
    xn = np.asarray(system.step(x, prob.u_ref))
    np.testing.assert_allclose(xn, np.zeros(12), atol=1e-12)


def test_quadrotor_guards_poison():
    system, _ = get_system("Quadrotor")
    u = jnp.asarray([9.81, 0.0, 0.0, 0.0])
    # pitch at the Euler singularity -> NaN state
    x = jnp.zeros(12).at[7].set(np.pi / 2)
    assert bool(jnp.all(jnp.isnan(system.step(x, u))))
    # absurd body rate -> NaN state
    x = jnp.zeros(12).at[9].set(2e3)
    assert bool(jnp.all(jnp.isnan(system.step(x, u))))
    # non-finite input -> NaN state
    x = jnp.zeros(12).at[0].set(jnp.nan)
    assert bool(jnp.all(jnp.isnan(system.step(x, u))))


def test_quadrotor_jacobian_finite_at_nominal():
    system, mk = get_system("Quadrotor")
    prob = mk()
    J = jax.jacfwd(lambda x: system.step(x, prob.u_ref))(prob.x0)
    assert bool(jnp.all(jnp.isfinite(J)))


def test_balance_systems_upright_fixed_point():
    for name in ("Segway_Balance", "Ballbot_Balance"):
        system, _ = get_system(name)
        x = jnp.zeros(4)
        u = jnp.zeros(1)
        np.testing.assert_allclose(np.asarray(system.step(x, u)), np.zeros(4), atol=1e-12)


def test_cartpole_down_fixed_point():
    """theta=0 is the stable down position: at rest with no force, the
    cart-pole does not move."""
    system, _ = get_system("Cartpole_SwingUp")
    xn = np.asarray(system.step(jnp.zeros(4), jnp.zeros(1)))
    np.testing.assert_allclose(xn, np.zeros(4), atol=1e-12)


def test_pointmass_obstacle_cost_ad_matches_analytic():
    """AD gradient/Hessian of the obstacle penalty match the closed form
    the reference hand-derives (reference systems.py:271-293)."""
    from timeopt.models.pointmass import OBSTACLES, obstacle_cost

    x = jnp.asarray([-0.5, -0.3, 0.1, 0.2])
    u = jnp.zeros(2)
    c = float(obstacle_cost(x, u))
    g = np.asarray(jax.grad(obstacle_cost, 0)(x, u))
    H = np.asarray(jax.hessian(obstacle_cost, 0)(x, u))

    p = np.asarray(x[:2])
    c_ref, g_ref, H_ref = 0.0, np.zeros(4), np.zeros((4, 4))
    for cx, cy, r, wgt in OBSTACLES:
        d = p - np.array([cx, cy])
        ci = wgt * np.exp(-(d @ d) / (2 * r * r))
        c_ref += ci
        g_ref[:2] += -(ci / (r * r)) * d
        H_ref[:2, :2] += ci * (np.outer(d, d) / r**4 - np.eye(2) / (r * r))
    np.testing.assert_allclose(c, c_ref, rtol=1e-12)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(H, H_ref, rtol=1e-10, atol=1e-12)


def test_safe_step_norm_guard():
    system, _ = get_system("DoubleIntegrator")
    x = jnp.asarray([1e7, 0.0])
    assert bool(jnp.all(jnp.isnan(system.safe_step(x, jnp.zeros(1)))))


def test_model_constants_do_not_depend_on_import_order():
    """Importing the package before x64 is enabled must not round the model
    constants to f32: an f64 solve then reads the same obstacle and inertia
    values as one whose process enabled x64 first."""
    import subprocess
    import sys

    code = (
        "import jax, numpy as np\n"
        "from timeopt.models import pointmass, quadrotor\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "x = jax.numpy.asarray([-0.7, -0.2, 0.0, 0.0], jax.numpy.float64)\n"
        "print(repr(float(pointmass.obstacle_cost(x, None))), repr(float(quadrotor._INERTIA[0])))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ).stdout.split()
    from timeopt.models import pointmass

    x = jnp.asarray([-0.7, -0.2, 0.0, 0.0], jnp.float64)
    assert float(out[0]) == float(pointmass.obstacle_cost(x, None))
    assert float(out[1]) == 0.02
