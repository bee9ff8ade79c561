"""df32 lanes one-pass sweep (solver/sweep_df.py): a batched f32 sweep must
reproduce the f64 sweep to far better than plain-f32 accuracy. Runs in plain
XLA on CPU."""

import jax
import jax.numpy as jnp
import numpy as np

from tests.helpers import tiny_double_integrator
from timeopt.models import get_system
from timeopt.solver.cost import rollout
from timeopt.solver.ilqr import default_U_init
from timeopt.solver.linearize import linearize
from timeopt.solver.onepass import extend_nominal_backward, value_sweep_prefix


def _sweep_inputs(system, prob, S, dtype):
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t
    )
    prob = cast(prob)
    U = default_U_init(prob) + jnp.asarray(0.05, dtype)
    X = rollout(system, prob, prob.x0, U)
    X_ext, U_ext = extend_nominal_backward(system, X, U, U[0], S)
    A_ext, B_ext = linearize(system.step, X_ext, U_ext, "ad")
    return prob, A_ext, B_ext, X_ext, U_ext


def test_batched_f32_sweep_is_df32_accurate():
    system, prob0 = tiny_double_integrator()
    S = 4
    T_bar = jnp.int32(10)

    # f64 oracle (unbatched plain path)
    prob, A, B, X, U = _sweep_inputs(system, prob0, S, jnp.float64)
    ref = value_sweep_prefix(system, prob, A, B, X, U, T_bar, S, jnp.float64(1e-6))

    # f32 batched -> custom_vmap routes to the df32 lanes sweep
    prob32, A32, B32, X32, U32 = _sweep_inputs(system, prob0, S, jnp.float32)
    Bb = 4
    tile = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.broadcast_to(a, (Bb,) + a.shape), t
    )
    sw = jax.jit(
        jax.vmap(
            lambda p, a, b, x, u: value_sweep_prefix(
                system, p, a, b, x, u, T_bar, S, jnp.float32(1e-6)
            )
        )
    )(tile(prob32), tile(A32), tile(B32), tile(X32), tile(U32))

    assert bool(ref.ok)
    assert bool(np.all(np.asarray(sw.ok)))
    V0_64 = np.asarray(ref.V0)
    V0_32 = np.asarray(sw.V0[0], np.float64)
    scale = np.maximum(np.abs(V0_64), 1.0)
    err_df = np.max(np.abs(V0_32 - V0_64) / scale)
    # df32 keeps ~1e-6 of f64 here (inputs are f32-rounded); plain f32
    # recursions sit orders of magnitude above that on long sweeps
    assert err_df < 5e-6, err_df
    np.testing.assert_allclose(
        np.asarray(sw.K[0], np.float64), np.asarray(ref.K), atol=5e-5, rtol=5e-4
    )
    # all lanes identical (same problem tiled)
    for lane in range(1, Bb):
        np.testing.assert_array_equal(np.asarray(sw.V0[lane]), np.asarray(sw.V0[0]))


def test_batched_f64_sweep_unchanged_by_dispatch():
    """The f64 batched path must still go through the plain implementation
    (bitwise equal to the unbatched sweep)."""
    system, prob0 = tiny_double_integrator()
    S = 3
    T_bar = jnp.int32(9)
    prob, A, B, X, U = _sweep_inputs(system, prob0, S, jnp.float64)
    ref = value_sweep_prefix(system, prob, A, B, X, U, T_bar, S, jnp.float64(1e-6))
    Bb = 3
    tile = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.broadcast_to(a, (Bb,) + a.shape), t
    )
    sw = jax.vmap(
        lambda p, a, b, x, u: value_sweep_prefix(
            system, p, a, b, x, u, T_bar, S, jnp.float64(1e-6)
        )
    )(tile(prob), tile(A), tile(B), tile(X), tile(U))
    np.testing.assert_array_equal(np.asarray(sw.V0[0]), np.asarray(ref.V0))
    np.testing.assert_array_equal(np.asarray(sw.K[1]), np.asarray(ref.K))


def test_cartpole_f32_sweep_close_to_f64():
    """The motivating case: a cartpole-length sweep in batched f32 must stay
    within ~1e-5 of the f64 V0 curve (plain f32 drifts ~1e-3)."""
    system, mk = get_system("Cartpole_SwingUp")
    S = 8
    base64 = mk(dtype=jnp.float64)
    # shorten the horizon for test runtime; keep the cartpole dynamics/cost
    import dataclasses

    short = lambda p: p.replace(  # noqa: E731
        N=80, T_max=60, T_min=10
    ) if hasattr(p, "replace") else p
    prob64 = short(base64)
    U = default_U_init(prob64)
    X = rollout(system, prob64, prob64.x0, U)
    X_ext, U_ext = extend_nominal_backward(system, X, U, U[0], S)
    A_ext, B_ext = linearize(system.step, X_ext, U_ext, "ad")
    T_bar = jnp.int32(50)
    ref = value_sweep_prefix(
        system, prob64, A_ext, B_ext, X_ext, U_ext, T_bar, S, jnp.float64(1e-6)
    )

    cast32 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        t,
    )
    prob32 = cast32(prob64)
    tile = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.broadcast_to(a, (2,) + a.shape), t
    )
    sw = jax.vmap(
        lambda p, a, b, x, u: value_sweep_prefix(
            system, p, a, b, x, u, T_bar, S, jnp.float32(1e-6)
        )
    )(
        tile(prob32),
        tile(cast32(A_ext)),
        tile(cast32(B_ext)),
        tile(cast32(X_ext)),
        tile(cast32(U_ext)),
    )
    V0_64 = np.asarray(ref.V0)
    V0_32 = np.asarray(sw.V0[0], np.float64)
    scale = np.maximum(np.abs(V0_64), 1.0)
    err = np.max(np.abs(V0_32 - V0_64) / scale)
    assert err < 2e-5, err
