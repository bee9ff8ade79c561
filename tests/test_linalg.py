"""Unit tests for the batched Gauss-Jordan linear algebra core."""

import jax.numpy as jnp
import numpy as np
import pytest

from timeopt.ops.linalg import (
    as_terminal_weight,
    gj_inv,
    gj_inv_pivots,
    gj_solve,
    psd_inv,
    psd_solve,
    spd_check,
    sym,
)
from timeopt.ops.wrap import angle_normalize, wrap_error, wrap_mask_from_idx


def _rand_spd(rng, b, n, scale=1.0):
    H = rng.standard_normal((b, n, n)) * scale
    return H @ np.swapaxes(H, -1, -2) + 0.5 * np.eye(n)


def test_gj_inv_matches_numpy(rng):
    A = _rand_spd(rng, 16, 7)
    Ainv = np.asarray(gj_inv(jnp.asarray(A)))
    np.testing.assert_allclose(Ainv, np.linalg.inv(A), rtol=1e-8, atol=1e-8)


def test_gj_solve_matches_numpy(rng):
    A = _rand_spd(rng, 8, 5)
    B = rng.standard_normal((8, 5, 3))
    X = np.asarray(gj_solve(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(X, np.linalg.solve(A, B), rtol=1e-8, atol=1e-8)


def test_gj_solve_vector_rhs(rng):
    A = _rand_spd(rng, 4, 5)
    b = rng.standard_normal((4, 5))
    x = np.asarray(gj_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0], rtol=1e-8)


def test_gj_pivots_positive_iff_spd(rng):
    A = _rand_spd(rng, 1, 4)[0]
    _, piv = gj_inv_pivots(jnp.asarray(A))
    assert np.all(np.asarray(piv) > 0)
    assert bool(spd_check(jnp.asarray(A)))
    # indefinite matrix
    B = np.diag([1.0, -1.0, 2.0, 3.0])
    assert not bool(spd_check(jnp.asarray(B)))


def test_psd_inv_ladder_recovers_singular(rng):
    # exactly singular: rank-1; base jitter (1e-9) gives a huge but finite
    # inverse; ladder should still return finite values
    v = rng.standard_normal(4)
    A = np.outer(v, v)
    out = np.asarray(psd_inv(jnp.asarray(A), levels=3))
    assert np.all(np.isfinite(out))


def test_psd_solve_batch_matches_inverse(rng):
    A = _rand_spd(rng, 6, 4)
    b = rng.standard_normal((6, 4))
    x = np.asarray(psd_solve(jnp.asarray(A), jnp.asarray(b)))
    ref = np.einsum("bij,bj->bi", np.linalg.inv(A + 1e-9 * np.eye(4)), b)
    np.testing.assert_allclose(x, ref, rtol=1e-6, atol=1e-9)


def test_sym():
    A = jnp.asarray([[1.0, 2.0], [0.0, 3.0]])
    S = np.asarray(sym(A))
    np.testing.assert_allclose(S, S.T)


def test_as_terminal_weight_variants():
    np.testing.assert_allclose(as_terminal_weight(2.0, 3), 2.0 * np.eye(3))
    np.testing.assert_allclose(as_terminal_weight([1.0, 2.0], 2), np.diag([1.0, 2.0]))
    M = np.array([[2.0, 1.0], [0.0, 2.0]])
    np.testing.assert_allclose(as_terminal_weight(M, 2), 0.5 * (M + M.T))
    with pytest.raises(ValueError):
        as_terminal_weight([1.0, 2.0, 3.0], 2)


def test_angle_normalize_range():
    a = jnp.linspace(-10.0, 10.0, 101)
    out = np.asarray(angle_normalize(a))
    assert np.all(out > -np.pi - 1e-12) and np.all(out <= np.pi + 1e-12)
    np.testing.assert_allclose(np.cos(out), np.cos(np.asarray(a)), atol=1e-12)


def test_wrap_error_mask():
    mask = wrap_mask_from_idx([1], 3)
    e = jnp.asarray([4.0, 4.0, -4.0])
    out = np.asarray(wrap_error(e, jnp.asarray(mask)))
    assert out[0] == 4.0 and out[2] == -4.0
    np.testing.assert_allclose(out[1], 4.0 - 2 * np.pi)
