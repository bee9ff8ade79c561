"""Batched (vmap) == per-problem results for the three hot phases of the
solver — select, backward and forward — on every model at a tiny horizon.

A batch solve is the per-problem program under `vmap`, which XLA batches
like any other function; these tests pin that the batched program computes
what each problem computes alone. Tolerance: f64 with rtol 1e-10 — batched
and unbatched matrix products may sum in another order (a few ulps), and
nothing here amplifies that by more than a few orders of magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from timeopt.models import SYSTEMS, get_system
from timeopt.solver.backward import backward_truncated
from timeopt.solver.cost import argmin_T, rollout
from timeopt.solver.forward import forward_linesearch
from timeopt.solver.ilqr import SolveOptions, _select_curve, default_U_init
from timeopt.solver.linearize import linearize

CASES = sorted(SYSTEMS)
B = 3
RTOL = 1e-10


def _batch(case):
    """B tiny-horizon problems (N=12, T in [2, 10]) with perturbed x0 and
    their nominal rollouts and Jacobians, stacked on a leading axis."""
    system, mk = get_system(case)
    base = mk(dtype=jnp.float64).replace(N=12, T_min=2, T_max=10)
    rng = np.random.default_rng(3)
    x0 = np.asarray(base.x0)
    x0s = x0 + 0.05 * (np.abs(x0) + 1.0) * rng.standard_normal((B, x0.size))
    probs = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), base)
    probs = probs.replace(x0=jnp.asarray(x0s))

    def nominal(p):
        U = default_U_init(p)
        X = rollout(system, p, p.x0, U)
        A, Bm = linearize(system.step, X, U, "ad")
        return X, U, A, Bm

    X, U, A, Bm = jax.vmap(nominal)(probs)
    return system, probs, X, U, A, Bm


def _one(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _assert_close(batched, singles):
    for i, single in enumerate(singles):
        for b_leaf, s_leaf in zip(jax.tree.leaves(_one(batched, i)), jax.tree.leaves(single)):
            b_leaf, s_leaf = np.asarray(b_leaf), np.asarray(s_leaf)
            if b_leaf.dtype == np.bool_ or np.issubdtype(b_leaf.dtype, np.integer):
                np.testing.assert_array_equal(b_leaf, s_leaf)
            else:
                np.testing.assert_allclose(b_leaf, s_leaf, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_select_batched_matches_single(case):
    system, probs, X, U, A, Bm = _batch(case)
    opts = SolveOptions()
    f = jax.jit(lambda p, x, u, a, b: _select_curve(system, p, opts, x, u, a, b))
    batched = jax.vmap(f)(probs, X, U, A, Bm)
    singles = [f(_one(probs, i), X[i], U[i], A[i], Bm[i]) for i in range(B)]
    assert np.isfinite(np.asarray(batched)[:, 1:]).all()
    _assert_close(batched, singles)


@pytest.mark.parametrize("case", CASES)
def test_backward_batched_matches_single(case):
    system, probs, X, U, A, Bm = _batch(case)
    T = jnp.asarray([6, 8, 10], jnp.int32)
    lm = jnp.full((B,), 1e-3)
    f = jax.jit(
        lambda p, a, b, x, u, t, l: backward_truncated(system, p, a, b, x, u, t, l)
    )
    batched = jax.vmap(f)(probs, A, Bm, X, U, T, lm)
    singles = [f(_one(probs, i), A[i], Bm[i], X[i], U[i], T[i], lm[i]) for i in range(B)]
    assert np.asarray(batched.ok).all()
    _assert_close(batched, singles)


@pytest.mark.parametrize("case", CASES)
def test_forward_batched_matches_single(case):
    system, probs, X, U, A, Bm = _batch(case)
    lm = jnp.full((B,), 1e-3)
    opts = SolveOptions()

    def phase(p, x, u, a, b, l):
        J = _select_curve(system, p, opts, x, u, a, b)
        T = argmin_T(J, p.T_min, p.T_max)
        bw = backward_truncated(system, p, a, b, x, u, T, l)
        return forward_linesearch(system, p, x, u, bw.K, bw.kappa, T, alphas=opts.alphas)

    f = jax.jit(phase)
    batched = jax.vmap(f)(probs, X, U, A, Bm, lm)
    singles = [f(_one(probs, i), X[i], U[i], A[i], Bm[i], lm[i]) for i in range(B)]
    assert np.isfinite(np.asarray(batched.J)).all()
    _assert_close(batched, singles)
