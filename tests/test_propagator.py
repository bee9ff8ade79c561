"""Property tests for the LFT propagator — the reference's core correctness
claim ("zero approximation error" vs the exact quadratic model, SURVEY.md
§4.1) as a real test suite:

1. factored-terminal propagator J(T) == independent NumPy Riccati oracle on
   random LTV problems (tight tolerance — the inverse-free query removes the
   reference's regularization error)
2. reference-parity inverse-terminal query agrees to the reference's own
   consistency level (~1e-4, cf. plots/summary.csv consistency_max_abs)
3. propagator J(T) == our brute-force curve
4. associative_scan prefix composition == sequential scan
5. the compose operator is associative (legality of associative_scan)
"""

import jax
import jax.numpy as jnp
import numpy as np

from tests.helpers import random_ltv_problem, riccati_J_curve_oracle
from timeopt.models.base import System
from timeopt.solver.augmented import (
    build_augmented,
    build_terminal_blocks,
    build_terminal_factors,
)
from timeopt.solver.horizon import (
    bruteforce_J_curve,
    lft_elements,
    lft_prefix_scan,
    propagator_J_curve,
    propagator_J_curve_factored,
    propagator_select,
)


def _setup(rng, seed_offset=0, n=3, m=2, N=12):
    step, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=n, m=m, N=N)
    system = System(name=f"ltv{seed_offset}", n=n, m=m, dt=0.1, step=step)
    A = jnp.broadcast_to(jnp.asarray(Ad), (N, n, n))
    B = jnp.broadcast_to(jnp.asarray(Bd), (N, n, m))
    return system, prob, A, B, jnp.asarray(X), jnp.asarray(U), Ad, Bd, X, U


def _oracle(prob, A, B, X, U):
    return riccati_J_curve_oracle(
        np.asarray(A), np.asarray(B), X, U,
        np.asarray(prob.xg), np.asarray(prob.u_ref),
        np.asarray(prob.Q), np.asarray(prob.R), np.asarray(prob.Qf),
        float(prob.w), prob.T_max,
    )


def test_factored_propagator_matches_riccati_oracle(rng):
    system, prob, A, B, Xj, Uj, Ad, Bd, X, U = _setup(rng)
    blocks = build_augmented(system, prob, Xj, Uj, A, B)
    C = build_terminal_factors(prob, Xj, s=blocks.s)
    J = float(blocks.s[0] ** 2) * np.asarray(
        propagator_select(blocks, C, terminal_mode="factored")
    )
    J_oracle = _oracle(prob, A, B, X, U)
    np.testing.assert_allclose(J, J_oracle, rtol=1e-6, atol=1e-9)


def test_inverse_propagator_matches_at_reference_consistency(rng):
    """The reference-parity query pays the regularization error of inverting
    the (singular) homogeneous terminal block — bounded at the level the
    reference itself reports (consistency_max_abs ~ 4e-4)."""
    system, prob, A, B, Xj, Uj, Ad, Bd, X, U = _setup(rng, seed_offset=3)
    blocks = build_augmented(system, prob, Xj, Uj, A, B)
    QT = build_terminal_blocks(prob, Xj, s=blocks.s)
    J = float(blocks.s[0] ** 2) * np.asarray(
        propagator_select(blocks, QT, terminal_mode="inverse")
    )
    J_oracle = _oracle(prob, A, B, X, U)
    np.testing.assert_allclose(J, J_oracle, rtol=1e-3, atol=1e-3)


def test_propagator_matches_bruteforce(rng):
    system, prob, A, B, Xj, Uj, *_ = _setup(rng, seed_offset=1)
    blocks = build_augmented(system, prob, Xj, Uj, A, B)
    C = build_terminal_factors(prob, Xj, s=blocks.s)
    J_prop = float(blocks.s[0] ** 2) * np.asarray(propagator_select(blocks, C))
    J_bf = np.asarray(bruteforce_J_curve(system, prob, A, B, Xj, Uj, lm_lambda=0.0))
    np.testing.assert_allclose(J_prop, J_bf, rtol=1e-6, atol=1e-9)


def test_associative_scan_matches_sequential(rng):
    system, prob, A, B, Xj, Uj, *_ = _setup(rng, seed_offset=2, N=15)
    blocks = build_augmented(system, prob, Xj, Uj, A, B)
    elems = lft_elements(blocks)
    seq = lft_prefix_scan(elems, mode="sequential")
    assoc = lft_prefix_scan(elems, mode="associative")
    for s, a in zip(seq, assoc):
        np.testing.assert_allclose(np.asarray(s), np.asarray(a), rtol=1e-9, atol=1e-10)
    C = build_terminal_factors(prob, Xj, s=blocks.s)
    np.testing.assert_allclose(
        np.asarray(propagator_J_curve_factored(seq, C)),
        np.asarray(propagator_J_curve_factored(assoc, C)),
        rtol=1e-9,
    )


def test_lft_compose_is_associative(rng):
    """(a∘b)∘c == a∘(b∘c) on random PD elements — the property that makes
    associative_scan legal."""
    from timeopt.solver.horizon import LFTElements, lft_compose

    def rand_elem(key_seed):
        r = np.random.default_rng(key_seed)
        H = r.standard_normal((4, 4))
        E = jnp.asarray(H @ H.T + np.eye(4))
        F = jnp.asarray(r.standard_normal((4, 4)))
        H2 = r.standard_normal((4, 4)) * 0.5
        G = jnp.asarray(H2 @ H2.T)
        return LFTElements(E=E, F=F, G=G)

    a, b, c = rand_elem(1), rand_elem(2), rand_elem(3)
    left = lft_compose(lft_compose(a, b), c)
    right = lft_compose(a, lft_compose(b, c))
    for l, r in zip(left, right):
        np.testing.assert_allclose(np.asarray(l), np.asarray(r), rtol=1e-8, atol=1e-9)


def test_consistency_check_utility():
    """User-facing consistency metric (reference consistency_max_abs/rmse):
    near-zero for the factored propagator on a solved trajectory."""
    from tests.helpers import tiny_double_integrator
    from timeopt.solver.ilqr import SolveOptions, solve
    from timeopt.solver.verify import consistency_check

    system, prob = tiny_double_integrator()
    res = solve(system, prob, options=SolveOptions(method="propagator", max_iter=6))
    # reference-parity configuration (bf regularized at 1e-6): difference is
    # the regularization itself, same ~4e-4 scale the reference publishes
    out = consistency_check(system, prob, res.X, res.U)
    assert float(out["max_abs"]) < 2e-3
    assert float(out["rmse"]) <= float(out["max_abs"])
    # regularization-free: the factored propagator is exact
    tight = consistency_check(system, prob, res.X, res.U, lm_lambda=0.0)
    assert float(tight["max_abs"]) < 1e-4  # ~40x below the reference's published delta
