"""Latency-mode associative select (solver/select_assoc.py): df32
Hillis-Steele prefix scan with time on the lane axis.

Correctness contract: same J(T) as the sequential factored select —
- in f64 (double-double arithmetic) to near machine precision,
- in f32 (df32) to the f32 *input rounding* level (~1e-7 relative; the
  arithmetic itself is df32-exact, cf. ops/df32.py),
- identical under vmap, and end-to-end inside solve().
"""

import jax
import jax.numpy as jnp
import numpy as np

from tests.helpers import random_ltv_problem, tiny_double_integrator
from timeopt.models.base import System
from timeopt.solver.augmented import build_augmented, build_terminal_factors
from timeopt.solver.horizon import propagator_select
from timeopt.solver.ilqr import SolveOptions, default_U_init, solve
from timeopt.solver.select_assoc import (
    lft_elements_lanes_df,
    lft_prefix_scan_assoc_df,
    propagator_select_assoc_df,
)


def _setup(rng, n=3, m=2, N=12):
    step, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=n, m=m, N=N)
    system = System(name="ltv", n=n, m=m, dt=0.1, step=step)
    A = jnp.broadcast_to(jnp.asarray(Ad), (N, n, n))
    B = jnp.broadcast_to(jnp.asarray(Bd), (N, n, m))
    Xj, Uj = jnp.asarray(X), jnp.asarray(U)
    blocks = build_augmented(system, prob, Xj, Uj, A, B)
    C = build_terminal_factors(prob, Xj, s=blocks.s)
    return blocks, C


def test_assoc_matches_sequential_f64(rng):
    """Double-double associative scan == f64 sequential scan (non-power-of-2
    N exercises the masked tail lanes)."""
    for N in (12, 16, 17):
        blocks, C = _setup(rng, N=N)
        J_seq = np.asarray(propagator_select(blocks, C, terminal_mode="factored"))
        J_assoc = np.asarray(
            propagator_select_assoc_df(
                blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv, C
            )
        )
        np.testing.assert_allclose(J_assoc, J_seq, rtol=1e-10, atol=1e-12)


def test_assoc_df32_matches_f64_at_input_rounding(rng):
    """f32 assoc select vs the f64 sequential oracle.

    Tolerance note: XLA-*CPU* compilation degrades df32 — LLVM FP
    contraction replaces the rounded product Dekker's two_prod relies on
    with an exact FMA product when the multiply is rematerialized into a
    consumer fusion (measured: df_matmul error 2e-14 eager vs 5e-8 jitted
    on CPU; --xla_backend_optimization_level=0 restores exactness). The
    lax.scan in the prefix scan always compiles, so this CPU test can only
    assert ~1e-4 relative. What the GPU compiler makes of it is measured by
    scripts/phase_times.py (PERF.md)."""
    blocks, C = _setup(rng, N=14)
    J_seq = np.asarray(propagator_select(blocks, C, terminal_mode="factored"))
    c32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    J32 = np.asarray(
        propagator_select_assoc_df(
            c32(blocks.A_aug), c32(blocks.B_aug), c32(blocks.Q_aug),
            c32(blocks.R_inv), c32(C),
        )
    )
    np.testing.assert_allclose(J32, J_seq, rtol=1e-3, atol=1e-6)
    assert np.argmin(J32) == np.argmin(J_seq)


def test_assoc_t_min_mask(rng):
    blocks, C = _setup(rng, N=12)
    J = np.asarray(
        propagator_select_assoc_df(
            blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv, C, t_min=5
        )
    )
    assert np.all(np.isinf(J[:4]))
    assert np.all(np.isfinite(J[4:]))


def test_assoc_vmap_matches_loop(rng):
    blocks, C = _setup(rng, N=12)
    Av = jnp.stack([blocks.A_aug, 1.02 * blocks.A_aug, 0.98 * blocks.A_aug])
    f = lambda a: propagator_select_assoc_df(  # noqa: E731
        a, blocks.B_aug, blocks.Q_aug, blocks.R_inv, C
    )
    Jv = np.asarray(jax.vmap(f)(Av))
    for i in range(3):
        np.testing.assert_allclose(Jv[i], np.asarray(f(Av[i])), rtol=1e-12, atol=0)


def test_assoc_prefix_equals_sequential_composition(rng):
    """Lane k of the Hillis-Steele scan == left fold of elements 0..k (the
    scan's own correctness, independent of the terminal query)."""
    from timeopt.ops.lft_df import df_lft_compose

    blocks, C = _setup(rng, N=9)
    elems = lft_elements_lanes_df(
        blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv
    )
    pre = lft_prefix_scan_assoc_df(elems)
    # sequential left fold over single-lane slices
    lane = lambda t, k: tuple((h[..., k : k + 1], l[..., k : k + 1]) for h, l in t)  # noqa: E731
    acc = lane(elems, 0)
    for k in range(1, 9):
        acc = df_lft_compose(acc, lane(elems, k), jitter=1e-9)
        got = lane(pre, k)
        for (gh, gl), (ah, al) in zip(got, acc):
            np.testing.assert_allclose(
                np.asarray(gh + gl), np.asarray(ah + al), rtol=1e-9, atol=1e-11
            )


def test_solve_assoc_df_matches_sequential_e2e(rng):
    """Whole solve with scan_mode='assoc_df' == sequential scan_mode (CPU
    f64; identical T* and J to tight tolerance)."""
    system, prob = tiny_double_integrator()
    U0 = default_U_init(prob)
    r_seq = solve(system, prob, U0, SolveOptions(max_iter=6))
    r_assoc = solve(system, prob, U0, SolveOptions(max_iter=6, scan_mode="assoc_df"))
    assert int(r_seq.T_star) == int(r_assoc.T_star)
    np.testing.assert_allclose(
        float(r_assoc.J_star), float(r_seq.J_star), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(r_assoc.X), np.asarray(r_seq.X), rtol=1e-7, atol=1e-9
    )
