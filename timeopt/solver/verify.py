"""Propagator ↔ brute-force consistency check.

Reference counterpart: the legacy pipeline's max|Δ|/RMSE comparison of the
two J(T) curves on the final trajectory (reference ilqr_propagator.py:
630-643), published as the `consistency_max_abs` / `consistency_rmse`
columns of plots/summary.csv — the closest thing the reference has to a
correctness test (SURVEY.md §4.1). Here it is a first-class utility (and a
property test in tests/test_propagator.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from timeopt.models.base import Problem, System
from timeopt.solver.augmented import build_augmented, build_terminal_factors
from timeopt.solver.horizon import bruteforce_J_curve, propagator_select
from timeopt.solver.linearize import linearize


def consistency_check(
    system: System,
    prob: Problem,
    X: jnp.ndarray,
    U: jnp.ndarray,
    *,
    linearize_mode: str = "ad",
    psd_levels: int = 2,
    lm_lambda: float = 1e-6,
):
    """Compare the propagator and brute-force J(T) curves on one trajectory.

    Returns dict(max_abs, rmse, J_prop, J_bf) over T in [T_min, T_max].

    With the reference's brute-force regularization (lm_lambda=1e-6) the
    difference is dominated by that regularization (~4e-4, the same scale
    the reference publishes); with lm_lambda=0 the factored propagator
    matches the exact quadratic model to ~1e-5 or better (fp64; residual is
    the q_reg/jitter regularization)."""
    Tm = prob.T_max
    A, B = linearize(system.step, X, U, linearize_mode)
    Xh, Uh, Ah, Bh = X[: Tm + 1], U[:Tm], A[:Tm], B[:Tm]

    blocks = build_augmented(system, prob, Xh, Uh, Ah, Bh, psd_levels=psd_levels)
    C = build_terminal_factors(prob, Xh, s=blocks.s)
    J_prop = blocks.s[0] ** 2 * propagator_select(
        blocks, C, psd_levels=psd_levels, terminal_mode="factored"
    )
    J_bf = bruteforce_J_curve(
        system, prob, Ah, Bh, Xh, Uh, psd_levels=psd_levels, lm_lambda=lm_lambda
    )

    lo = prob.T_min - 1
    d = (J_prop - J_bf)[lo:]
    return {
        "max_abs": jnp.max(jnp.abs(d)),
        "rmse": jnp.sqrt(jnp.mean(jnp.square(d))),
        "J_prop": J_prop,
        "J_bf": J_bf,
    }


def oracle_agreement(T, J, T_oracle, J_oracle, curve_oracle, w, *, j_rtol=1e-6):
    """Score solves against the f64 brute-force oracle (host NumPy).

    A problem is *exact* when its T* equals the oracle's; its J* must then
    agree to `j_rtol` relative. Otherwise it is *tied* when the oracle's own
    final J(T) curve rates the two horizons within the time penalty's
    resolution — |J_or(T) - J_or(T_or)| <= w * (|T - T_or| + 1), the
    landscape flat-tie rule of SolveResult.T_ties — and J* differs from the
    oracle's J* by no more than that same w-term (plus `j_rtol`), so the two
    picks are cost-equivalent minima of one flat valley, not a pick in
    another basin that happens to land on a flat stretch of the curve.

    T, J, T_oracle, J_oracle: (B,); curve_oracle: (B, T_max) with entry t-1
    holding J(T=t). Returns a dict of per-problem masks and counts; `agree`
    marks the problems that are exact (within j_rtol) or tied, and `ok` is
    True when every problem does."""
    T = np.asarray(T, np.int64)
    T_oracle = np.asarray(T_oracle, np.int64)
    J = np.asarray(J, np.float64)
    J_oracle = np.asarray(J_oracle, np.float64)
    curve = np.asarray(curve_oracle, np.float64)
    idx = np.arange(T.shape[0])
    exact = T == T_oracle
    j_abs = np.abs(J - J_oracle)
    j_rel = j_abs / np.maximum(np.abs(J_oracle), 1e-300)
    dT = np.abs(T - T_oracle)
    T_clip = np.clip(T, 1, curve.shape[1])
    dJ_curve = np.abs(curve[idx, T_clip - 1] - curve[idx, T_oracle - 1])
    in_range = (T >= 1) & (T <= curve.shape[1])
    tie_w = w * (dT + 1)
    tied = ~exact & in_range & (dJ_curve <= tie_w) & (j_abs <= tie_w + j_rtol * np.abs(J_oracle))
    agree = (exact & (j_rel <= j_rtol)) | tied
    return {
        "n": int(T.shape[0]),
        "exact": exact,
        "tied": tied,
        "agree": agree,
        "n_exact": int(exact.sum()),
        "n_tied": int(tied.sum()),
        "n_exact_or_tied": int((exact | tied).sum()),
        "max_j_rel_exact": float(j_rel[exact].max()) if exact.any() else 0.0,
        "max_j_rel_tied": float(j_rel[tied].max()) if tied.any() else 0.0,
        "ok": bool(np.all(agree)),
    }
