"""Committed-artifact reproducibility: re-run one committed suite case and
assert bitwise equality with the checked-in summary_all.csv rows.

This pins the stability contract of CLAUDE.md invariant 5 in CI: any change
to solver semantics (routing, masking, accept rules, numerics) that would
invalidate the committed `results/cpu_f64_25` artifact family fails here
instead of in a docstring. The CPU f64 path is the authority the committed
artifacts were generated from (regenerated at c807510).

Reference anchor for the suite semantics being reproduced:
reference run_suite.py:169-175 (success criterion + CSV schema).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_CSV = os.path.join(
    os.path.dirname(__file__), "..", "results", "cpu_f64_25", "summary_all.csv"
)


def _committed_rows(case, solver):
    with open(_CSV, newline="") as f:
        return [
            r
            for r in csv.DictReader(f)
            if r["case"] == case and r["solver"] == solver
        ]


@pytest.mark.skipif(not os.path.exists(_CSV), reason="committed artifacts absent")
def test_doubleintegrator_trial_rows_reproduce_bitwise():
    """Re-run the committed DoubleIntegrator 'ourmethod' case (all 25 trials,
    the exact batched entry the artifact was generated from: seed 0,
    max_iter=12, S_window=20, AD linearization, f64) and require BITWISE
    equality of T*/J* with the committed rows — float(J) round-trips
    exactly through the CSV's repr-precision formatting."""
    from timeopt.runner.run_suite import build_trial_problems
    from timeopt.solver.ilqr import SolveOptions, solve_batch

    committed = _committed_rows("DoubleIntegrator", "ourmethod")
    assert len(committed) == 25

    system, _, probs = build_trial_problems("DoubleIntegrator", 25, 0, jnp.float64)
    opts = SolveOptions(
        method="propagator", max_iter=12, S_window=20, linearize_mode="ad"
    )
    res = solve_batch(system, probs, options=opts)
    T = np.asarray(res.T_star)
    J = np.asarray(res.J_star)

    for row in committed:
        i = int(row["trial"])
        assert int(T[i]) == int(row["T_star"]), (i, int(T[i]), row["T_star"])
        assert float(J[i]) == float(row["J_star"]), (i, float(J[i]), row["J_star"])
    # n_iter (accepted iterations) is part of the committed schema too
    nacc = np.asarray(res.n_accept)
    for row in committed:
        assert int(nacc[int(row["trial"])]) == int(row["n_iter"])


@pytest.mark.skipif(not os.path.exists(_CSV), reason="committed artifacts absent")
def test_baseline2_trial0_reproduces_bitwise():
    """Same pin for the one-pass baseline (the other committed solver family
    with nontrivial selection logic), single case trial set."""
    from timeopt.runner.run_suite import build_trial_problems
    from timeopt.solver.ilqr import SolveOptions, solve_batch

    committed = _committed_rows("DoubleIntegrator", "baseline2")
    assert len(committed) == 25
    system, _, probs = build_trial_problems("DoubleIntegrator", 25, 0, jnp.float64)
    opts = SolveOptions(
        method="onepass", max_iter=12, S_window=20, linearize_mode="ad"
    )
    res = solve_batch(system, probs, options=opts)
    T = np.asarray(res.T_star)
    J = np.asarray(res.J_star)
    for row in committed:
        i = int(row["trial"])
        assert int(T[i]) == int(row["T_star"])
        assert float(J[i]) == float(row["J_star"])
