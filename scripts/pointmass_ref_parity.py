"""PointMass_Navigation curve-method parity proof.

The repo's curve methods (ourmethod/baseline1) score success 0.16 on the
25-trial PointMass obstacle case (results/cpu_f64_25) while baseline2
scores 1.0. docs/DESIGN.md argues this is inherent basin-sensitivity of
quadratic-model horizon selection on the non-convex obstacle landscape —
the reference itself comments the case out of its default registry
(reference run_suite.py:43). This script EXECUTES the reference
implementation (pure NumPy, imported from the directory given as its
argument — executed for cross-checking, not copied) on the repo's exact 25-trial set and records
the same row schema, so the two implementations' failure patterns can be
compared side by side.

Output: results/cpu_f64_25/PointMass_Navigation/reference_curve_methods.csv

Usage: python scripts/pointmass_ref_parity.py <reference-source-dir>
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # self-locating: run bare, no PYTHONPATH needed

import sys
import time

import numpy as np
import pandas as pd

import jax

jax.config.update("jax_platforms", "cpu")  # trial-set replication only

if len(sys.argv) != 2:
    raise SystemExit("usage: python scripts/pointmass_ref_parity.py <reference-source-dir>")
sys.path.insert(0, sys.argv[1])

import solver as ref_solver  # noqa: E402
import systems as ref_systems  # noqa: E402

OUT = "results/cpu_f64_25/PointMass_Navigation/reference_curve_methods.csv"
TRIALS = 25
SEED = 0
MAX_ITER = 12
TOL = 0.5


def repo_trials():
    """The repo suite's exact trial set (runner/run_suite.build_trial_problems
    with seed 0): trial 0 nominal, others x0 + sigma*N(0,1)."""
    from timeopt.runner.run_suite import _case_rng
    from timeopt.models import get_system

    system, mk = get_system("PointMass_Navigation")
    base = mk()
    rng = _case_rng(SEED, "PointMass_Navigation")
    sx = np.asarray(system.sigma_x0, float)
    sg = np.asarray(system.sigma_xg, float)
    x0s = [np.asarray(base.x0, float)]
    xgs = [np.asarray(base.xg, float)]
    for _ in range(1, TRIALS):
        x0s.append(np.asarray(base.x0, float) + sx * rng.standard_normal(system.n))
        xgs.append(np.asarray(base.xg, float) + sg * rng.standard_normal(system.n))
    return np.stack(x0s), np.stack(xgs)


def main():
    (F, x0_nom, xg_nom, u_ref, Q, R, alpha, w, N, T_min, T_max, wrap_idx, extra) = (
        ref_systems.make_pointmass_navigation()
    )
    # the reference packs the obstacle-cost hook inside the `extra` dict
    # (reference run_suite.py:103)
    extra = extra.get("extra_stage_cost") if isinstance(extra, dict) else None
    x0s, xgs = repo_trials()
    solvers = {
        "ourmethod": ref_solver.ilqr_timeopt_ourmethod,
        "baseline1": ref_solver.ilqr_timeopt_baseline1,
        "baseline2": ref_solver.ilqr_timeopt_baseline2,
    }
    rows = []
    for trial in range(TRIALS):
        for name, fn in solvers.items():
            t0 = time.perf_counter()
            try:
                out = fn(
                    F, x0s[trial], xgs[trial], u_ref, Q, R, alpha, w, N,
                    T_min, T_max, max_iter=MAX_ITER, wrap_idx=wrap_idx,
                    extra_stage_cost=extra,
                )
                dt = time.perf_counter() - t0
                T_star = int(out["T_star"])
                # the reference runner reads J* from J_hist
                # (reference run_suite.py:161)
                J_star = float(out["J_hist"][-1]) if out.get("J_hist") else float("inf")
                eT = out["X"][T_star] - xgs[trial]
                ferr = float(np.linalg.norm(eT))
                ok = bool(np.isfinite(J_star) and ferr <= TOL)
                rows.append(
                    dict(trial=trial, solver=name, status="ok", T_star=T_star,
                         J_star=J_star, final_err=ferr, success=ok, time=dt)
                )
            except Exception as e:  # reference raises typed numerical errors
                rows.append(
                    dict(trial=trial, solver=name, status="crash", T_star=-1,
                         J_star=np.nan, final_err=np.nan, success=False,
                         time=time.perf_counter() - t0)
                )
                print(f"trial {trial} {name}: CRASH {type(e).__name__}: {e}",
                      flush=True)
        done = [r for r in rows if r["trial"] == trial]
        print(
            f"trial {trial}: "
            + "  ".join(
                f"{r['solver']} T*={r['T_star']} ok={r['success']}" for r in done
            ),
            flush=True,
        )

    df = pd.DataFrame(rows)
    df.to_csv(OUT, index=False)
    print(f"\nwrote {OUT}")
    print(df.groupby("solver").agg(
        success=("success", "mean"), T_median=("T_star", "median"),
        J_median=("J_star", "median"), time_median=("time", "median"),
    ))


if __name__ == "__main__":
    main()
