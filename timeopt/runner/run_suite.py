"""Benchmark suite runner — CLI + CSV schema parity with the reference
(reference run_suite.py), batched execution.

Same flags (--outdir --trials --seed --max-iter --S-window --use-central-diff
--success-tol --solvers --cases), same output schema (summary_all.csv /
summary_agg.csv with columns case, trial, solver, status, T_star, J_star,
total_time, final_err, success, n_iter, solver_error, best_J,
cost_ratio_best, time_base, time_ratio_base), same success criterion
(finite J* and ||wrap(x_T* - xg)|| <= tol, reference run_suite.py:169-175).

Differences (batched execution):
- All trials of a (case, solver) run as ONE batched vmapped solve; per-trial
  `total_time` is the batch wall-clock divided by the number of trials
  (amortized). `--timing per-solve` instead times each trial individually
  (compile cached after the first) for single-solve latency numbers.
- Trial sampling uses a stable CRC32 case hash instead of Python's salted
  `hash()` (the reference's seeding is not reproducible across processes).
- Numerical failures surface as non-finite J* rows (status="fail") rather
  than exceptions; there is no "crash" status because the jittable solver
  cannot throw (reference exception policy: run_suite.py:137-156).
"""

from __future__ import annotations

import argparse
import os
import time
import zlib

import numpy as np

import jax
import jax.numpy as jnp


CASES = [
    "DoubleIntegrator",
    "Cartpole_SwingUp",
    "Quadrotor",
    "Segway_Balance",
    "Ballbot_Balance",
]

# Available via --cases but not in the default suite — mirrors the reference,
# which ships the obstacle point-mass but leaves it commented out of its case
# registry (reference run_suite.py:43).
EXTRA_CASES = ["PointMass_Navigation"]

SOLVER_METHODS = {
    "ourmethod": "propagator",
    "baseline1": "bruteforce",
    "baseline2": "onepass",
}


def _case_rng(seed: int, case: str) -> np.random.Generator:
    return np.random.default_rng(int(seed) + zlib.crc32(case.encode()) % 10_000)


def build_trial_problems(case: str, trials: int, seed: int, dtype):
    """Trial 0 = nominal x0/xg; trials 1.. = Gaussian-perturbed with the
    per-case sigmas (reference run_suite.py:69-74, 114-120)."""
    from timeopt.models import get_system
    from timeopt.solver.ilqr import stack_problems

    system, mk = get_system(case)
    base = mk(dtype=dtype)
    rng = _case_rng(seed, case)

    sx = np.asarray(system.sigma_x0, float)
    sg = np.asarray(system.sigma_xg, float)
    x0s = [np.asarray(base.x0)]
    xgs = [np.asarray(base.xg)]
    for _ in range(1, trials):
        x0s.append(np.asarray(base.x0) + sx * rng.standard_normal(system.n))
        xgs.append(np.asarray(base.xg) + sg * rng.standard_normal(system.n))

    probs = stack_problems([base] * trials)
    probs = probs.replace(
        x0=jnp.asarray(np.stack(x0s), dtype), xg=jnp.asarray(np.stack(xgs), dtype)
    )
    return system, base, probs


def run_case(
    case: str,
    *,
    trials: int,
    seed: int,
    solvers,
    max_iter: int,
    S_window: int,
    use_central_diff: bool,
    success_tol: float,
    timing: str = "amortized",
    dtype=jnp.float64,
    save_trajectories: bool = False,
    save_jt: bool = False,
    consistency: bool = False,
    phase_timers: bool = False,
    distributed: bool = False,
    outdir: str = ".",
):
    from timeopt.ops.wrap import wrap_error
    from timeopt.solver.ilqr import SolveOptions, solve_batch, solve

    system, base, probs = build_trial_problems(case, trials, seed, dtype)
    lin_mode = "central" if use_central_diff else "ad"

    if distributed:
        # multi-host: every process builds the SAME deterministic trial set,
        # solves only its contiguous slice over the global mesh, and
        # all-gathers the results so the row computation below is identical
        # on every host (host-0 writes the artifacts — see main()).
        from timeopt.parallel import distributed as dist

        mesh = dist.global_mesh()
        lo, hi = dist.process_batch_bounds(trials)
        local = jax.tree.map(lambda x: x[lo:hi], probs)

        def _solve_all(opts):
            res = dist.solve_batch_global(system, local, options=opts, mesh=mesh)
            return jax.tree.map(jnp.asarray, dist.gather_results(res))

    else:

        def _solve_all(opts):
            return solve_batch(system, probs, options=opts)

    rows = []
    jt_cols = {}
    for solver_name in solvers:
        method = SOLVER_METHODS[solver_name]
        opts = SolveOptions(
            method=method, max_iter=max_iter, S_window=S_window, linearize_mode=lin_mode
        )

        # live progress (reference: tqdm bar with per-trial postfix,
        # reference run_suite.py:113,156,191 — here the trials run as
        # ONE batched device call, so progress is per (case, solver) stage)
        print(
            f"[{case}] {solver_name}: solving {trials} trials "
            f"(batched, max_iter={max_iter}) ...",
            flush=True,
        )
        # warmup/compile on the full batch, then time
        t0 = time.perf_counter()
        res = _solve_all(opts)
        jax.block_until_ready(res)
        compile_and_run = time.perf_counter() - t0

        if timing == "per-solve":
            per_trial_times = []
            for i in range(trials):
                pi = jax.tree.map(lambda x: x[i], probs)
                t0 = time.perf_counter()
                ri = solve(system, pi, options=opts)
                jax.block_until_ready(ri)
                per_trial_times.append(time.perf_counter() - t0)
                # live per-trial progress with the reference's tqdm postfix
                # fields (reference run_suite.py:113,191)
                print(
                    f"\r[{case}] {solver_name}: trial {i + 1}/{trials}  "
                    f"T={int(ri.T_star)} J={float(ri.J_star):.4g} "
                    f"t={per_trial_times[-1]*1e3:.0f}ms ",
                    end="" if i + 1 < trials else "\n",
                    flush=True,
                )
        else:
            t0 = time.perf_counter()
            res = _solve_all(opts)
            jax.block_until_ready(res)
            batch_time = time.perf_counter() - t0
            per_trial_times = [batch_time / trials] * trials

        T = np.asarray(res.T_star)
        J = np.asarray(res.J_star)
        X = np.asarray(res.X)
        nacc = np.asarray(res.n_accept)
        nfb = np.asarray(res.n_fallback)
        # flat-tie set size (SolveResult.T_ties): horizons cost-equivalent
        # with T* on the final curve under the w·(|dT|+1) landscape
        # criterion; 1 = unique minimum
        ntied = np.asarray(res.T_ties).sum(axis=-1)

        if save_trajectories:
            case_dir = os.path.join(outdir, case)
            os.makedirs(case_dir, exist_ok=True)
            np.savez_compressed(
                os.path.join(case_dir, f"trajectories_{solver_name}.npz"),
                X=X, U=np.asarray(res.U), T_star=T, J_star=J,
                J_hist=np.asarray(res.J_hist), T_hist=np.asarray(res.T_hist),
            )
        if save_jt:
            # trial-0 final J(T) curve; non-finite entries (below T_min /
            # outside the one-pass window) become empty CSV cells — matching
            # the reference artifact schema (t, J_<method> columns;
            # reference ilqr_propagator.py:858-864, plots/*_Jt.csv)
            curve = np.asarray(res.J_curve[0], float)
            jt_cols[f"J_{method}"] = np.where(np.isfinite(curve), curve, np.nan)
        cc_max = cc_rmse = float("nan")
        if consistency:
            # propagator vs brute-force J(T) agreement on this solver's
            # trial-0 final trajectory (legacy pipeline's consistency_max_abs
            # / consistency_rmse, reference ilqr_propagator.py:630-643,
            # published in plots/summary.csv). Meaningful in f64; at f32 the
            # XLA curves themselves are precision-limited.
            from timeopt.solver.verify import consistency_check

            prob0 = jax.tree.map(lambda x: x[0], probs)
            cc = consistency_check(
                system, prob0, jnp.asarray(X[0]), jnp.asarray(res.U[0])
            )
            cc_max = float(cc["max_abs"])
            cc_rmse = float(cc["rmse"])
        phase_cols = {}
        if phase_timers:
            # trial-0 per-phase device-time breakdown — the reference returns
            # a per-solve `timers` dict (reference solver.py:756-765)
            # and publishes t_linearize/t_select/t_backward/t_forward columns
            # (plots/summary.csv). The fused batched solve has no phase
            # boundaries, so this re-solves trial 0 through the host-driven
            # phase profiler (utils/timing.py); first call warms the
            # per-phase jit caches, the second is reported.
            from timeopt.utils.timing import profile_any

            prob0 = jax.tree.map(lambda x: x[0], probs)
            profile_any(system, prob0, opts)
            _, timers = profile_any(system, prob0, opts)
            phase_cols = {f"t_{k}": float(v) for k, v in timers.items()}

        xg = np.asarray(probs.xg)
        wrap_mask = np.asarray(base.wrap_mask)

        for i in range(trials):
            eT = np.asarray(
                wrap_error(jnp.asarray(X[i, T[i]] - xg[i]), jnp.asarray(wrap_mask))
            )
            final_err = float(np.linalg.norm(eT))
            success = bool(
                np.isfinite(J[i]) and np.isfinite(final_err) and final_err <= success_tol
            )
            rows.append(
                {
                    "case": case,
                    "trial": i,
                    "solver": solver_name,
                    "status": "ok" if success else "fail",
                    "T_star": int(T[i]),
                    "J_star": float(J[i]),
                    "total_time": float(per_trial_times[i]),
                    "final_err": final_err,
                    "success": success,
                    "n_iter": int(nacc[i]),
                    "n_tied": int(ntied[i]),
                    # one-pass sweep-failure fallback record — the reference
                    # returns the last exception repr as `onepass_error`
                    # (reference solver.py:764); branchless analogue:
                    # how many iterations used the fixed-T-bar fallback
                    "solver_error": (
                        f"sweep_fallback_iters={int(nfb[i])}"
                        if method == "onepass" and int(nfb[i]) > 0
                        else None
                    ),
                    "compile_and_run_s": float(compile_and_run),
                    **(
                        {"consistency_max_abs": cc_max, "consistency_rmse": cc_rmse}
                        if consistency and i == 0
                        else {}
                    ),
                    **(phase_cols if i == 0 else {}),
                }
            )
        print(
            f"[{case}] {solver_name}: median T*="
            f"{int(np.median(T))} median J*={np.median(J):.4g} "
            f"time/solve={np.median(per_trial_times)*1e3:.2f} ms "
            f"success={np.mean([r['success'] for r in rows if r['solver']==solver_name and r['case']==case]):.2f}",
            flush=True,
        )
    if save_jt and jt_cols:
        import pandas as pd

        case_dir = os.path.join(outdir, case)
        os.makedirs(case_dir, exist_ok=True)
        T_max = int(base.T_max)
        data = {"t": np.arange(1, T_max + 1)}
        data.update(jt_cols)
        pd.DataFrame(data).to_csv(
            os.path.join(case_dir, f"{case}_Jt.csv"), index=False
        )
    return rows


def enrich_and_aggregate(df, solvers):
    """best_J / cost_ratio_best / time_ratio_base enrichment + per-(case,
    solver) aggregation (reference run_suite.py:196-292)."""
    import pandas as pd

    best = df.groupby(["case", "trial"])["J_star"].transform("min")
    df["best_J"] = best
    df["cost_ratio_best"] = df["J_star"] / df["best_J"]

    if "baseline1" in solvers:
        base_time = (
            df[df["solver"] == "baseline1"][["case", "trial", "total_time"]]
            .rename(columns={"total_time": "time_base"})
        )
        df = df.merge(base_time, on=["case", "trial"], how="left")
        df["time_ratio_base"] = df["total_time"] / df["time_base"]
    else:
        df["time_base"] = np.nan
        df["time_ratio_base"] = np.nan

    agg = (
        df.groupby(["case", "solver"])
        .agg(
            n=("trial", "count"),
            success_rate=("success", "mean"),
            T_median=("T_star", "median"),
            J_median=("J_star", "median"),
            time_median=("total_time", "median"),
            ratio_cost_median=("cost_ratio_best", "median"),
            ratio_time_median=("time_ratio_base", "median"),
        )
        .reset_index()
    )
    return df, agg


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", type=str, default="ilqr_results")
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iter", type=int, default=12)
    ap.add_argument("--S-window", type=int, default=20)
    ap.add_argument("--use-central-diff", action="store_true")
    ap.add_argument("--success-tol", type=float, default=0.5)
    ap.add_argument("--solvers", type=str, default="ourmethod,baseline1,baseline2")
    ap.add_argument("--cases", type=str, default="")
    ap.add_argument("--timing", choices=["amortized", "per-solve"], default="amortized")
    ap.add_argument(
        "--f32", action="store_true",
        help="solve in float32 (the plain-f32 select recursion; f64 is the reference precision)",
    )
    ap.add_argument(
        "--save-trajectories", action="store_true",
        help="save per-case solved trajectories (X, U, T*, J*) to <outdir>/<case>/trajectories_<solver>.npz",
    )
    ap.add_argument(
        "--save-jt", action="store_true",
        help="save the trial-0 J(T) selection curve per case/solver to <outdir>/<case>/<case>_Jt.csv (reference plots/*_Jt.csv schema)",
    )
    ap.add_argument(
        "--distributed", action="store_true",
        help="multi-host run: jax.distributed.initialize() (cluster auto-detect), trials sharded over the global (hosts x local devices) mesh, results all-gathered, CSVs written by process 0 only",
    )
    ap.add_argument(
        "--phase-timers", action="store_true",
        help="add trial-0 per-phase timer columns t_linearize/t_select/t_backward/t_forward (reference plots/summary.csv schema) via the host-driven phase profiler",
    )
    ap.add_argument(
        "--consistency", action="store_true",
        help="report propagator-vs-bruteforce J(T) consistency (max|d|, rmse) on each solver's trial-0 final trajectory (legacy summary.csv columns)",
    )
    args = ap.parse_args(argv)

    if args.distributed:
        # must precede any backend-initializing jax call in this process
        from timeopt.parallel import distributed as dist

        dist.initialize()
        if args.timing == "per-solve" or args.phase_timers:
            raise ValueError(
                "--distributed supports only amortized timing (per-solve/phase "
                "profiling is single-process host-driven)"
            )

    from timeopt.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    solvers = [s.strip() for s in args.solvers.split(",") if s.strip()]
    for s in solvers:
        if s not in SOLVER_METHODS:
            raise ValueError(f"Unknown solver: {s}. Options: {list(SOLVER_METHODS)}")

    cases = (
        [c.strip() for c in args.cases.split(",") if c.strip()] if args.cases.strip() else CASES
    )
    for c in cases:
        if c not in CASES + EXTRA_CASES:
            raise ValueError(f"Unknown case: {c}. Options: {CASES + EXTRA_CASES}")

    dtype = jnp.float32 if args.f32 else jnp.float64
    if not args.f32:
        jax.config.update("jax_enable_x64", True)

    # multi-host: artifacts are single-writer (host 0) — every process
    # computes identical rows from the all-gathered results, only one writes
    is_writer = (not args.distributed) or jax.process_index() == 0

    if is_writer:
        os.makedirs(args.outdir, exist_ok=True)
    all_rows = []
    for case in cases:
        rows = run_case(
            case,
            trials=args.trials,
            seed=args.seed,
            solvers=solvers,
            max_iter=args.max_iter,
            S_window=args.S_window,
            use_central_diff=args.use_central_diff,
            success_tol=args.success_tol,
            timing=args.timing,
            dtype=dtype,
            save_trajectories=args.save_trajectories and is_writer,
            save_jt=args.save_jt and is_writer,
            consistency=args.consistency,
            phase_timers=args.phase_timers,
            distributed=args.distributed,
            outdir=args.outdir,
        )
        df_case, agg_case = enrich_and_aggregate(pd.DataFrame(rows), solvers)
        if is_writer:
            case_dir = os.path.join(args.outdir, case)
            os.makedirs(case_dir, exist_ok=True)
            df_case.to_csv(os.path.join(case_dir, "summary_all.csv"), index=False)
            agg_case.to_csv(os.path.join(case_dir, "summary_agg.csv"), index=False)
        all_rows.extend(rows)

    df_all, agg_all = enrich_and_aggregate(pd.DataFrame(all_rows), solvers)
    if is_writer:
        df_all.to_csv(os.path.join(args.outdir, "summary_all.csv"), index=False)
        agg_all.to_csv(os.path.join(args.outdir, "summary_agg.csv"), index=False)

        print("\nSaved:")
        print(" ", os.path.join(args.outdir, "summary_all.csv"))
        print(" ", os.path.join(args.outdir, "summary_agg.csv"))
        print(agg_all.to_string(index=False))


if __name__ == "__main__":
    main()
