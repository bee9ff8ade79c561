"""Figure generation from summary_all.csv — behavioral parity with
reference plot.py (robust ratio recomputation, success-only filtering,
2-panel paper figure, per-case boxplots), new implementation.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _load(csv_path):
    import pandas as pd

    df = pd.read_csv(csv_path)
    # recompute ratios robustly (reference plot.py:52-83)
    best = df.groupby(["case", "trial"])["J_star"].transform("min")
    df["cost_ratio_best"] = df["J_star"] / best
    if (df["solver"] == "baseline1").any():
        bt = (
            df[df["solver"] == "baseline1"][["case", "trial", "total_time"]]
            .rename(columns={"total_time": "time_base"})
        )
        df = df.drop(columns=[c for c in ("time_base", "time_ratio_base") if c in df], errors="ignore")
        df = df.merge(bt, on=["case", "trial"], how="left")
        df["time_ratio_base"] = df["total_time"] / df["time_base"]
    return df


def _success_only(df):
    ok = df.groupby(["case", "trial"])["success"].transform("all")
    return df[ok]


def paper_main(df, outdir):
    """2-panel median+IQR errorbar figure: runtime ratio (log scale) and cost
    ratio per case/solver (reference plot.py:115-196)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cases = sorted(df["case"].unique())
    solvers = sorted(df["solver"].unique())
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    xs = np.arange(len(cases))
    width = 0.8 / max(len(solvers), 1)

    for j, (col, ax, title, logy) in enumerate(
        [
            ("time_ratio_base", axes[0], "runtime / baseline1", True),
            ("cost_ratio_best", axes[1], "cost / best", False),
        ]
    ):
        for si, s in enumerate(solvers):
            med, lo, hi = [], [], []
            for c in cases:
                v = df[(df["case"] == c) & (df["solver"] == s)][col].dropna()
                if len(v) == 0:
                    med.append(np.nan); lo.append(0); hi.append(0)
                else:
                    q1, q2, q3 = np.percentile(v, [25, 50, 75])
                    med.append(q2); lo.append(q2 - q1); hi.append(q3 - q2)
            ax.errorbar(
                xs + (si - (len(solvers) - 1) / 2) * width,
                med,
                yerr=[lo, hi],
                fmt="o",
                capsize=3,
                label=s,
            )
        ax.set_xticks(xs)
        ax.set_xticklabels(cases, rotation=20, ha="right")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        if logy:
            ax.set_yscale("log")
    axes[0].legend()
    fig.tight_layout()
    out = os.path.join(outdir, "paper_main.png")
    fig.savefig(out, dpi=160)
    plt.close(fig)
    return out


def boxplots(df, outdir):
    """Per-case boxplots of cost ratio / runtime ratio / T*
    (reference plot.py:198-264)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    outs = []
    for col, name in [
        ("cost_ratio_best", "cost_ratio"),
        ("time_ratio_base", "runtime_ratio"),
        ("T_star", "T_star"),
    ]:
        cases = sorted(df["case"].unique())
        solvers = sorted(df["solver"].unique())
        fig, axes = plt.subplots(1, len(cases), figsize=(3.2 * len(cases), 3.6), squeeze=False)
        for ci, c in enumerate(cases):
            ax = axes[0][ci]
            data = [
                df[(df["case"] == c) & (df["solver"] == s)][col].dropna().values
                for s in solvers
            ]
            ax.boxplot(data, tick_labels=solvers)
            ax.set_title(c, fontsize=9)
            ax.tick_params(axis="x", rotation=30)
            ax.grid(True, alpha=0.3)
        fig.suptitle(name)
        fig.tight_layout()
        out = os.path.join(outdir, f"boxplot_{name}.png")
        fig.savefig(out, dpi=160)
        plt.close(fig)
        outs.append(out)
    return outs


PHASES = ("linearize", "select", "backward", "forward")


def timing_breakdown(df, outdir):
    """Stacked per-phase timing bars per case/solver from the suite's
    t_linearize/t_select/t_backward/t_forward columns (`run_suite
    --phase-timers`). Reference counterpart: the legacy pipeline's
    "Computation Time Breakdown" panel
    (reference ilqr_propagator.py:831-852)."""
    cols = [f"t_{p}" for p in PHASES]
    if not all(c in df.columns for c in cols):
        return []
    sub = df.dropna(subset=cols)
    if sub.empty:
        return []
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    cases = sorted(sub["case"].unique())
    fig, axes = plt.subplots(1, len(cases), figsize=(3.4 * len(cases), 3.8), squeeze=False)
    colors = dict(zip(PHASES, ("#4ECDC4", "#FF6B6B", "#95E1D3", "#FFE66D")))
    for ci, c in enumerate(cases):
        ax = axes[0][ci]
        cdf = sub[sub["case"] == c].groupby("solver")[cols].first()
        solvers = list(cdf.index)
        x = np.arange(len(solvers))
        bottom = np.zeros(len(solvers))
        for p in PHASES:
            vals = cdf[f"t_{p}"].values.astype(float)
            ax.bar(x, vals, 0.55, bottom=bottom, label=p.capitalize(), color=colors[p])
            bottom += vals
        for i, tot in enumerate(bottom):
            ax.text(i, tot, f"{tot:.3f}s", ha="center", va="bottom", fontsize=8)
        ax.set_xticks(x)
        ax.set_xticklabels(solvers, rotation=30, fontsize=8)
        ax.set_title(c, fontsize=9)
        ax.grid(True, alpha=0.3, axis="y")
    axes[0][0].set_ylabel("time (s)")
    axes[0][-1].legend(fontsize=8)
    fig.suptitle("Computation time breakdown (trial 0)")
    fig.tight_layout()
    out = os.path.join(outdir, "timing_breakdown.png")
    fig.savefig(out, dpi=160)
    plt.close(fig)
    return [out]


def per_case_figures(outdir):
    """Render the reference's per-case artifact family from whatever the
    runner saved under <outdir>/<case>/: a J(T)-curve figure for each
    <case>_Jt.csv (`--save-jt`) and a solver-comparison trajectory figure
    for each set of trajectories_<solver>.npz (`--save-trajectories`).
    Reference counterparts: plots/<case>_Jt.png and
    plots/<case>_trajectories.png, emitted by the legacy pipeline
    (reference ilqr_propagator.py:840-864, 727-757)."""
    outs = []
    for case in sorted(os.listdir(outdir)):
        case_dir = os.path.join(outdir, case)
        if not os.path.isdir(case_dir):
            continue
        jt_csv = os.path.join(case_dir, f"{case}_Jt.csv")
        if os.path.isfile(jt_csv):
            outs.append(plot_jt(jt_csv, case_dir, case_name=case))
        npzs = {
            fn[len("trajectories_"):-len(".npz")]: os.path.join(case_dir, fn)
            for fn in sorted(os.listdir(case_dir))
            if fn.startswith("trajectories_") and fn.endswith(".npz")
        }
        if npzs:
            outs.append(plot_trajectories(npzs, case, case_dir))
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", type=str, default="ilqr_results/summary_all.csv")
    ap.add_argument("--outdir", type=str, default="ilqr_results")
    ap.add_argument("--all-trials", action="store_true", help="include failed trials")
    args = ap.parse_args(argv)

    df = _load(args.csv)
    if not args.all_trials:
        df = _success_only(df)
    os.makedirs(args.outdir, exist_ok=True)
    outs = (
        [paper_main(df, args.outdir)]
        + boxplots(df, args.outdir)
        + timing_breakdown(df, args.outdir)
        + per_case_figures(args.outdir)
    )
    for o in outs:
        print("wrote", o)


if __name__ == "__main__":
    main()


def plot_trajectories(npz_paths_by_solver, case_name, outdir, trial=0, T_stars=None):
    """Per-case state/control trajectory figure comparing solvers
    (reference counterpart: plot_trajectories in the legacy monolith,
    reference ilqr_propagator.py:727-757). `npz_paths_by_solver` maps
    solver name -> trajectories_<solver>.npz written by the runner's
    --save-trajectories flag."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = {}
    for solver, path in npz_paths_by_solver.items():
        z = np.load(path)
        data[solver] = dict(
            X=z["X"][trial], U=z["U"][trial], T=int(z["T_star"][trial])
        )
    any_d = next(iter(data.values()))
    n = any_d["X"].shape[1]
    m = any_d["U"].shape[1]
    styles = {
        "ourmethod": dict(color="#2E86AB", linestyle="-", linewidth=2.2),
        "baseline2": dict(color="#A23B72", linestyle="--", linewidth=2.2),
        "baseline1": dict(color="#F18F01", linestyle="-.", linewidth=1.8),
    }
    rows = max(n, m)
    fig, axes = plt.subplots(rows, 2, figsize=(11, 2.2 * rows), squeeze=False)
    for i in range(n):
        ax = axes[i][0]
        for solver, d in data.items():
            T = d["T"]
            ax.plot(np.arange(T + 1), d["X"][: T + 1, i],
                    label=solver, **styles.get(solver, {}))
        ax.set_ylabel(f"x_{i+1}")
        ax.grid(True, alpha=0.3)
    for j in range(m):
        ax = axes[j][1]
        for solver, d in data.items():
            T = d["T"]
            ax.step(np.arange(T), d["U"][:T, j], where="post",
                    label=solver, **styles.get(solver, {}))
        ax.set_ylabel(f"u_{j+1}")
        ax.grid(True, alpha=0.3)
    axes[0][0].legend(fontsize=8)
    fig.suptitle(case_name)
    fig.tight_layout()
    out = os.path.join(outdir, f"{case_name}_trajectories.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_jt(csv_path, outdir, case_name=None):
    """J(T) selection-curve figure from a <case>_Jt.csv written by the
    runner's --save-jt flag (reference counterpart: the legacy pipeline's
    *_Jt.png, reference ilqr_propagator.py:840-856). One curve per
    method column, argmin of each marked."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.read_csv(csv_path)
    if case_name is None:
        case_name = os.path.basename(csv_path).replace("_Jt.csv", "")
    styles = {
        "J_propagator": dict(color="#2E86AB", linestyle="-", linewidth=2.2),
        "J_onepass": dict(color="#A23B72", linestyle="--", linewidth=2.2),
        "J_bruteforce": dict(color="#F18F01", linestyle="-.", linewidth=1.8),
    }
    fig, ax = plt.subplots(figsize=(7, 4))
    t = df["t"].to_numpy()
    for col in df.columns:
        if col == "t":
            continue
        J = df[col].to_numpy(float)
        ax.plot(t, J, label=col[2:], **styles.get(col, {}))
        if np.isfinite(J).any():
            i = int(np.nanargmin(J))
            ax.plot(t[i], J[i], "o", ms=6,
                    color=styles.get(col, {}).get("color", "k"))
    ax.set_xlabel("horizon T")
    ax.set_ylabel("J(T)")
    ax.set_title(f"{case_name}: selection curve J(T)")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=9)
    fig.tight_layout()
    out = os.path.join(outdir, f"{case_name}_Jt.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out
