"""Benchmark-runner CLI tests: CSV schema parity with the reference
(reference run_suite.py outputs) and figure generation."""

import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from timeopt.runner import plot as plot_mod
from timeopt.runner.run_suite import main as suite_main

REFERENCE_COLUMNS = [
    "case", "trial", "solver", "status", "T_star", "J_star", "total_time",
    "final_err", "success", "n_iter", "solver_error",
]


@pytest.fixture(scope="module")
def suite_outdir(tmp_path_factory):
    out = tmp_path_factory.mktemp("suite")
    suite_main([
        "--outdir", str(out),
        "--trials", "3",
        "--max-iter", "6",
        "--cases", "DoubleIntegrator",
        "--solvers", "ourmethod,baseline1",
    ])
    return out


def test_summary_schema(suite_outdir):
    df = pd.read_csv(os.path.join(suite_outdir, "summary_all.csv"))
    for col in REFERENCE_COLUMNS + ["best_J", "cost_ratio_best", "time_base", "time_ratio_base"]:
        assert col in df.columns, col
    assert len(df) == 3 * 2  # trials x solvers
    assert set(df["solver"]) == {"ourmethod", "baseline1"}
    assert df["success"].all()
    # propagator == bruteforce horizon on every trial
    piv = df.pivot_table(index="trial", columns="solver", values="T_star")
    np.testing.assert_array_equal(piv["ourmethod"], piv["baseline1"])


def test_agg_schema(suite_outdir):
    agg = pd.read_csv(os.path.join(suite_outdir, "summary_agg.csv"))
    for col in ["case", "solver", "n", "success_rate", "T_median", "J_median",
                "time_median", "ratio_cost_median", "ratio_time_median"]:
        assert col in agg.columns
    assert (agg["success_rate"] == 1.0).all()


def test_per_case_outputs(suite_outdir):
    assert os.path.exists(os.path.join(suite_outdir, "DoubleIntegrator", "summary_all.csv"))
    assert os.path.exists(os.path.join(suite_outdir, "DoubleIntegrator", "summary_agg.csv"))


def test_plots(suite_outdir):
    pytest.importorskip("matplotlib")
    plot_mod.main([
        "--csv", os.path.join(suite_outdir, "summary_all.csv"),
        "--outdir", str(suite_outdir),
    ])
    for f in ["paper_main.png", "boxplot_cost_ratio.png", "boxplot_runtime_ratio.png",
              "boxplot_T_star.png"]:
        assert os.path.exists(os.path.join(suite_outdir, f))


def test_trajectory_plot(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "traj"
    suite_main([
        "--outdir", str(out), "--trials", "2", "--max-iter", "4",
        "--cases", "DoubleIntegrator", "--solvers", "ourmethod",
        "--save-trajectories",
    ])
    npz = out / "DoubleIntegrator" / "trajectories_ourmethod.npz"
    assert npz.exists()
    fig = plot_mod.plot_trajectories(
        {"ourmethod": str(npz)}, "DoubleIntegrator", str(out)
    )
    assert os.path.exists(fig)


def test_per_solve_timing(tmp_path):
    out = tmp_path / "persolve"
    suite_main([
        "--outdir", str(out), "--trials", "2", "--max-iter", "3",
        "--cases", "DoubleIntegrator", "--solvers", "ourmethod",
        "--timing", "per-solve",
    ])
    df = pd.read_csv(os.path.join(out, "summary_all.csv"))
    assert (df["total_time"] > 0).all()


def test_save_jt_curve(tmp_path):
    """--save-jt writes the reference *_Jt.csv artifact schema (t, J_<method>
    columns; reference plots/DoubleIntegrator_Jt.csv) with the
    propagator and bruteforce curves agreeing and the argmin at the
    published T*=25; plot_jt renders it."""
    out = tmp_path / "jt"
    suite_main([
        "--outdir", str(out),
        "--trials", "2",
        "--max-iter", "6",
        "--cases", "DoubleIntegrator",
        "--solvers", "ourmethod,baseline1,baseline2",
        "--save-jt",
    ])
    csv_path = out / "DoubleIntegrator" / "DoubleIntegrator_Jt.csv"
    assert csv_path.exists()
    df = pd.read_csv(csv_path)
    assert list(df.columns) == ["t", "J_propagator", "J_bruteforce", "J_onepass"] or set(
        df.columns
    ) == {"t", "J_propagator", "J_bruteforce", "J_onepass"}
    assert df["t"].iloc[0] == 1
    Jp = df["J_propagator"].to_numpy(float)
    Jb = df["J_bruteforce"].to_numpy(float)
    mask = np.isfinite(Jp) & np.isfinite(Jb)
    assert mask.any()
    np.testing.assert_allclose(Jp[mask], Jb[mask], rtol=1e-3, atol=1e-3)
    # published artifact: argmin t=25, J=6.5444 (reference plots CSV)
    t_star = int(df["t"][np.nanargmin(Jp)])
    assert t_star == 25
    assert abs(np.nanmin(Jp) - 6.5444) < 0.01
    png = plot_mod.plot_jt(str(csv_path), str(out))
    assert os.path.exists(png)


def test_phase_timer_columns(tmp_path):
    """--phase-timers adds trial-0 t_linearize/t_select/t_backward/t_forward
    columns (the reference's per-solve `timers` dict, solver.py:756-765,
    published as per-phase columns in plots/summary.csv) for curve methods
    AND one-pass."""
    out = tmp_path / "pt"
    suite_main([
        "--outdir", str(out),
        "--trials", "2",
        "--max-iter", "4",
        "--cases", "DoubleIntegrator",
        "--solvers", "ourmethod,baseline2",
        "--phase-timers",
    ])
    df = pd.read_csv(os.path.join(out, "summary_all.csv"))
    for col in ["t_linearize", "t_select", "t_backward", "t_forward"]:
        assert col in df.columns, col
        t0 = df[df["trial"] == 0][col]
        assert np.isfinite(t0).all() and (t0 >= 0).all()
        # non-trial-0 rows carry no phase columns
        assert df[df["trial"] != 0][col].isna().all()


def test_onepass_fallback_and_consistency_columns(tmp_path):
    """solver_error records one-pass sweep fallbacks (reference returns the
    exception repr as `onepass_error`, solver.py:764); --consistency adds the
    legacy summary.csv consistency columns with the published ~1e-4 scale."""
    out = tmp_path / "cc"
    suite_main([
        "--outdir", str(out),
        "--trials", "2",
        "--max-iter", "5",
        "--cases", "DoubleIntegrator",
        "--solvers", "ourmethod,baseline2",
        "--consistency",
    ])
    df = pd.read_csv(os.path.join(out, "summary_all.csv"))
    assert "solver_error" in df.columns
    assert "consistency_max_abs" in df.columns
    cc = df[(df["trial"] == 0) & (df["solver"] == "ourmethod")]["consistency_max_abs"]
    assert np.isfinite(cc).all()
    # reference publishes max|d| 4.3e-4 for DoubleIntegrator
    # (plots/summary.csv:2); same regularization-dominated scale here
    assert float(cc.iloc[0]) < 5e-3
    # healthy double-integrator sweeps never fall back
    b2 = df[df["solver"] == "baseline2"]["solver_error"]
    assert b2.isna().all()
