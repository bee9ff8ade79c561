"""The CPU-testable parts of chip_smoke.py: its device check, the
exact-or-tied oracle scorer (timeopt/solver/verify.py) and the per-problem
gate it applies, the committed CPU picks that gate reads, and the problem
draw it shares with scripts/oracle_match.py (timeopt/runner/oracle_set.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from timeopt.models import get_system
from timeopt.parallel.mesh import make_mesh, solve_batch_sharded
from timeopt.runner.oracle_set import make_x0s, suffix
from timeopt.solver.ilqr import SolveOptions, broadcast_problem
from timeopt.solver.verify import oracle_agreement

RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "results")


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices())
    # a string code exits with status 1 and names what is missing
    assert isinstance(exc.value.code, str) and "no GPU" in exc.value.code


# Synthetic oracle curves over T = 1..8 with w = 0.1: problem 0 has a sharp
# minimum at T=4; problem 1 a flat valley over T = 5..6.
_CURVE = np.asarray(
    [
        [9.0, 5.0, 2.0, 1.0, 2.0, 5.0, 9.0, 12.0],
        [9.0, 5.0, 2.0, 1.5, 1.02, 1.0, 3.0, 12.0],
    ]
)
_T_OR = np.asarray([4, 6])
_J_OR = np.asarray([100.0, 200.0])


@pytest.mark.parametrize(
    "T, J, n_exact, n_tied, ok",
    [
        ([4, 6], [100.0, 200.0], 2, 0, True),  # both exact
        ([4, 5], [100.0, 200.02], 1, 1, True),  # T=5 within w*(1+1) on the flat valley
        ([3, 6], [101.0, 200.0], 1, 0, False),  # T=3 is 1.0 above the sharp minimum
        ([4, 6], [100.001, 200.0], 2, 0, False),  # exact T but J off by 1e-5 relative
        ([4, 5], [100.0, 230.0], 1, 0, False),  # flat T=5 but J in another basin
    ],
)
def test_oracle_scorer_exact_or_tied(T, J, n_exact, n_tied, ok):
    sc = oracle_agreement(T, J, _T_OR, _J_OR, _CURVE, 0.1, j_rtol=1e-6)
    assert (sc["n_exact"], sc["n_tied"], sc["ok"]) == (n_exact, n_tied, ok)
    assert sc["n_exact_or_tied"] == n_exact + n_tied


@pytest.mark.parametrize("case", chip_smoke.ORACLE_CASES)
def test_x0_draw_prefix_matches_oracle(case):
    """The first 128 rows of chip_smoke's B=1024 draw are the committed
    oracle's own initial states, so one solve serves both checks."""
    oracle = np.load(os.path.join(RESULTS, f"oracle_f64{suffix(case)}.npz"))
    system, mk = get_system(case)
    base = mk(dtype=jnp.float64)
    x0s = make_x0s(case, np.asarray(base.x0, np.float64), system.sigma_x0, chip_smoke.BATCH, 0)
    assert x0s.shape == (chip_smoke.BATCH, system.n)
    np.testing.assert_array_equal(x0s[: chip_smoke.ORACLE_B], oracle["X"][:, 0])


_ORACLE = {"T": _T_OR, "J": _J_OR, "J_curve": _CURVE}


@pytest.mark.parametrize(
    "T, J, moved, cpu_T, cpu_J, failed, rounding_only, ok",
    [
        ([4, 6], [100.0, 200.0], [False, False], [4, 6], [100.0, 200.0], [], [], True),
        # problem 0 misses the oracle but is the CPU propagator's own pick
        ([3, 6], [101.0, 200.0], [False, False], [3, 6], [101.0, 200.0], [], [], True),
        # problem 0 misses both, and its T* does not move under one ulp
        ([3, 6], [101.0, 200.0], [False, False], [4, 6], [100.0, 200.0], [0], [], False),
        # the same miss on a rounding-sensitive problem passes, and is listed
        ([3, 6], [101.0, 200.0], [True, False], [4, 6], [100.0, 200.0], [], [0], True),
        # the CPU's T* with another J is not the CPU's pick
        ([3, 6], [101.5, 200.0], [False, False], [3, 6], [101.0, 200.0], [0], [], False),
    ],
)
def test_check_picks(T, J, moved, cpu_T, cpu_J, failed, rounding_only, ok):
    cpu = {"T": np.asarray(cpu_T), "J": np.asarray(cpu_J)}
    sc = chip_smoke.check_picks(np.asarray(T), np.asarray(J), np.asarray(moved), _ORACLE, cpu, 0.1)
    assert (sc["failed"], sc["rounding_only"], sc["picks_ok"]) == (failed, rounding_only, ok)


def test_check_picks_bounds_rounding_only_passes():
    """More than MAX_ROUNDING_ONLY problems passing only as rounding-sensitive
    fail the case: a path that scatters problems across basins is broken."""
    k = chip_smoke.MAX_ROUNDING_ONLY + 1
    curve = np.tile(_CURVE[:1], (k, 1))
    oracle = {"T": np.full(k, 4), "J": np.full(k, 100.0), "J_curve": curve}
    cpu = {"T": np.full(k, 4), "J": np.full(k, 100.0)}
    sc = chip_smoke.check_picks(np.full(k, 2), np.full(k, 105.0), np.ones(k, bool), oracle, cpu, 0.1)
    assert sc["failed"] == [] and len(sc["rounding_only"]) == k and not sc["picks_ok"]


@pytest.mark.parametrize("case", ["Segway_Balance", "PointMass_Navigation"])
def test_cpu_passes_the_smoke_gate(case):
    """The CPU runs the smoke's own batch path and gate on the two cases where
    the propagator and the brute force differ: every problem reproduces the
    committed CPU pick unless its T* moves under a one-ulp change of x0."""
    oracle = np.load(os.path.join(RESULTS, f"oracle_f64{suffix(case)}.npz"))
    cpu = np.load(os.path.join(RESULTS, f"cpu_f64_picks{suffix(case)}.npz"))
    system, mk = get_system(case)
    base = mk(dtype=jnp.float64)
    x0s = oracle["X"][:, 0]
    batch = broadcast_problem(base, x0s.shape[0])
    opts = SolveOptions(method="propagator", max_iter=chip_smoke.MAX_ITER, psd_levels=1)

    def picks(x):
        res = solve_batch_sharded(system, batch.replace(x0=jnp.asarray(x)), options=opts, mesh=make_mesh(1))
        return np.asarray(res.T_star), np.asarray(res.J_star)

    T, J = picks(x0s)
    moved = np.zeros(T.shape, bool)
    for direction in (np.inf, -np.inf):
        moved |= picks(np.nextafter(x0s, direction))[0] != T
    sc = chip_smoke.check_picks(T, J, moved, oracle, cpu, float(base.w))
    assert sc["picks_ok"], sc["failed"]
    assert np.all(sc["by_cpu"] | moved)


@pytest.mark.parametrize(
    "case, disagree",
    [
        ("Quadrotor", []),
        ("Cartpole_SwingUp", []),
        ("DoubleIntegrator", []),
        ("Ballbot_Balance", []),
        ("Segway_Balance", [9, 11, 15, 88]),
        ("PointMass_Navigation", [39, 42, 57, 66, 81, 96, 112]),
    ],
)
def test_committed_cpu_picks_against_oracle(case, disagree):
    """The committed CPU f64 propagator picks are the oracle's own on the four
    single-basin cases, and differ from it on these problems of the other two
    (the problems where chip_smoke falls back on the CPU pick)."""
    oracle = np.load(os.path.join(RESULTS, f"oracle_f64{suffix(case)}.npz"))
    cpu = np.load(os.path.join(RESULTS, f"cpu_f64_picks{suffix(case)}.npz"))
    _, mk = get_system(case)
    sc = oracle_agreement(
        cpu["T"], cpu["J"], oracle["T"], oracle["J"], oracle["J_curve"], float(mk(dtype=jnp.float64).w)
    )
    assert np.nonzero(~sc["agree"])[0].tolist() == disagree
