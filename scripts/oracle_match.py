"""T*-match measurement: HOP-DDP (propagator) solves vs the f64 brute-force
oracle (the reference's own ground truth — BASELINE.md "bit-matched T*
selection vs the reference brute-force baseline").

    python scripts/oracle_match.py oracle     # CPU f64 brute force -> results/oracle_f64*.npz
    python scripts/oracle_match.py candidate  # f64 propagator on the default device
    python scripts/oracle_match.py picks      # CPU f64 propagator, every case -> results/cpu_f64_picks*.npz
    python scripts/oracle_match.py report     # score candidate vs oracle
    python scripts/oracle_match.py verify     # re-check each mismatch on the candidate's trajectory
    python scripts/oracle_match.py summary    # report over every case with a candidate file

Problem set (default): B=128 quadrotor problems, x0 positions perturbed by
sigma=0.4 (the reference trial distribution, reference run_suite.py:72),
max_iter=12 as in the reference suite. OM_CASE selects any registered case;
non-quadrotor cases perturb x0 with the system's per-case sigma_x0 (the
suite's trial distribution) and write case-suffixed npz files. OM_BATCH and
OM_SEED set the batch size and the seed.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # self-locating: run bare, no PYTHONPATH needed

import os
import sys

import numpy as np

from timeopt.runner.oracle_set import make_x0s, suffix

B = int(os.environ.get("OM_BATCH", "128"))
SEED = int(os.environ.get("OM_SEED", "0"))
CASE = os.environ.get("OM_CASE", "Quadrotor")
OUT = os.path.join(os.path.dirname(__file__), "..", "results")
CASES = [
    "DoubleIntegrator",
    "Cartpole_SwingUp",
    "Ballbot_Balance",
    "Segway_Balance",
    "Quadrotor",
    "PointMass_Navigation",
]


def run(mode, case=CASE):
    import jax

    if mode in ("oracle", "picks"):
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from timeopt.models import get_system
    from timeopt.solver.ilqr import SolveOptions, broadcast_problem, solve_batch

    method = "bruteforce" if mode == "oracle" else "propagator"
    prefix = {"oracle": "oracle_f64", "picks": "cpu_f64_picks", "candidate": "oracle_candidate"}[mode]
    fname = f"{prefix}{suffix(case)}.npz"
    system, mk = get_system(case)
    base = mk(dtype=jnp.float64)
    x0s = make_x0s(case, np.asarray(base.x0, np.float64), system.sigma_x0, B, SEED)
    probs = broadcast_problem(base, B).replace(x0=jnp.asarray(x0s))
    opts = SolveOptions(method=method, max_iter=12, psd_levels=1)
    res = solve_batch(system, probs, options=opts)
    T = np.asarray(res.T_star)
    J = np.asarray(res.J_star)
    os.makedirs(OUT, exist_ok=True)
    if mode == "picks":
        # the CPU f64 propagator's own per-problem picks, the reference
        # chip_smoke.py holds a device's picks to where the brute force differs
        np.savez(os.path.join(OUT, fname), T=T, J=J)
    else:
        # J_curve: the final selection curve per problem (tie analysis on the
        # oracle's own landscape); X/U: final trajectories, so `verify` can
        # re-evaluate the f64 brute-force curve ON the candidate's own final
        # trajectory — distinguishing genuine selection errors from
        # iterate-path basin divergence.
        np.savez(
            os.path.join(OUT, fname),
            T=T, J=J, J_curve=np.asarray(res.J_curve),
            X=np.asarray(res.X), U=np.asarray(res.U),
        )
    dev = jax.devices()[0]
    print(
        f"{mode} {case} on {dev.platform} {dev.device_kind}: wrote {fname}  "
        f"T* median {np.median(T)}  J median {np.median(J):.4f}"
    )


def _score(case):
    import jax

    jax.config.update("jax_platforms", "cpu")  # analysis only
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from timeopt.models import get_system
    from timeopt.solver.verify import oracle_agreement

    a = np.load(os.path.join(OUT, f"oracle_f64{suffix(case)}.npz"))
    b = np.load(os.path.join(OUT, f"oracle_candidate{suffix(case)}.npz"))
    _, mk = get_system(case)
    w = float(mk(dtype=jnp.float64).w)
    return a, b, oracle_agreement(b["T"], b["J"], a["T"], a["J"], a["J_curve"], w)


def report():
    a, b, sc = _score(CASE)
    n = sc["n"]
    print(
        f"{CASE}  B={n}  T* exact {sc['n_exact']}/{n}  exact-or-tied "
        f"{sc['n_exact_or_tied']}/{n}  (landscape rule |J_or(T)-J_or(T_or)| <= w*(|dT|+1))"
    )
    print(
        f"J rel gap: max over exact {sc['max_j_rel_exact']:.2e}, "
        f"max over tied {sc['max_j_rel_tied']:.2e}"
    )
    mism = np.nonzero(~sc["exact"])[0]
    if len(mism):
        print(f"mismatches ({len(mism)}): idx {mism[:10]}  dT {(b['T'] - a['T'])[mism][:10]}")
        hard = mism[~sc["tied"][mism]]
        if len(hard):
            print(f"  GENUINE selection errors: idx {hard}  dT {(b['T'] - a['T'])[hard]}")


def verify_mismatches():
    """For every T* mismatch: evaluate the f64 brute-force J(T) curve ON THE
    candidate's OWN final trajectory. If the candidate's pick is the argmin
    of that landscape, the candidate solved ITS problem exactly and the
    mismatch is iterate-path basin divergence, not a selection error."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from timeopt.models import get_system
    from timeopt.solver.cost import argmin_T
    from timeopt.solver.horizon import bruteforce_J_curve
    from timeopt.solver.linearize import linearize

    a = np.load(os.path.join(OUT, f"oracle_f64{suffix(CASE)}.npz"))
    b = np.load(os.path.join(OUT, f"oracle_candidate{suffix(CASE)}.npz"))
    T64, Tc = a["T"], b["T"]
    mism = np.nonzero(Tc != T64)[0]
    if not len(mism):
        print(f"{CASE}: no mismatches")
        return

    system, mk = get_system(CASE)
    base = mk(dtype=jnp.float64)
    x0s = make_x0s(CASE, np.asarray(base.x0, np.float64), system.sigma_x0, B, SEED)
    Tm = int(base.T_max)
    own_opt = 0
    for i in mism:
        prob = base.replace(x0=jnp.asarray(x0s[i]))
        X = jnp.asarray(b["X"][i], jnp.float64)[: Tm + 1]
        U = jnp.asarray(b["U"][i], jnp.float64)[:Tm]
        A, B_ = linearize(system.step, X, U, "ad")
        curve = bruteforce_J_curve(system, prob, A, B_, X, U, psd_levels=1)
        T_own = int(argmin_T(curve, prob.T_min, prob.T_max))
        ok = T_own == int(Tc[i])
        own_opt += ok
        print(
            f"  idx {i}: T={int(Tc[i])} T_oracle={int(T64[i])}  f64-argmin on the "
            f"candidate's own trajectory: {T_own}  {'OWN-OPTIMAL' if ok else 'SELECTION ERROR'}"
        )
    print(
        f"{CASE}: {own_opt}/{len(mism)} mismatches are own-trajectory-optimal "
        f"(basin divergence, not selection error)"
    )


def summary():
    """Per-case and aggregate exact / exact-or-tied counts over every case
    that has both an oracle and a candidate file."""
    tot_e = tot_t = tot_n = 0
    print(f"{'case':22s} {'exact':>11s} {'exact-or-tied':>14s}")
    for case in CASES:
        if not os.path.exists(os.path.join(OUT, f"oracle_candidate{suffix(case)}.npz")):
            continue
        _, _, sc = _score(case)
        n = sc["n"]
        tot_e += sc["n_exact"]
        tot_t += sc["n_exact_or_tied"]
        tot_n += n
        print(f"{case:22s} {sc['n_exact']:4d}/{n:<6d} {sc['n_exact_or_tied']:4d}/{n}")
    if tot_n:
        print(f"{'AGGREGATE':22s} {tot_e:4d}/{tot_n:<6d} {tot_t:4d}/{tot_n}")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "report"
    if mode in ("oracle", "candidate"):
        run(mode)
    elif mode == "picks":
        for case in CASES:
            run(mode, case)
    elif mode == "verify":
        verify_mismatches()
    elif mode == "summary":
        summary()
    elif mode == "report":
        report()
    else:
        raise SystemExit(f"unknown mode {mode!r}")
