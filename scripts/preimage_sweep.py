"""Sensitivity sweep of the one-pass fixed-point preimage budget:
run baseline2 over the full 25-trial suite trial
matrix (CPU f64, the reference's config) with preimage n_iter = 4 (this
repo's outcome-parity default) vs 6 (the reference's literal constant,
reference linearization.py:41-71), and report per-trial T*/J/success
deltas so the constant is defended across the whole matrix rather than by
the single cartpole knife-edge trial.

Usage: python scripts/preimage_sweep.py   (CPU; ~minutes)
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # self-locating: run bare, no PYTHONPATH needed

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from timeopt.runner.run_suite import CASES, EXTRA_CASES, build_trial_problems  # noqa: E402
from timeopt.solver.ilqr import SolveOptions, solve_batch  # noqa: E402
from timeopt.ops.wrap import wrap_error  # noqa: E402

TRIALS = int(_os.environ.get("TRIALS", "25"))
TOL = 0.5


def run_case(case):
    system, base, probs = build_trial_problems(case, TRIALS, 0, jnp.float64)
    out = {}
    for n_it in (4, 6):
        opts = SolveOptions(method="onepass", max_iter=12, preimage_iters=n_it)
        res = solve_batch(system, probs, options=opts)
        T = np.asarray(res.T_star)
        J = np.asarray(res.J_star)
        errs = np.asarray(
            jax.vmap(
                lambda X, t, xg, wm: jnp.sqrt(
                    jnp.sum(jnp.square(wrap_error(X[t] - xg, wm)))
                )
            )(res.X, res.T_star, probs.xg, probs.wrap_mask)
        )
        succ = np.isfinite(J) & np.isfinite(errs) & (errs <= TOL)
        out[n_it] = (T, J, errs, succ)
    return out


def main():
    print(f"{'case':22s} {'succ@4':>7s} {'succ@6':>7s} {'T==':>5s} {'|dJ| med':>9s} "
          f"{'|dJ| max':>9s}  flips (trial: T4/J4/s4 -> T6/J6/s6)")
    for case in CASES + EXTRA_CASES:
        out = run_case(case)
        T4, J4, e4, s4 = out[4]
        T6, J6, e6, s6 = out[6]
        dJ = np.abs(J4 - J6)
        fin = np.isfinite(dJ)
        flips = [
            f"{i}: {T4[i]}/{J4[i]:.6g}/{int(s4[i])} -> {T6[i]}/{J6[i]:.6g}/{int(s6[i])}"
            for i in range(TRIALS)
            if (T4[i] != T6[i]) or (s4[i] != s6[i])
        ]
        print(
            f"{case:22s} {s4.mean():7.2f} {s6.mean():7.2f} "
            f"{int((T4 == T6).sum()):3d}/{TRIALS} "
            f"{np.median(dJ[fin]) if fin.any() else float('nan'):9.2e} "
            f"{dJ[fin].max() if fin.any() else float('nan'):9.2e}  "
            + ("; ".join(flips) if flips else "-"),
            flush=True,
        )


if __name__ == "__main__":
    main()
