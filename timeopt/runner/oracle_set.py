"""The oracle problem set: the perturbed initial states that the committed
f64 references (`results/oracle_f64*.npz`, `results/cpu_f64_picks*.npz`)
were solved on, and their file names. `scripts/oracle_match.py` writes those
files; `chip_smoke.py` and `scripts/phase_times.py` draw the same problems."""

from __future__ import annotations

import numpy as np


def suffix(case: str) -> str:
    """File-name suffix of a case's reference files (none for the quadrotor)."""
    return "" if case == "Quadrotor" else f"_{case}"


def make_x0s(case, base_x0, sigma_x0, batch=128, seed=0):
    """(batch, n) perturbed initial states. The draws are row-major, so the
    first k rows of a larger batch equal a batch-k draw with the same seed."""
    rng = np.random.default_rng(seed)
    x0s = np.tile(np.asarray(base_x0, np.float64), (batch, 1))
    if case == "Quadrotor":
        # original protocol (kept for continuity of the committed artifacts)
        x0s[:, :3] += 0.4 * rng.standard_normal((batch, 3))
    else:
        x0s += np.asarray(sigma_x0, np.float64) * rng.standard_normal(x0s.shape)
    return x0s
