"""One-pass LM-ladder parity vs the reference's per-step escalation
(reference horizon_selection.py:179-200: try chol(Quu + lam I), lam x10
on failure, up to 12 tries => ceiling lam*1e11).

The jittable re-design uses a static 4-rung ladder {lam, lam*1e4, lam*1e8,
lam*1e12} picked by SPD-ness (solver/onepass.py). Properties verified on
near-singular / indefinite Quu spanning 24 decades of negative curvature:

1. REACH: every Quu the reference escalation can regularize, the ladder can
   too (ladder ceiling 1e12 >= reference ceiling 1e11).
2. GRANULARITY BOUND: the ladder's chosen lambda is never below the
   reference's chosen lambda and never more than x1e4 above it.
3. EXACT MATCH on the common path: when the first rung is SPD (the typical
   well-conditioned step), both pick exactly lam0.
"""

import numpy as np
import jax.numpy as jnp

from timeopt.ops.linalg import spd_check


def _reference_escalation(Quu, lam0, tries=12):
    """The reference's x10 escalation: first lam in {lam0*10^k, k=0..11}
    with chol(Quu + lam I) succeeding, else None."""
    lam = lam0
    for _ in range(tries):
        try:
            np.linalg.cholesky(Quu + lam * np.eye(Quu.shape[0]))
            return lam
        except np.linalg.LinAlgError:
            lam *= 10.0
    return None


def _ladder_pick(Quu, lam0):
    """The repo's static ladder (same logic as onepass._sweep_impl): first
    SPD rung of {lam0, lam0*1e4, lam0*1e8, lam0*1e12}, else None."""
    for mult in (1.0, 1e4, 1e8, 1e12):
        lam = lam0 * mult
        if bool(spd_check(jnp.asarray(Quu + lam * np.eye(Quu.shape[0])))):
            return lam
    return None


def test_ladder_reach_and_granularity(rng):
    lam0 = 1e-3
    m = 3
    Q = np.linalg.qr(rng.standard_normal((m, m)))[0]
    # negative curvature spanning below lam0 up to beyond both ceilings
    for exp in range(-15, 10):
        c = 10.0**exp
        Quu = Q @ np.diag([1.0, 0.5, -c]) @ Q.T
        Quu = 0.5 * (Quu + Quu.T)
        ref = _reference_escalation(Quu, lam0)
        lad = _ladder_pick(Quu, lam0)
        if ref is not None:
            # reach: ladder covers everything the reference covers
            assert lad is not None, (exp, ref)
            # granularity: within x1e4 above the reference's choice
            assert ref * (1 - 1e-9) <= lad <= ref * 1e4 * (1 + 1e-9), (exp, ref, lad)
        if c < lam0 / 2:
            # common path: first rung SPD for both -> exact agreement
            assert lad == lam0 and ref == lam0, (exp, ref, lad)


def test_ladder_exceeds_reference_ceiling(rng):
    """Quu needing lam in (1e11*lam0, 1e12*lam0]: the reference's 12 tries
    fail (it would raise -> runner 'crash' row / in-solver fallback), while
    the 4th rung still regularizes — strictly wider failure coverage."""
    lam0 = 1e-3
    Quu = np.diag([1.0, -5e8])  # needs lam > 5e8 = 5e11 * lam0
    assert _reference_escalation(Quu, lam0) is None
    assert _ladder_pick(Quu, lam0) == lam0 * 1e12
