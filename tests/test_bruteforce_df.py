"""df32 lanes brute-force oracle (solver/bruteforce_df.py): a batched f32
brute-force J(T) curve must reproduce the f64 curve (and its argmin) far
beyond plain-f32 accuracy. Runs in plain XLA on CPU; compiled-CPU df32 is
degraded by LLVM FP contraction (see ops/df32.py), so tolerances are loose."""

import jax
import jax.numpy as jnp
import numpy as np

from tests.helpers import tiny_double_integrator
from timeopt.solver.bruteforce_df import bruteforce_lanes_df
from timeopt.solver.backward import stage_expansion
from timeopt.solver.cost import rollout
from timeopt.solver.horizon import bruteforce_J_curve
from timeopt.solver.ilqr import default_U_init
from timeopt.solver.linearize import linearize
from timeopt.ops.linalg import sym
from timeopt.ops.wrap import wrap_error


def _bf_inputs(system, prob0, dtype, du):
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t
    )
    prob = cast(prob0)
    U = default_U_init(prob) + jnp.asarray(du, dtype)
    X = rollout(system, prob, prob.x0, U)
    A, B = linearize(system.step, X, U, "ad")
    Tm = prob.T_max
    return prob, X[: Tm + 1], U[:Tm], A[:Tm], B[:Tm]


def test_bruteforce_lanes_df_matches_f64(rng):
    system, prob0 = tiny_double_integrator(N=24, T_min=2, T_max=20)
    dus = [0.05 * float(v) for v in rng.standard_normal(3)]

    refs = []
    f32_in = []
    for du in dus:
        prob, X, U, A, B = _bf_inputs(system, prob0, jnp.float64, du)
        refs.append(np.asarray(bruteforce_J_curve(system, prob, A, B, X, U)))

        prob32, X32, U32, A32, B32 = _bf_inputs(system, prob0, jnp.float32, du)
        e, duv, lx, lu, l0, Qs = stage_expansion(system, prob32, X32, U32)
        eTs = wrap_error(X32[1:] - prob32.xg, prob32.wrap_mask)
        f32_in.append((A32, B32, lx, lu, l0, Qs, eTs, sym(prob32.Qf), prob32.R))

    st = lambda i: jnp.stack([x[i] for x in f32_in], 0)  # noqa: E731
    J32 = np.asarray(
        jax.jit(bruteforce_lanes_df)(*[st(i) for i in range(9)])
    )

    for b, Jref in enumerate(refs):
        scale = np.maximum(np.abs(Jref), 1.0)
        err = np.max(np.abs(J32[b].astype(np.float64) - Jref) / scale)
        # df32 keeps ~1e-6 of f64 (inputs f32-rounded; compiled-CPU df
        # degradation); plain-f32 recursions err at O(1) on long horizons
        assert err < 5e-5, (b, err)
        assert int(np.argmin(J32[b])) == int(np.argmin(Jref)), b
