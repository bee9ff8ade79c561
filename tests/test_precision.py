"""Guard for CLAUDE.md invariant 2: every dot_general traced on the f32
solve path must carry HIGHEST (full-f32) precision.

At DEFAULT precision XLA may lower f32 dots to reduced-precision matrix
units (TF32 on an NVIDIA GPU, ~1e-3 rel), the noise class of the iterate-0
selection anomaly (docs/DESIGN.md §3.4). CPU tests cannot observe those
numerics; instead this test inspects the traced jaxprs of the solve path
and of every phase entry point and asserts no DEFAULT-precision dot
survives (i.e. ops/precision.full_matmul_precision stays applied —
including to AD-generated dots inside linearize).
"""

import jax
import jax.extend.core  # noqa: F401  (jaxpr types used below)
import jax.numpy as jnp
import numpy as np
from jax import lax

from timeopt.models import get_system
from timeopt.solver.backward import backward_truncated
from timeopt.solver.cost import cost_true
from timeopt.solver.forward import forward_linesearch
from timeopt.solver.ilqr import SolveOptions, _solve_traced, default_U_init


def _collect_dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            if isinstance(v, jax.extend.core.ClosedJaxpr):
                _collect_dot_precisions(v.jaxpr, out)
            elif isinstance(v, jax.extend.core.Jaxpr):
                _collect_dot_precisions(v, out)
            elif isinstance(v, (tuple, list)):
                for vv in v:
                    if isinstance(vv, jax.extend.core.ClosedJaxpr):
                        _collect_dot_precisions(vv.jaxpr, out)
                    elif isinstance(vv, jax.extend.core.Jaxpr):
                        _collect_dot_precisions(vv, out)
    return out


def _assert_all_highest(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    precs = _collect_dot_precisions(jaxpr.jaxpr, [])
    assert precs, "expected at least one dot_general in the traced program"
    bad = [p for p in precs if p != (lax.Precision.HIGHEST, lax.Precision.HIGHEST)]
    assert not bad, (
        f"{len(bad)}/{len(precs)} dots traced at non-HIGHEST precision "
        f"(reduced-precision matmul units — invariant 2): {set(map(str, bad))}"
    )


def test_solve_path_dots_are_full_precision():
    system, mk = get_system("Quadrotor")
    prob = mk(dtype=jnp.float32)
    opts = SolveOptions(method="propagator", max_iter=2, psd_levels=1)
    _assert_all_highest(
        lambda p: _solve_traced(system, opts, p, default_U_init(p)), prob
    )


def test_phase_entries_dots_are_full_precision(rng):
    system, mk = get_system("Quadrotor")
    prob = mk(dtype=jnp.float32)
    N, n, m = prob.N, prob.n, prob.m
    X = jnp.asarray(rng.standard_normal((N + 1, n)), jnp.float32)
    U = jnp.asarray(rng.standard_normal((N, m)), jnp.float32)
    A = jnp.asarray(rng.standard_normal((N, n, n)), jnp.float32)
    Bm = jnp.asarray(rng.standard_normal((N, n, m)), jnp.float32)
    K = jnp.asarray(rng.standard_normal((N, m, n)), jnp.float32)
    kap = jnp.asarray(rng.standard_normal((N, m)), jnp.float32)
    T = jnp.asarray(51, jnp.int32)
    lm = jnp.asarray(1e-3, jnp.float32)

    _assert_all_highest(lambda X, U: cost_true(system, prob, X, U, T), X, U)
    _assert_all_highest(
        lambda A, Bm, X, U: backward_truncated(system, prob, A, Bm, X, U, T, lm),
        A, Bm, X, U,
    )
    _assert_all_highest(
        lambda X, U, K, kap: forward_linesearch(
            system, prob, X, U, K, kap, T, df_forward=True
        ),
        X, U, K, kap,
    )
