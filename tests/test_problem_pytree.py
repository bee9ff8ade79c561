"""Problem and SolveResult are frozen dataclasses registered as pytrees:
array fields are leaves, N/T_min/T_max are static metadata."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.helpers import tiny_double_integrator
from timeopt.solver.ilqr import SolveOptions, SolveResult, solve


def test_pytree_round_trip():
    _, prob = tiny_double_integrator()
    leaves, treedef = jax.tree.flatten(prob)
    assert len(leaves) == 8  # x0, xg, u_ref, Q, R, Qf, w, wrap_mask
    back = jax.tree.unflatten(treedef, leaves)
    assert (back.N, back.T_min, back.T_max) == (prob.N, prob.T_min, prob.T_max)
    for a, b in zip(jax.tree.leaves(back), leaves):
        assert a is b

    fields = {f.name: jnp.zeros((2,)) for f in dataclasses.fields(SolveResult)}
    res = SolveResult(**fields)
    res_leaves, res_def = jax.tree.flatten(res)
    assert len(res_leaves) == len(fields)
    assert isinstance(jax.tree.unflatten(res_def, res_leaves), SolveResult)


def test_replace_returns_new_frozen_copy():
    _, prob = tiny_double_integrator()
    x0 = jnp.asarray([3.0, -1.0])
    p2 = prob.replace(x0=x0)
    np.testing.assert_array_equal(np.asarray(p2.x0), np.asarray(x0))
    np.testing.assert_array_equal(np.asarray(prob.x0), [1.0, 0.0])
    assert p2.xg is prob.xg and p2.N == prob.N
    with pytest.raises(dataclasses.FrozenInstanceError):
        prob.x0 = x0

    system, _ = tiny_double_integrator()
    res = solve(system, prob, options=SolveOptions(max_iter=2))
    res2 = res.replace(T_star=jnp.asarray(7, jnp.int32))
    assert int(res2.T_star) == 7 and res2.J_star is res.J_star


def test_new_x0_does_not_retrace():
    _, prob = tiny_double_integrator()
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.N)
        return jnp.sum(p.x0) * p.T_max

    f(prob)
    f(prob.replace(x0=jnp.asarray([5.0, 2.0])))
    assert traces == [prob.N]
    # a static field is part of the program: changing it retraces
    f(prob.replace(T_max=prob.T_max - 1))
    assert len(traces) == 2
