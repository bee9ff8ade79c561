"""Cross-device statistics via collectives (component N4 of SURVEY.md §2.2).

The reference aggregates per-trial rows host-side with pandas
(reference run_suite.py:196-292); at 10k+ solves/s the raw per-solve
results should be reduced on-device: histograms and success counters are
`psum`s over the batch axis, with only O(T_max) scalars returning to host.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def t_star_histogram(T_stars: jax.Array, T_max: int, mesh: Optional[Mesh] = None, axis: str = "dp"):
    """Histogram of selected horizons over a (possibly sharded) batch.

    With a mesh, each device bins its local shard and a psum produces the
    global histogram on every device."""
    if mesh is None:
        return jnp.bincount(T_stars.astype(jnp.int32), length=T_max + 1)

    @partial(shard_map, mesh=mesh, in_specs=P(axis), out_specs=P())
    def hist(local):
        h = jnp.bincount(local.astype(jnp.int32), length=T_max + 1)
        return jax.lax.psum(h, axis)

    return hist(T_stars)


def batch_summary(
    J_stars: jax.Array,
    final_errs: jax.Array,
    success_tol: float = 0.5,
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
):
    """On-device success-rate / count reduction (success criterion of the
    reference runner: finite J* and final error <= tol,
    reference run_suite.py:169-175)."""
    success = jnp.isfinite(J_stars) & jnp.isfinite(final_errs) & (final_errs <= success_tol)

    if mesh is None:
        return {
            "n": jnp.asarray(J_stars.shape[0]),
            "n_success": jnp.sum(success),
            "success_rate": jnp.mean(success),
        }

    @partial(shard_map, mesh=mesh, in_specs=P(axis), out_specs=P())
    def reduce(s):
        n_local = jnp.asarray(s.shape[0], jnp.int32)
        n = jax.lax.psum(n_local, axis)
        k = jax.lax.psum(jnp.sum(s.astype(jnp.int32)), axis)
        return jnp.stack([n, k])

    nk = reduce(success)
    return {
        "n": nk[0],
        "n_success": nk[1],
        "success_rate": nk[1] / jnp.maximum(nk[0], 1),
    }
