"""Angle wrapping as vectorized masked ops.

Reference counterpart: reference utils.py:127-137 — there, a Python loop
over `wrap_idx` mutates selected entries. Here the wrap set is a static 0/1
mask over the state vector so the op is a single branchless `where`, vmappable
over both the state axis and arbitrary batch axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def angle_normalize(a: jax.Array) -> jax.Array:
    """Map angles to (-pi, pi]."""
    pi = jnp.asarray(np.pi, dtype=jnp.result_type(a, jnp.float32))
    return (a + pi) % (2.0 * pi) - pi


def wrap_error(e: jax.Array, wrap_mask: jax.Array | None) -> jax.Array:
    """Wrap the angular components of an error vector.

    e: (..., n); wrap_mask: (n,) boolean/0-1 mask of angular indices (or None).
    """
    if wrap_mask is None:
        return e
    mask = jnp.asarray(wrap_mask, dtype=bool)
    return jnp.where(mask, angle_normalize(e), e)


def wrap_mask_from_idx(wrap_idx, n: int) -> np.ndarray:
    """Host-side: list of angular state indices -> (n,) boolean mask."""
    mask = np.zeros(n, dtype=bool)
    for i in wrap_idx or ():
        mask[int(i)] = True
    return mask
