"""Multi-chip execution: device meshes, sharded batch solving, and a
collective-based horizon-selection path.

The reference has no distributed or parallel execution of any kind
(SURVEY.md §2: serial trial loop at reference run_suite.py:113-191);
this module is the scale-out layer (component N4):

- **dp (data parallel / batch axis)**: independent solves shard over the
  mesh's "dp" axis with zero communication — jit + NamedSharding partitions
  the vmapped solver automatically.
- **hs (horizon-candidate axis)**: the N terminal queries of the propagator
  sweep shard over "hs" via `shard_map`; each device evaluates its slice of
  candidate horizons and an `all_gather` reassembles the J(T) curve (the
  tensor-parallel analogue for this workload).
- statistics (T* histograms, success counters) reduce with `psum` in
  timeopt.parallel.stats.

The mesh follows the algorithm alone: on a host whose cards are joined all
to all (NVLink), every device pair is equally close, so a 1D ("dp",) or
("hs",) mesh in device order is as good as any. On a CPU host these paths
are exercised with XLA_FLAGS=--xla_force_host_platform_device_count=K
(SURVEY.md §4).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from timeopt.models.base import Problem, System
from timeopt.solver.horizon import LFTElements, lft_elements, lft_prefix_scan
from timeopt.solver.ilqr import SolveOptions, _solve_traced


def make_mesh(n_devices: Optional[int] = None, axis_names=("dp",), shape=None) -> Mesh:
    """Build a device mesh. 1D ("dp",) by default; pass shape=(a, b) and
    axis_names=("dp", "hs") for a 2D mesh."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis mesh")
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names)


def shard_problems(probs: Problem, mesh: Mesh, axis: str = "dp") -> Problem:
    """Place a batched Problem pytree with its leading (batch) axis sharded
    over `axis` of the mesh."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree.map(put, probs)


def solve_batch_sharded(
    system: System,
    probs: Problem,
    U_inits=None,
    options: Optional[SolveOptions] = None,
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
):
    """Batch-solve with the batch axis sharded over the mesh. Solves are
    independent, so XLA partitions the program with zero inter-chip
    communication; collectives only appear in the statistics layer."""
    opts = options or SolveOptions()
    if mesh is not None:
        probs = shard_problems(probs, mesh, axis)
    if U_inits is None:
        m = probs.u_ref.shape[-1]
        U_inits = jnp.broadcast_to(
            probs.u_ref[..., None, :], probs.u_ref.shape[:-1] + (probs.N, m)
        )
        if mesh is not None:
            U_inits = jax.device_put(U_inits, NamedSharding(mesh, P(axis)))

    # reuse the module-level jitted batch entry (a fresh lambda here would
    # miss the jit cache on every call); jit propagates the input shardings
    from timeopt.solver.ilqr import _solve_batch_jit

    return _solve_batch_jit(system, opts, probs, U_inits)


def propagator_select_sharded(
    blocks,
    C: jax.Array,
    mesh: Mesh,
    *,
    hs_axis: str = "hs",
    scan_mode: str = "sequential",
    psd_levels: int = 2,
) -> jax.Array:
    """Propagator J(T) curve with the terminal-query (candidate-horizon) axis
    sharded over the mesh's `hs_axis`. `C` is the factored terminal data from
    build_terminal_factors.

    The prefix scan is replicated (it is the sequential backbone); each
    device queries its shard of candidate horizons against the prefixes and
    an all_gather reassembles the full curve. Demonstrates the
    N3/N4 horizon-candidate parallelism of SURVEY.md §2.2; communication is
    O(T_max) floats.
    """
    from timeopt.solver.horizon import propagator_J_curve_factored

    elems = lft_elements(blocks, psd_levels=psd_levels)
    prefixes = lft_prefix_scan(elems, mode=scan_mode, psd_levels=psd_levels)

    n_hs = mesh.shape[hs_axis]
    N = C.shape[0]
    pad = (-N) % n_hs

    def pad0(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)) if pad else x

    C_p = pad0(C)
    if pad:
        # keep padded factors well-conditioned (identity rows)
        eye = jnp.broadcast_to(
            jnp.eye(C.shape[-2], C.shape[-1], dtype=C.dtype), (pad,) + C.shape[1:]
        )
        C_p = C_p.at[N:].set(eye)
    pref_p = jax.tree.map(pad0, prefixes)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(hs_axis), P(hs_axis)),
        out_specs=P(),
        # the all_gather makes the output replicated; the static VMA checker
        # cannot infer that, so disable it
        check_vma=False,
    )
    def query(c_shard, pref_shard):
        J_local = propagator_J_curve_factored(
            LFTElements(*pref_shard), c_shard, psd_levels=psd_levels
        )
        return jax.lax.all_gather(J_local, hs_axis, axis=0, tiled=True)

    J = query(C_p, LFTElements(*pref_p))
    return J[:N]
