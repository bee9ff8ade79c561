"""Multi-process execution: the cross-process half of component N4.

The reference has no distributed execution at all (SURVEY.md §2/§5); the
single-host mesh layer lives in timeopt/parallel/mesh.py. This module
adds the multi-process runtime on top (SURVEY.md §5 "Distributed
communication backend"; BASELINE.md:33 asks for scaling measured at 1 chip,
1 host, and >= 2 hosts):

- `initialize()` wraps `jax.distributed.initialize` (idempotent; no-op for
  single-process runs), after which `jax.devices()` is the GLOBAL device
  list spanning all hosts.
- `global_mesh()` builds a mesh over those global devices. Solves are
  independent, so the batch axis shards with zero inter-device
  communication, and only the O(T_max) statistics reductions
  (parallel/stats.py) cross between processes.
- `distribute_batch()` turns per-process local problem shards into one
  globally-sharded Problem (each host feeds only its local slice;
  `jax.make_array_from_process_local_data` assembles the global view).
- `gather_results()` all-gathers result pytrees to host NumPy on every
  process (host-0 writes artifacts; see runner/run_suite.py).

Exercised without real multi-host hardware by a 2-process CPU-backend
integration test (tests/test_multihost.py) launching real subprocesses
against a local coordinator — the same code path a multi-process GPU
launch takes. On one host with several cards, give each process its own
card with `local_device_ids` (e.g. `initialize("localhost:<port>", 4, i,
local_device_ids=[i])` in process i).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from timeopt.models.base import Problem, System
from timeopt.solver.ilqr import SolveOptions

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Initialize the multi-process JAX runtime (idempotent).

    With no arguments this relies on the cluster environment (SLURM /
    Open MPI auto-detection); explicit arguments support manual launches
    and the CPU-simulated tests. `local_device_ids` restricts this process
    to the listed local devices — one card per process on a multi-card
    host. Single-process callers can skip this entirely — every other
    function in this module works unmodified in a single-process run.
    """
    global _initialized
    if _initialized or jax.distributed.is_initialized():
        _initialized = True
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(axis: str = "dp") -> Mesh:
    """1D mesh over ALL global devices (hosts x local devices). Device order
    groups each process's local devices together, so a batch axis sharded
    over `axis` keeps every problem's solve on the host that fed it."""
    return Mesh(np.array(jax.devices()), (axis,))


def process_batch_bounds(global_batch: int) -> tuple:
    """[start, end) of this process's contiguous slice of a global batch
    split as evenly as possible across processes (first `rem` processes get
    one extra element)."""
    pc, pi = jax.process_count(), jax.process_index()
    base, rem = divmod(global_batch, pc)
    start = pi * base + min(pi, rem)
    return start, start + base + (1 if pi < rem else 0)


def distribute_batch(local_tree, mesh: Mesh, axis: str = "dp"):
    """Assemble per-process local pytrees (leading axis = this process's
    slice of the global batch) into one globally-sharded pytree.

    In a single-process run this is just a device_put with a NamedSharding.
    Multi-process, each host contributes only its local shard — no host ever
    materializes the full batch.
    """
    sharding = NamedSharding(mesh, P(axis))
    if not is_multiprocess():
        return jax.tree.map(lambda x: jax.device_put(x, sharding), local_tree)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sharding, np.asarray(x)),
        local_tree,
    )


def solve_batch_global(
    system: System,
    local_probs: Problem,
    U_inits=None,
    options: Optional[SolveOptions] = None,
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
):
    """Solve a globally-sharded batch from per-process local problem shards.

    `local_probs` carries THIS process's slice on the leading axis; the
    returned SolveResult is globally sharded (each process addresses its own
    shard; use gather_results for host-side aggregation)."""
    import jax.numpy as jnp

    from timeopt.solver.ilqr import _solve_batch_jit

    opts = options or SolveOptions()
    mesh = mesh or global_mesh(axis)
    probs = distribute_batch(local_probs, mesh, axis)
    if U_inits is None:
        m = local_probs.u_ref.shape[-1]
        U_loc = np.broadcast_to(
            np.asarray(local_probs.u_ref)[..., None, :],
            local_probs.u_ref.shape[:-1] + (local_probs.N, m),
        )
        U_inits = distribute_batch(jnp.asarray(U_loc), mesh, axis)
    else:
        U_inits = distribute_batch(U_inits, mesh, axis)
    return _solve_batch_jit(system, opts, probs, U_inits)


def gather_results(tree):
    """All-gather a (possibly sharded) result pytree to host NumPy on every
    process (multihost_utils.process_allgather; tiled = concatenate shards
    along the existing batch axis). Host-0 writes artifacts, everyone else
    can drop the copy — the reference's CSV outputs stay single-writer
    (reference run_suite.py:210-292)."""
    if not is_multiprocess():
        return jax.tree.map(np.asarray, tree)
    return multihost_utils.process_allgather(tree, tiled=True)


def sync_processes(name: str = "barrier") -> None:
    """Cross-process barrier (no-op single-process)."""
    if is_multiprocess():
        multihost_utils.sync_global_devices(name)
