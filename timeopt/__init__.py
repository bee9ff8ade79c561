"""timeopt — batched horizon-optimal trajectory optimization (HOP-DDP).

A from-scratch JAX/XLA implementation of time-optimal iLQR with
variable-horizon selection, built for batched accelerator execution:

- All recursions (rollout, Riccati backward pass, LFT propagator prefix
  composition) are `lax.scan` / `lax.associative_scan` programs with static
  shapes and masked truncation — no data-dependent Python control flow.
- Linearization uses forward-mode AD (`jax.jacfwd`) by default, with
  finite-difference modes retained for parity with the CPU reference
  (reference linearization.py).
- Whole solves are pure functions of a `Problem` pytree, so thousands of
  independent solves batch with `jax.vmap` and shard over a device mesh
  with `jax.sharding` (see `timeopt.parallel`).

Solver variants (reference solver.py:4-15):
- method="propagator"  — information-form LFT propagator sweep (HOP-DDP)
- method="bruteforce"  — exact quadratic-model J(T) curve via per-T backward
  expansions (oracle baseline)
- method="onepass"     — single backward sweep around T̄ with windowed pick
"""

from timeopt.solver.ilqr import solve, solve_batch, SolveOptions, SolveResult
from timeopt.models import get_system, SYSTEMS

__version__ = "0.1.0"

__all__ = [
    "solve",
    "solve_batch",
    "SolveOptions",
    "SolveResult",
    "get_system",
    "SYSTEMS",
]
