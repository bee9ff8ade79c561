from timeopt.parallel.mesh import (
    make_mesh,
    shard_problems,
    solve_batch_sharded,
    propagator_select_sharded,
)
from timeopt.parallel.stats import t_star_histogram, batch_summary
from timeopt.parallel import distributed

__all__ = [
    "make_mesh",
    "shard_problems",
    "solve_batch_sharded",
    "propagator_select_sharded",
    "t_star_histogram",
    "batch_summary",
    "distributed",
]
