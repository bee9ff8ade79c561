"""Benchmark model registry.

Reference counterpart: the case registry at reference run_suite.py:69-74
plus the legacy-only ballbot (reference ilqr_propagator.py:685-698).
"""

from timeopt.models import (
    ballbot,
    cartpole,
    double_integrator,
    pointmass,
    quadrotor,
    segway,
)
from timeopt.models.base import Problem, System, make_problem

_MODULES = (double_integrator, cartpole, quadrotor, segway, ballbot, pointmass)

SYSTEMS = {mod.SYSTEM.name: mod for mod in _MODULES}


def get_system(name: str):
    """Return (System, default_problem_factory) for a registered model."""
    if name not in SYSTEMS:
        raise KeyError(f"unknown system {name!r}; available: {sorted(SYSTEMS)}")
    mod = SYSTEMS[name]
    return mod.SYSTEM, mod.default_problem


__all__ = ["Problem", "System", "make_problem", "SYSTEMS", "get_system"]
