from timeopt.solver.ilqr import solve, solve_batch, SolveOptions, SolveResult

__all__ = ["solve", "solve_batch", "SolveOptions", "SolveResult"]
