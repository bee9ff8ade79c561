"""2-process CPU-simulated multi-process integration test (component N4,
the cross-process half). Launches two real subprocesses against a local coordinator —
`jax.distributed.initialize(num_processes=2)`, 2 virtual CPU devices per
process — and checks the globally-sharded batch solve + cross-process gather
produce exactly the single-process results (solves are independent, so
sharding must be bitwise-neutral on T* and tight on J)."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from tests.helpers import tiny_double_integrator
from timeopt.solver.ilqr import SolveOptions, broadcast_problem, solve_batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(out: str, mode: str, timeout: int = 300):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multihost_worker.py")

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), out, mode],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        outputs.append(stdout)
    for pid, (p, o) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{o}"


def test_two_process_solve_matches_single_process(tmp_path):
    out = str(tmp_path / "multihost_out.npz")
    _run_workers(out, "suite")
    data = np.load(out)

    # single-process oracle: same problems, same options, local devices
    system, prob = tiny_double_integrator(N=16, T_min=2, T_max=12)
    GB = 8
    probs = broadcast_problem(prob, GB).replace(x0=jnp.asarray(data["x0"]))
    res = solve_batch(system, probs, options=SolveOptions(method="propagator", max_iter=6))

    np.testing.assert_array_equal(np.asarray(data["T"]), np.asarray(res.T_star))
    np.testing.assert_allclose(
        np.asarray(data["J"]), np.asarray(res.J_star), rtol=1e-12, atol=0
    )


def test_two_process_quadrotor_suite_shape(tmp_path):
    """Suite-shape multihost check: the real
    quadrotor problem (N=160, T in [40,160], f64) at the full suite budget
    (max_iter=12) solved across 2 processes must agree BITWISE on T* (and to
    f64 ulps on J) with the single-process solve — the complete
    accept/reject/early-exit trajectory, not a tiny-shape proxy."""
    from timeopt.models import get_system

    out = str(tmp_path / "multihost_quad.npz")
    _run_workers(out, "quad", timeout=540)
    data = np.load(out)

    system, mk = get_system("Quadrotor")
    prob = mk(dtype=jnp.float64)
    probs = broadcast_problem(prob, 4).replace(x0=jnp.asarray(data["x0"]))
    res = solve_batch(
        system, probs,
        options=SolveOptions(method="propagator", max_iter=12, psd_levels=1),
    )

    np.testing.assert_array_equal(np.asarray(data["T"]), np.asarray(res.T_star))
    # sharded/unsharded programs fuse some reductions differently: f64 ulps
    np.testing.assert_allclose(
        np.asarray(data["J"]), np.asarray(res.J_star), rtol=1e-14, atol=0
    )
    # sanity: the suite-shape solve actually lands in the reference basin
    assert set(np.asarray(data["T"])) <= set(range(40, 161))
