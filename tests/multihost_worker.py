"""Worker process for the 2-process CPU-simulated multi-host test.

Launched by tests/test_multihost.py as a real subprocess:

    python tests/multihost_worker.py <process_id> <num_processes> <port> <out>

Each process gets 2 virtual CPU devices (4 global), initializes the
multi-process runtime against a local coordinator, solves its slice of a
global double-integrator batch through parallel/distributed.py, and
all-gathers the results; process 0 writes them to <out>.npz. This is the
same code path a real multi-process launch takes (SURVEY.md §5
"Distributed communication backend") with the network replaced by
localhost gRPC.
"""

import os
import sys

# must precede the jax import: CPU backend with 2 virtual local devices
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)
os.environ.setdefault("JAX_ENABLE_X64", "true")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)
# CPU backend multi-process mode: without a cross-process collectives
# implementation the CPU client comes up single-process (process_count()==1)
jax.config.update("jax_cpu_collectives_implementation", "gloo")


def main():
    pid, nproc, port, out = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    # must run BEFORE any import that touches the XLA backend (timeopt
    # modules build jnp constants at import time)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    from timeopt.parallel import distributed as dist
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == 2, jax.local_device_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()

    from tests.helpers import tiny_double_integrator
    from timeopt.solver.ilqr import SolveOptions, broadcast_problem

    mode = sys.argv[5] if len(sys.argv) > 5 else ""
    if mode == "quad":
        # suite-shape check: the REAL quadrotor
        # problem (N=160, T in [40,160], f64) at the full suite budget
        # max_iter=12 — the accept/reject/early-exit trajectory the 25-trial
        # suite takes, not a tiny-shape proxy
        from timeopt.models import get_system

        system, mk = get_system("Quadrotor")
        prob = mk(dtype=jnp.float64)
        GB = 4
        x0s = np.tile(np.asarray(prob.x0, np.float64), (GB, 1))
        rng = np.random.default_rng(7)
        x0s[:, :3] += 0.4 * rng.standard_normal((GB, 3))
        opts = SolveOptions(method="propagator", max_iter=12, psd_levels=1)
    else:
        system, prob = tiny_double_integrator(N=16, T_min=2, T_max=12)
        GB = 8  # global batch
        x0s = np.tile(np.asarray(prob.x0, np.float64), (GB, 1))
        x0s[:, 0] += 0.1 * np.arange(GB)  # deterministic, process-independent
        opts = SolveOptions(method="propagator", max_iter=6)

    lo, hi = dist.process_batch_bounds(GB)
    local = jax.tree.map(lambda x: x[lo:hi], broadcast_problem(prob, GB)).replace(
        x0=jnp.asarray(x0s[lo:hi])
    )
    mesh = dist.global_mesh()
    res = dist.solve_batch_global(system, local, options=opts, mesh=mesh)
    gathered = dist.gather_results({"T": res.T_star, "J": res.J_star})
    dist.sync_processes("results-gathered")

    assert gathered["T"].shape == (GB,), gathered["T"].shape
    if jax.process_index() == 0:
        np.savez(out, T=gathered["T"], J=gathered["J"], x0=x0s)

    # end-to-end distributed runner: the --distributed CLI path (global mesh
    # sharding + all-gather + host-0-only CSV writes)
    if mode == "suite":
        import glob

        from timeopt.runner.run_suite import main as suite_main

        outdir = out + "_suite"
        suite_main(
            [
                "--distributed", "--outdir", outdir, "--trials", "4",
                "--max-iter", "2", "--solvers", "ourmethod",
                "--cases", "DoubleIntegrator",
            ]
        )
        dist.sync_processes("suite-done")
        # both processes share the filesystem here; after the barrier the
        # writer's two CSVs (summary_all/summary_agg) must exist
        csvs = glob.glob(os.path.join(outdir, "summary_*.csv"))
        assert len(csvs) == 2, csvs
    print(f"worker {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
