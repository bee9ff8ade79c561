"""Benchmark: batched HOP-DDP solves/s on one GPU through the dp-sharded path.

Reference headline to beat: a single quadrotor HOP-DDP solve in 2.9 s on CPU
(reference README.md:26; BASELINE.md). This benchmark runs the full solver
(AD linearize -> LFT propagator sweep -> truncated backward -> line search,
max_iter=12 as in the reference suite) on a batch of perturbed problems
(the reference's trial distribution, reference run_suite.py:69-74) in f64,
the reference's precision, and reports solves/s.

The batch is placed device-resident with a NamedSharding over a ("dp",)
mesh of all local devices BEFORE the timed region — the steady-state
serving shape (problems live on-device; only O(B) result scalars cross the
host boundary), and the exact program the multi-card path runs.

vs_baseline = measured solves/s divided by the reference's 1/2.9 solves/s
(i.e. the per-solve speedup over the reference single solve).

Completion is awaited with `jax.block_until_ready`. The script refuses to
run on anything but a GPU.

Env knobs: BENCH_BATCH (1024), BENCH_REPS (5), BENCH_PIPE (4),
BENCH_CASE (Quadrotor), BENCH_SHARDED (1), BENCH_N (override the case's
horizon count N and clamp T_max to it — e.g. BENCH_N=100 runs the
BASELINE.json metric line's literal "quadrotor, N=100 horizons" config).

Prints exactly ONE JSON line on stdout.
"""

import json
import os
import sys
import time

import numpy as np

BATCH = int(os.environ.get("BENCH_BATCH", "1024"))
REPS = int(os.environ.get("BENCH_REPS", "5"))
# back-to-back batches per timed rep with ONE final sync: jax dispatch is
# async, so the host-side dispatch+sync round-trip amortizes over PIPE
# batches — the steady-state serving shape (continuous batch stream), not a
# per-call latency measurement.
PIPE = int(os.environ.get("BENCH_PIPE", "4"))
CASE = os.environ.get("BENCH_CASE", "Quadrotor")
SHARDED = os.environ.get("BENCH_SHARDED", "1") == "1"
BENCH_N = int(os.environ.get("BENCH_N", "0"))  # 0 = the case's own N
MAX_ITER = 12


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    n_dev = len(jax.devices())
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX sees {dev.platform!r}")

    from timeopt.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    from timeopt.models import get_system
    from timeopt.ops.wrap import wrap_error
    from timeopt.solver.ilqr import (
        SolveOptions,
        _solve_traced,
        broadcast_problem,
        default_U_init,
    )

    log(
        f"device: {dev.platform} {dev.device_kind} x{n_dev}, "
        f"batch={BATCH}, case={CASE}, sharded={SHARDED}, cache={cache_dir}"
    )

    system, mk = get_system(CASE)
    base = mk(dtype=jnp.float64)
    if BENCH_N:
        # horizon-count override (shapes are static functions of N/T_max
        # only; no per-time arrays live in the Problem pytree)
        base = base.replace(
            N=BENCH_N,
            T_min=min(base.T_min, BENCH_N),
            T_max=min(base.T_max, BENCH_N),
        )

    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(base.x0, np.float64), (BATCH, 1))
    if CASE == "Quadrotor":
        x0s[:, :3] += 0.4 * rng.standard_normal((BATCH, 3))
    else:
        x0s += np.asarray(system.sigma_x0, np.float64) * rng.standard_normal(x0s.shape)
    probs = broadcast_problem(base, BATCH).replace(x0=jnp.asarray(x0s))

    if SHARDED:
        # the dp-sharded serving entry: batch axis sharded over a ("dp",)
        # mesh of all local devices, problems device-resident before timing
        # (timeopt.parallel.mesh)
        from timeopt.parallel.mesh import make_mesh, shard_problems

        mesh = make_mesh()
        probs = shard_problems(probs, mesh)

    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)

    @jax.jit
    def bench_fn(probs):
        def one(p):
            res = _solve_traced(system, opts, p, default_U_init(p))
            eT = wrap_error(res.X[res.T_star] - p.xg, p.wrap_mask)
            err = jnp.sqrt(jnp.sum(jnp.square(eT)))
            return res.J_star, res.T_star, err

        return jax.vmap(one)(probs)

    t0 = time.perf_counter()
    jax.block_until_ready(bench_fn(probs))
    t_first = time.perf_counter() - t0
    log(f"first call (compile+run): {t_first:.1f}s")

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _k in range(PIPE):
            out = bench_fn(probs)
        jax.block_until_ready(out)  # the device runs them in order
        times.append((time.perf_counter() - t0) / PIPE)
    t_batch = min(times)
    solves_per_s = BATCH / t_batch

    J = np.asarray(out[0])
    T = np.asarray(out[1])
    err = np.asarray(out[2])
    finite = np.isfinite(J)
    success = finite & np.isfinite(err) & (err <= 0.5)
    log(
        f"batch time: {t_batch*1e3:.1f} ms  solves/s: {solves_per_s:.0f}  "
        f"finite: {finite.mean():.3f}  success@0.5: {success.mean():.3f}  "
        f"T* range: [{T.min()}, {T.max()}] median {np.median(T)}"
    )

    baseline_solves_per_s = 1.0 / 2.9
    name = "quadrotor" if CASE == "Quadrotor" else CASE
    print(
        json.dumps(
            {
                "metric": (
                    f"{name} HOP-DDP solves/s "
                    f"(batched{', dp-sharded' if SHARDED else ''}, "
                    f"f64, {n_dev} GPU{'s' if n_dev > 1 else ''}, max_iter={MAX_ITER}"
                    f"{f', N={BENCH_N}' if BENCH_N else ''})"
                ),
                "value": round(solves_per_s, 2),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / baseline_solves_per_s, 1),
                "batch": BATCH,
                "pipeline": PIPE,
                "batch_time_s": round(t_batch, 4),
                "success_rate": round(float(success.mean()), 4),
                "T_star_median": float(np.median(T)),
                "device": {"platform": dev.platform, "kind": dev.device_kind, "count": n_dev},
            }
        )
    )


if __name__ == "__main__":
    main()
