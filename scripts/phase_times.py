"""Per-phase device time of the batched quadrotor solve on one GPU: the f64
XLA path against the f32 path with the XLA df32 select
(scan_mode="assoc_df").

    python scripts/phase_times.py [--batch 1024] [--reps 5] [--trace-dir DIR]

For each configuration it prints one line with
- the time of each solver phase (linearize, select, backward, forward) for
  one outer iteration over the whole batch, at the iterate-0 nominal: the
  median of --reps runs, each ended by `block_until_ready` (shapes are
  static and the scans run their full length, so every iteration costs the
  same);
- the whole batched solve (max_iter=12): first call (compile included) and
  warm.
Then the f32 run's T* agreement with the f64 run (landscape flat-tie rule of
timeopt/solver/verify.py) and with the committed f64 brute-force oracle on
the first 128 problems.

With --trace-dir, one warm f64 batched solve runs under jax.profiler.trace
and the GPU trace is reduced to the device's busy and idle share over the
solve, the number of kernels, and the kernels that take the most time.

Refuses to run without a GPU.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # self-locating: run bare, no PYTHONPATH needed

import argparse
import glob
import json
import os
import statistics
import time
from collections import defaultdict

import numpy as np

CASE = "Quadrotor"
MAX_ITER = 12


def _wait(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def measure(batch: int, reps: int, dtype_name: str, scan_mode: str) -> dict:
    """Phase times and the batched solve for one configuration."""
    import jax
    import jax.numpy as jnp

    from timeopt.runner.oracle_set import make_x0s
    from timeopt.models import get_system
    from timeopt.solver.cost import rollout
    from timeopt.solver.ilqr import SolveOptions, broadcast_problem, solve_batch
    from timeopt.utils.timing import _phase_fns

    dtype = jnp.dtype(dtype_name)
    system, mk = get_system(CASE)
    base = mk(dtype=dtype)
    x0s = make_x0s(CASE, np.asarray(mk(dtype=jnp.float64).x0), system.sigma_x0, batch, 0)
    probs = broadcast_problem(base, batch).replace(x0=jnp.asarray(x0s, dtype))
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1, scan_mode=scan_mode)

    lin, select, bw, fw = (jax.jit(jax.vmap(f)) for f in _phase_fns(system, opts))
    U = jnp.broadcast_to(probs.u_ref[:, None, :], (batch, base.N, system.m))
    X = jax.jit(jax.vmap(lambda p, u: rollout(system, p, p.x0, u)))(probs, U)
    lm = jnp.full((batch,), opts.lm_init, dtype)

    def run_phases():
        A, B = lin(probs, X, U)
        J, T = select(probs, X, U, A, B)
        res = bw(probs, A, B, X, U, T, lm)
        fw(probs, X, U, res.K, res.kappa, T)
        return A, B, J, T, res

    A, B, J, T, res = run_phases()  # compile every phase
    jax.block_until_ready((A, B, J, T, res))
    steps = {
        "linearize": lambda: lin(probs, X, U),
        "select": lambda: select(probs, X, U, A, B),
        "backward": lambda: bw(probs, A, B, X, U, T, lm),
        "forward": lambda: fw(probs, X, U, res.K, res.kappa, T),
    }
    phases = {k: statistics.median(_wait(f)[1] for _ in range(reps)) for k, f in steps.items()}

    out, t_first = _wait(lambda: solve_batch(system, probs, options=opts))
    warm = [_wait(lambda: solve_batch(system, probs, options=opts))[1] for _ in range(reps)]
    return {
        "dtype": dtype_name,
        "scan_mode": scan_mode,
        "batch": batch,
        "phase_s": phases,
        "solve_first_s": t_first,
        "solve_warm_s": statistics.median(warm),
        "T": np.asarray(out.T_star),
        "J": np.asarray(out.J_star, np.float64),
        "J_curve": np.asarray(out.J_curve, np.float64),
        "w": float(base.w),
        "opts": opts,
        "system": system,
        "probs": probs,
    }


def reduce_trace(trace_dir: str) -> dict:
    """Busy and idle share of the GPU over the traced window, from the
    kernel events on the device plane's stream lines."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))
    if not paths:
        raise SystemExit(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        intervals, per_kernel, lines = [], defaultdict(lambda: [0, 0]), {}
        for line in plane.lines:
            events = list(line.events)
            lines[line.name] = len(events)
            if not line.name.startswith("Stream"):
                continue
            for ev in events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_kernel[ev.name][0] += 1
                per_kernel[ev.name][1] += ev.duration_ns
        if not intervals:
            out[plane.name] = {"lines": lines}
            continue
        intervals.sort()
        busy, gaps = 0, []
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append(s - cur_e)
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = intervals[-1][1] - intervals[0][0]
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:8]
        out[plane.name] = {
            "lines": lines,
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window,
            "kernels": len(intervals),
            "gaps": len(gaps),
            "median_gap_us": statistics.median(gaps) / 1e3 if gaps else 0.0,
            "top_kernels": [
                {"name": k[:80], "count": c, "total_ms": d / 1e6} for k, (c, d) in top
            ],
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace-dir", type=str, default="")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"phase_times: needs a GPU, JAX sees {dev.platform!r}")
    from timeopt.utils.compile_cache import enable_compile_cache
    from timeopt.solver.ilqr import solve_batch
    from timeopt.solver.verify import oracle_agreement
    from scripts.oracle_match import OUT

    enable_compile_cache()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}", flush=True)
    runs = [
        measure(args.batch, args.reps, "float64", "sequential"),
        measure(args.batch, args.reps, "float32", "assoc_df"),
    ]
    summary = []
    for r in runs:
        ph = " ".join(f"{k} {v * 1e3:.2f} ms" for k, v in r["phase_s"].items())
        line = (
            f"{r['dtype']} scan_mode={r['scan_mode']} B={r['batch']}: per iteration {ph} "
            f"(sum {sum(r['phase_s'].values()) * 1e3:.2f} ms); solve first call "
            f"{r['solve_first_s']:.2f} s, warm {r['solve_warm_s'] * 1e3:.1f} ms "
            f"({r['batch'] / r['solve_warm_s']:.1f} solves/s)"
        )
        print(line, flush=True)
        summary.append({k: r[k] for k in ("dtype", "scan_mode", "batch", "phase_s",
                                          "solve_first_s", "solve_warm_s")})

    a, b = runs
    vs64 = oracle_agreement(b["T"], b["J"], a["T"], a["J"], a["J_curve"], a["w"])
    oracle = np.load(os.path.join(OUT, "oracle_f64.npz"))
    n_or = oracle["T"].shape[0]
    vs_or = oracle_agreement(
        b["T"][:n_or], b["J"][:n_or], oracle["T"], oracle["J"], oracle["J_curve"], a["w"]
    )
    j_rel = np.abs(b["J"] - a["J"]) / np.abs(a["J"])
    agree = (
        f"f32 assoc_df vs f64: T* exact {vs64['n_exact']}/{vs64['n']}, exact-or-tied "
        f"{vs64['n_exact_or_tied']}/{vs64['n']}, J rel gap median {np.median(j_rel):.2e} "
        f"max {np.max(j_rel):.2e}; vs f64 brute-force oracle ({n_or}): exact "
        f"{vs_or['n_exact']}, exact-or-tied {vs_or['n_exact_or_tied']}"
    )
    print(agree, flush=True)
    summary.append({"agreement": agree})

    if args.trace_dir:
        probs, opts, system = a["probs"], a["opts"], a["system"]
        jax.block_until_ready(solve_batch(system, probs, options=opts))
        with jax.profiler.trace(args.trace_dir):
            jax.block_until_ready(solve_batch(system, probs, options=opts))
        red = reduce_trace(args.trace_dir)
        for plane, st in red.items():
            if "idle_share" not in st:
                print(f"trace {plane}: no stream events; lines {st['lines']}", flush=True)
                continue
            top = "; ".join(
                f"{k['name']} x{k['count']} {k['total_ms']:.2f} ms" for k in st["top_kernels"][:4]
            )
            print(
                f"trace {plane} (f64 solve): window {st['window_ms']:.2f} ms, busy "
                f"{st['busy_ms']:.2f} ms, idle share {st['idle_share']:.3f}, kernels "
                f"{st['kernels']}, gaps {st['gaps']} (median {st['median_gap_us']:.2f} us); "
                f"top: {top}",
                flush=True,
            )
        summary.append({"trace": red})
        with open(os.path.join(args.trace_dir, "phase_times.json"), "w") as f:
            json.dump(summary, f, indent=1, default=str)


if __name__ == "__main__":
    main()
