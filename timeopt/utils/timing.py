"""Phase-level profiling: the reference's 4-phase wall-clock breakdown
(linearize / select / backward / forward — reference solver.py:497-551,
SURVEY.md §5 'Tracing/profiling') reproduced with device-synchronized timing.

The production solver runs the whole loop inside one jitted program (no
phase boundaries to time), so this module re-runs the solve as a host-driven
loop of individually jitted phases with `block_until_ready` brackets. Use it
for apples-to-apples comparison against the reference's timers and for
locating hot phases; use the fused solver for throughput.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp

from timeopt.models.base import Problem, System
from timeopt.ops.precision import full_matmul_precision
from timeopt.solver.backward import backward_truncated
from timeopt.solver.cost import argmin_T, rollout
from timeopt.solver.forward import forward_linesearch
from timeopt.solver.ilqr import SolveOptions, _df_on, _select_curve, default_U_init
from timeopt.solver.linearize import linearize


@functools.lru_cache(maxsize=None)
def _phase_fns(system: System, opts: SolveOptions):
    """Per-(system, options) jitted phase functions, cached at module level:
    a fresh closure per profile call would re-trace AND re-compile every
    phase on each invocation (the closures would bake the captured problem
    arrays in as constants), so the reported timers would be compile times
    — measured 165 ms for a select whose steady-state run is 0.3 ms.
    `prob` is an explicit argument so the jit cache keys on its shapes."""

    # every phase traces under full f32 matmul precision so the profiled
    # program matches the production _solve_traced path (invariant 2), and
    # select/forward take the production routes (_select_curve, _df_on)
    lin = jax.jit(full_matmul_precision(
        lambda prob, X, U: linearize(system.step, X, U, opts.linearize_mode)
    ))

    @jax.jit
    def select(prob, X, U, A, B):
        J = _select_curve(system, prob, opts, X, U, A, B)
        return J, argmin_T(J, prob.T_min, prob.T_max)

    bw = jax.jit(full_matmul_precision(
        lambda prob, A, B, X, U, T, lm: backward_truncated(
            system, prob, A, B, X, U, T, lm
        )
    ))
    fw = jax.jit(full_matmul_precision(
        lambda prob, X, U, K, kap, T: forward_linesearch(
            system, prob, X, U, K, kap, T, alphas=opts.alphas,
            df_forward=_df_on(system, opts, X.dtype),
        )
    ))
    return lin, select, bw, fw


def profile_solve(
    system: System,
    prob: Problem,
    options: Optional[SolveOptions] = None,
    U_init=None,
):
    """Run a propagator/bruteforce solve phase-by-phase with per-phase device
    timers. Returns (result_dict, timers) where timers has the reference's
    keys {linearize, select, backward, forward} in seconds."""
    opts = options or SolveOptions()
    assert opts.method in ("propagator", "bruteforce")
    timers = {"linearize": 0.0, "select": 0.0, "backward": 0.0, "forward": 0.0}

    _lin, _select, _bw, _fw = _phase_fns(system, opts)
    lin = functools.partial(_lin, prob)
    select = functools.partial(_select, prob)
    bw = functools.partial(_bw, prob)
    fw = functools.partial(_fw, prob)

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        jax.block_until_ready(out)
        timers[key] += time.perf_counter() - t0
        return out

    if U_init is None:
        U_init = default_U_init(prob)
    U = U_init
    X = rollout(system, prob, prob.x0, U)
    jax.block_until_ready(X)

    A, B = timed("linearize", lin, X, U)
    J_curve, T_bar = timed("select", select, X, U, A, B)

    lm = jnp.asarray(opts.lm_init, X.dtype)
    res_bw = timed("backward", bw, A, B, X, U, T_bar, lm)
    J_hist, T_hist = [], []
    if bool(res_bw.ok):
        ls = timed("forward", fw, X, U, res_bw.K, res_bw.kappa, T_bar)
        X, U = ls.X, ls.U
        if bool(jnp.isfinite(ls.J)):
            J_hist.append(float(ls.J))
            T_hist.append(int(T_bar))

    for _ in range(opts.max_iter):
        A, B = timed("linearize", lin, X, U)
        J_curve, T_star = timed("select", select, X, U, A, B)
        res_bw = timed("backward", bw, A, B, X, U, T_star, lm)
        acc = False
        if bool(res_bw.ok):
            ls = timed("forward", fw, X, U, res_bw.K, res_bw.kappa, T_star)
            acc = bool(ls.accepted) and bool(jnp.isfinite(ls.J))
        if acc:
            X, U = ls.X, ls.U
            T_bar = T_star
            J_hist.append(float(ls.J))
            T_hist.append(int(T_star))
            lm = jnp.maximum(lm / 10.0, 1e-12)
        else:
            lm = lm * 10.0
        if len(J_hist) >= 2:
            rel = abs(J_hist[-1] - J_hist[-2]) / (abs(J_hist[-2]) + 1e-12)
            if rel < opts.rel_tol and len(T_hist) >= 3 and len(set(T_hist[-3:])) == 1:
                break

    result = {
        "X": X,
        "U": U,
        "J_hist": J_hist,
        "T_hist": T_hist,
        "J_curve": J_curve,
        "T_star": T_hist[-1] if T_hist else int(T_bar),
        "timers": timers,
    }
    return result, timers


@functools.lru_cache(maxsize=None)
def _onepass_phase_fns(system: System, opts: SolveOptions):
    """Cached jitted one-pass phases (see _phase_fns for why); every
    function takes `prob` as its first explicit argument."""
    from timeopt.solver.onepass import (
        extend_nominal_backward,
        onepass_pick,
        onepass_rollout,
        value_sweep_prefix,
    )

    S = int(opts.S_window)
    prefix_mode = opts.linearize_mode if opts.linearize_mode == "ad" else "forward"

    # full f32 matmul precision on every phase (invariant 2; see _phase_fns)
    lin = jax.jit(full_matmul_precision(
        lambda prob, X, U: linearize(system.step, X, U, opts.linearize_mode)
    ))
    lin_pre = jax.jit(full_matmul_precision(
        lambda prob, X, U: linearize(system.step, X, U, prefix_mode)
    ))
    ext = jax.jit(full_matmul_precision(
        lambda prob, X, U: extend_nominal_backward(
            system, X, U, U[0], S, method=opts.onepass_preimage,
            n_iter=opts.preimage_iters,
        )
    ))
    sweep_fn = jax.jit(full_matmul_precision(
        lambda prob, A, B, X, U, T_bar, lm: value_sweep_prefix(
            system, prob, A, B, X, U, T_bar, S, lm
        )
    ))
    SL = max(1, S)
    pick_fn = jax.jit(full_matmul_precision(
        lambda prob, sweep, X_ext, T_bar: onepass_pick(
            prob, sweep, X_ext, X_ext[S], T_bar, S,
            jnp.asarray(SL, jnp.int32), jnp.asarray(SL, jnp.int32),
        )
    ))
    roll_fn = jax.jit(full_matmul_precision(
        lambda prob, X_ext, U_ext, sweep, T_bar, T_star: onepass_rollout(
            system, prob, X_ext, U_ext, sweep, T_bar, T_star, S,
            alphas=opts.alphas[: min(4, len(opts.alphas))],
        )
    ))
    bw_fn = jax.jit(full_matmul_precision(
        lambda prob, A, B, X, U, T, lm: backward_truncated(
            system, prob, A, B, X, U, T, lm
        )
    ))
    fw_fn = jax.jit(full_matmul_precision(
        lambda prob, X, U, K, kap, T: forward_linesearch(
            system, prob, X, U, K, kap, T, alphas=opts.alphas,
            df_forward=_df_on(system, opts, X.dtype),
        )
    ))
    return lin, lin_pre, ext, sweep_fn, pick_fn, roll_fn, bw_fn, fw_fn


def profile_solve_onepass(
    system: System,
    prob: Problem,
    options: Optional[SolveOptions] = None,
    U_init=None,
):
    """Phase-timed one-pass (baseline2) solve. Phase attribution mirrors the
    reference's onepass branch (reference solver.py:630-732): prefix
    linearization counts as `linearize`; prefix build + value sweep + window
    pick as `select`; the shifted-gain rollout as `forward`; the fixed-T̄
    fallback's truncated backward as `backward`. Host-driven (like
    profile_solve): per-phase `block_until_ready` brackets, single window
    (no shrink retries) — a profiling view, not the production fused loop."""
    from timeopt.solver.cost import nominal_cost_curve

    opts = options or SolveOptions(method="onepass")
    assert opts.method == "onepass"
    S = int(opts.S_window)
    timers = {"linearize": 0.0, "select": 0.0, "backward": 0.0, "forward": 0.0}

    fns = _onepass_phase_fns(system, opts)
    lin, lin_pre, ext, sweep_fn, pick_fn, roll_fn, bw_fn, fw_fn = (
        functools.partial(f, prob) for f in fns
    )

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        jax.block_until_ready(out)
        timers[key] += time.perf_counter() - t0
        return out

    if U_init is None:
        U_init = default_U_init(prob)
    U = U_init
    X = rollout(system, prob, prob.x0, U)
    J_nom = nominal_cost_curve(system, prob, X, U)
    T_bar = argmin_T(J_nom, prob.T_min, prob.T_max)
    jax.block_until_ready((X, T_bar))

    # warm-start fixed-T̄ update (reference solver.py:540-555)
    A, B = timed("linearize", lin, X, U)
    lm = jnp.asarray(opts.lm_init, X.dtype)
    res_bw = timed("backward", bw_fn, A, B, X, U, T_bar, lm)
    J_hist, T_hist = [], []
    if bool(res_bw.ok):
        ls = timed("forward", fw_fn, X, U, res_bw.K, res_bw.kappa, T_bar)
        X, U = ls.X, ls.U
        if bool(jnp.isfinite(ls.J)):
            J_hist.append(float(ls.J))
            T_hist.append(int(T_bar))

    for _ in range(opts.max_iter):
        A, B = timed("linearize", lin, X, U)
        X_ext, U_ext = timed("select", ext, X, U)
        if S > 0:
            A_pre, B_pre = timed("linearize", lin_pre, X_ext[: S + 1], U_ext[:S])
            A_ext = jnp.concatenate([A_pre, A], axis=0)
            B_ext = jnp.concatenate([B_pre, B], axis=0)
        else:
            A_ext, B_ext = A, B
        sweep = timed("select", sweep_fn, A_ext, B_ext, X_ext, U_ext, T_bar, lm)
        T_star, _ = timed("select", pick_fn, sweep, X_ext, T_bar)

        acc = False
        if bool(sweep.ok):
            Xc, Uc, Jc, okroll = timed(
                "forward", roll_fn, X_ext, U_ext, sweep, T_bar, T_star
            )
            J_prev = J_hist[-1] if J_hist else float("inf")
            acc = bool(okroll) and float(Jc) < J_prev
            if acc:
                X, U, Jn = Xc, Uc, float(Jc)
        else:
            # numerical-failure fallback: fixed-T̄ truncated update
            # (reference solver.py:674-701)
            res_bw = timed("backward", bw_fn, A, B, X, U, T_bar, lm)
            if bool(res_bw.ok):
                ls = timed("forward", fw_fn, X, U, res_bw.K, res_bw.kappa, T_bar)
                acc = bool(ls.accepted) and bool(jnp.isfinite(ls.J))
                if acc:
                    X, U, Jn = ls.X, ls.U, float(ls.J)
                    T_star = T_bar
        if acc:
            T_bar = T_star
            J_hist.append(Jn)
            T_hist.append(int(T_star))
            lm = jnp.maximum(lm / 10.0, 1e-12)
        else:
            lm = lm * 10.0
        if len(J_hist) >= 2:
            rel = abs(J_hist[-1] - J_hist[-2]) / (abs(J_hist[-2]) + 1e-12)
            if rel < opts.rel_tol and len(T_hist) >= 3 and len(set(T_hist[-3:])) == 1:
                break

    result = {
        "X": X,
        "U": U,
        "J_hist": J_hist,
        "T_hist": T_hist,
        "T_star": T_hist[-1] if T_hist else int(T_bar),
        "timers": timers,
    }
    return result, timers


def profile_any(system, prob, options: SolveOptions, U_init=None):
    """Dispatch to the right phase profiler for the method."""
    if options.method == "onepass":
        return profile_solve_onepass(system, prob, options, U_init)
    return profile_solve(system, prob, options, U_init)
