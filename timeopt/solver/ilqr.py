"""Outer time-optimal iLQR loop — one jitted program per (system, options).

Reference counterpart: ilqr_timeopt (reference solver.py:449-765).
Differences forced by (and exploited for) compiled, batched execution:

- The iteration loop is a `lax.scan` over the static `max_iter` budget with a
  `done` mask: once converged (relative cost change < rel_tol AND last three
  accepted horizons identical — reference solver.py:745-748), remaining
  iterations pass state through unchanged. Shapes never depend on data.
- Accept/reject (Levenberg-Marquardt lambda /10 on accept, x10 on reject —
  reference solver.py:735-742) is branchless select logic.
- The whole solve is a pure function of a `Problem` pytree, so `vmap`
  batches thousands of solves and `jax.sharding` spreads the batch over a
  device mesh (see timeopt.parallel).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from timeopt.models.base import Problem, System
from timeopt.ops.precision import full_matmul_precision
from timeopt.solver.augmented import (
    build_augmented,
    build_fused_inputs,
    build_terminal_blocks,
    build_terminal_factors,
)
from timeopt.solver.backward import backward_truncated
from timeopt.solver.cost import argmin_T, rollout
from timeopt.solver.forward import forward_linesearch
from timeopt.solver.horizon import (
    bruteforce_J_curve,
    propagator_select,
    propagator_select_fused,
    propagator_select_single_jitter,
)
from timeopt.solver.linearize import linearize


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Static solver configuration (hashable; specializes the jitted program).

    Defaults mirror the reference's ilqr_timeopt signature
    (reference solver.py:449-471) except `linearize_mode`, which
    defaults to exact AD Jacobians instead of finite differences.
    """

    method: str = "propagator"  # "propagator" | "bruteforce" | "onepass"
    max_iter: int = 15
    lm_init: float = 1e-3
    S_window: int = 20
    linearize_mode: str = "ad"  # "ad" | "central" | "forward"
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.05)
    # LFT prefix scan: "sequential" (lax.scan, lowest FLOPs) | "associative"
    # (lax.associative_scan, O(log N) depth) | "assoc_df" (df32
    # Hillis-Steele over the time axis, solver/select_assoc.py)
    scan_mode: str = "sequential"
    terminal_mode: str = "factored"  # "factored" (exact) | "inverse" (reference parity)
    homogeneous_scaling: bool = True  # balance augmented blocks (fp32-critical)
    # SPD jitter ladder depth. The default sequential + factored select runs
    # a single level whatever this says; the other select routes, the
    # brute-force curve and the augmented-block assembly read it.
    psd_levels: int = 2
    # Stage-cost diagonal regularization for the information-form propagator
    # (E = Q_aug^-1 must exist even when Q has zero rows, e.g. cartpole's
    # unweighted theta). None -> dtype-aware: 1e-9 in f64, 1e-5 in f32 —
    # kappa(Q_aug) ~ max(Q)/q_reg must stay within the arithmetic's reach
    # (df32 eps ~ 4e-15: q_reg 1e-9 leaves the cartpole J(T) curve wrong by
    # up to 54x and picks T*~100 instead of 129/181; 1e-5 restores the f64
    # argmin and perturbs J by < 0.6%, measured q_reg-insensitive in f64 up
    # to 1e-4).
    q_reg: Optional[float] = None
    rho_reg: float = 1e-12
    rel_tol: float = 1e-4
    # Batch-wide early exit: run the outer loop as a `lax.while_loop` that
    # stops as soon as EVERY problem in the (possibly vmapped) batch is
    # converged, instead of a fixed `lax.scan` over max_iter with done
    # lanes masked. Per-problem results are identical (done lanes are frozen
    # either way — the reference `break`s on the same convergence test,
    # reference solver.py:745-753); this only recovers the wall-clock
    # the reference saves by breaking early.
    early_exit: bool = True
    onepass_preimage: str = "fixedpoint"  # "fixedpoint" | "newton" | "copy"
    # Fixed-point preimage iteration budget (reference linearization.py:41-71
    # uses 6; 4 is the outcome-parity default — see
    # onepass.fixedpoint_preimage_step and the 4-vs-6 sensitivity sweep in
    # docs/DESIGN.md: outcome-equivalent on every trial of every case except
    # the one knife-edge cartpole trial where 6 tips final_err 0.51 > 0.5).
    preimage_iters: int = 4
    # Compensated df32 forward rollouts (solver/rollout_df.py): "auto" turns
    # them on for f32 problems on systems exposing `xdot` — required for
    # trajectory-level f32 accuracy on long nonlinear horizons (cartpole).
    df_forward: str = "auto"  # "auto" | "on" | "off"
    # Optional dtype override for the selection curve (e.g. "float64" to run
    # an f32 solve with an f64 selection: the plain-f32 selection recursion
    # is numerically wrong). None: selection runs in the problem dtype.
    select_dtype: Optional[str] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolveResult:
    X: jax.Array  # (N+1, n) final nominal trajectory
    U: jax.Array  # (N, m) final controls
    T_star: jax.Array  # () int32 selected horizon
    J_star: jax.Array  # () final accepted cost (inf if never accepted)
    J_curve: jax.Array  # (T_max,) last selection curve
    J_hist: jax.Array  # (max_iter+1,) accepted costs, NaN-padded
    T_hist: jax.Array  # (max_iter+1,) accepted horizons, -1-padded
    n_accept: jax.Array  # () int32 number of accepted updates
    lm_final: jax.Array  # () final LM lambda
    # () int32 — one-pass only: iterations whose value sweep went numerically
    # bad (ok=False) and fell back to the fixed-T̄ update. The branchless
    # analogue of the reference's `onepass_error` exception record
    # (reference solver.py:674-701, 764); always 0 for curve methods.
    n_fallback: jax.Array
    # (T_max,) bool — horizons t (1-indexed: entry t-1) tied with T* on the
    # final selection curve under the landscape flat-tie criterion
    # |J(t) - J(T*)| <= w * (|t - T*| + 1): the J gap is below the w·T
    # time-penalty resolution, so the two picks are cost-equivalent flat-
    # valley minima (the criterion scripts/oracle_match.py applies post-hoc
    # against the f64 oracle — here computed on-chip so "exact-or-tied"
    # agreement is a first-class solver output). T* itself is always in the
    # set; a strongly convex curve yields the singleton {T*}.
    T_ties: jax.Array

    def replace(self, **changes) -> "SolveResult":
        """Copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)


class _LoopState(NamedTuple):
    X: jax.Array
    U: jax.Array
    lm: jax.Array
    T_bar: jax.Array
    J_last: jax.Array
    J_prev: jax.Array
    n_acc: jax.Array
    T3: jax.Array  # (3,) last three accepted horizons (sentinel-initialized)
    done: jax.Array
    J_curve: jax.Array
    J_hist: jax.Array
    T_hist: jax.Array
    n_fb: jax.Array  # () int32 one-pass sweep-failure fallback count


def _tree_select(pred, on_true, on_false):
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), on_true, on_false)


def flat_tie_set(J_curve: jax.Array, T_star: jax.Array, T_min, w) -> jax.Array:
    """(T_max,) bool mask of horizons tied with T* on the selection curve:
    |J(t) - J(T*)| <= w * (|t - T*| + 1) for t in [T_min, T_max] with finite
    curve entries (entry t-1 holds horizon t). The criterion is the
    landscape flat-tie test of scripts/oracle_match.py: a J gap at or below
    the w-per-step time penalty's own resolution means the tracking cost is
    flat between the picks and either horizon is a valid argmin."""
    T_max = J_curve.shape[0]
    t = jnp.arange(1, T_max + 1)
    J_at_star = J_curve[T_star - 1]
    dT = jnp.abs(t - T_star).astype(J_curve.dtype)
    fin = jnp.isfinite(J_curve) & jnp.isfinite(J_at_star)
    return (t >= T_min) & fin & (jnp.abs(J_curve - J_at_star) <= w * (dT + 1.0))


def _run_outer_loop(
    body, state: _LoopState, opts: SolveOptions, n_iters: Optional[int] = None
) -> _LoopState:
    """Run the outer iteration `body` (a scan-style (state, it) -> (state,
    None) function whose `done` flag freezes converged state) for at most
    `n_iters` (default max_iter) steps, passing the iteration index as the
    second argument. With early_exit, a `lax.while_loop` stops as soon as
    the whole (possibly vmapped) batch is done — the reference `break`s on
    the same convergence test (reference solver.py:745-753); results
    are identical either way because done lanes pass through unchanged."""
    n = opts.max_iter if n_iters is None else n_iters
    if opts.early_exit:
        def wcond(carry):
            it, s = carry
            return (it < n) & ~s.done

        def wbody(carry):
            it, s = carry
            s, _ = body(s, it)
            return it + 1, s

        _, state = lax.while_loop(wcond, wbody, (jnp.asarray(0, jnp.int32), state))
        return state
    state, _ = lax.scan(body, state, jnp.arange(n, dtype=jnp.int32))
    return state


def _df_on(system: System, opts: SolveOptions, dtype) -> bool:
    """Resolve the df_forward mode statically (trace-time)."""
    if opts.df_forward == "off":
        return False
    from timeopt.solver.rollout_df import supports_df

    if opts.df_forward == "on":
        if not supports_df(system):
            raise ValueError(f"df_forward='on' but system {system.name} has no xdot")
        return True
    return supports_df(system) and dtype == jnp.float32


def resolve_q_reg(opts: SolveOptions, dtype) -> float:
    """Dtype-aware q_reg default (see SolveOptions.q_reg)."""
    if opts.q_reg is not None:
        return opts.q_reg
    if dtype == jnp.float64:
        return 1e-9
    return 1e-5


@full_matmul_precision
def _select_curve(system: System, prob: Problem, opts: SolveOptions, X, U, A, B):
    """Method-specific J(T) selection curve over T = 1..T_max."""
    if opts.select_dtype is not None:
        sd = jnp.dtype(opts.select_dtype)
        if sd != X.dtype:
            cast = lambda t: jax.tree.map(  # noqa: E731
                lambda a: a.astype(sd) if jnp.issubdtype(a.dtype, jnp.floating) else a, t
            )
            opts_inner = dataclasses.replace(opts, select_dtype=None)
            curve = _select_curve(
                system, cast(prob), opts_inner, cast(X), cast(U), cast(A), cast(B)
            )
            return curve.astype(X.dtype)
    Tm = prob.T_max
    Xh, Uh, Ah, Bh = X[: Tm + 1], U[:Tm], A[:Tm], B[:Tm]
    if opts.method == "propagator":
        seq_factored = opts.scan_mode == "sequential" and opts.terminal_mode == "factored"
        if seq_factored and system.extra_cost is None:
            # default route: the augmented blocks are assembled from raw
            # (n,)-sized inputs (horizon.propagator_select_fused)
            fi = build_fused_inputs(
                system, prob, Xh, Uh, Ah, Bh,
                q_reg=resolve_q_reg(opts, X.dtype), rho_reg=opts.rho_reg,
                psd_levels=opts.psd_levels, scale=opts.homogeneous_scaling,
            )
            return fi.s[0] ** 2 * propagator_select_fused(
                fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt
            )
        blocks = build_augmented(
            system, prob, Xh, Uh, Ah, Bh,
            q_reg=resolve_q_reg(opts, X.dtype), rho_reg=opts.rho_reg,
            psd_levels=opts.psd_levels,
            scale=opts.homogeneous_scaling,
        )
        if opts.terminal_mode == "factored":
            terminal = build_terminal_factors(prob, Xh, rho_reg=opts.rho_reg, s=blocks.s)
        else:
            terminal = build_terminal_blocks(prob, Xh, rho_reg=opts.rho_reg, s=blocks.s)
        # J(T) carries the s_0^2 factor of the homogeneous scaling
        j_scale = blocks.s[0] ** 2
        if opts.scan_mode == "assoc_df":
            # df32 associative select over the time axis
            # (solver/select_assoc.py): Hillis-Steele depth ceil(log2 N)
            # instead of N sequential steps, df32 throughout.
            if opts.terminal_mode != "factored":
                raise ValueError("scan_mode='assoc_df' requires terminal_mode='factored'")
            from timeopt.solver.select_assoc import propagator_select_assoc_df

            return j_scale * propagator_select_assoc_df(
                blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv, terminal,
                t_min=prob.T_min,
            )
        if seq_factored:
            # extra stage costs: the same single-jitter-level select as the
            # default route, on the assembled blocks
            return j_scale * propagator_select_single_jitter(
                blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv, terminal
            )
        return j_scale * propagator_select(
            blocks, terminal,
            scan_mode=opts.scan_mode,
            psd_levels=opts.psd_levels,
            terminal_mode=opts.terminal_mode,
        )
    if opts.method == "bruteforce":
        return bruteforce_J_curve(
            system, prob, Ah, Bh, Xh, Uh, psd_levels=opts.psd_levels
        )
    raise ValueError(f"unknown method {opts.method!r}")


def _roll3(T3, T_new):
    return jnp.concatenate([T3[1:], T_new[None]])


def _solve_curve_methods(
    system: System, opts: SolveOptions, prob: Problem, U_init: jax.Array
) -> SolveResult:
    """Shared solve path for the propagator and brute-force methods."""
    dtype = U_init.dtype
    i32 = jnp.int32
    df_on = _df_on(system, opts, dtype)
    if df_on:
        from timeopt.solver.rollout_df import rollout_df

        X = rollout_df(system, prob, prob.x0, U_init)
    else:
        X = rollout(system, prob, prob.x0, U_init)
    U = U_init

    # The warm-start update at T̄ (reference: solver.py:514-555) runs as
    # iteration 0 of the SAME loop body, distinguished only by masks: the
    # warm start records the line-search result whenever the backward pass
    # is healthy (even without improvement — ls falls back to the nominal)
    # and leaves the LM lambda untouched, while later iterations apply the
    # accept/reject rule. Outcome-identical to a separate warm-start block
    # (ls.X == X whenever nothing improves), but the program contains ONE
    # copy of linearize/select/backward/forward instead of two — roughly
    # halving cold trace+compile.
    hist_len = opts.max_iter + 1
    sentinel = jnp.asarray([-1, -2, -3], i32)
    state = _LoopState(
        X=X,
        U=U,
        lm=jnp.asarray(opts.lm_init, dtype),
        T_bar=jnp.asarray(0, i32),
        J_last=jnp.asarray(jnp.inf, dtype),
        J_prev=jnp.asarray(jnp.inf, dtype),
        n_acc=jnp.asarray(0, i32),
        T3=sentinel,
        done=jnp.asarray(False),
        J_curve=jnp.zeros((prob.T_max,), dtype),
        J_hist=jnp.full((hist_len,), jnp.nan, dtype),
        T_hist=jnp.full((hist_len,), -1, i32),
        n_fb=jnp.asarray(0, i32),
    )

    def body(s: _LoopState, it):
        warm = it == 0
        A, B = linearize(system.step, s.X, s.U, opts.linearize_mode)
        J_curve = _select_curve(system, prob, opts, s.X, s.U, A, B)
        T_star = argmin_T(J_curve, prob.T_min, prob.T_max)

        bw = backward_truncated(system, prob, A, B, s.X, s.U, T_star, s.lm)
        ls = forward_linesearch(
            system,
            prob,
            s.X,
            s.U,
            bw.K,
            bw.kappa,
            T_star,
            alphas=opts.alphas,
            df_forward=df_on,
        )
        fin = jnp.isfinite(ls.J)
        acc = bw.ok & ls.accepted & fin
        # bookkeeping gate: warm start records whenever the backward pass is
        # healthy and the (possibly unimproved) line-search cost is finite
        gate = jnp.where(warm, bw.ok & fin, acc)

        n_acc = s.n_acc + gate.astype(i32)
        upd = _LoopState(
            X=jnp.where(gate, ls.X, s.X),
            U=jnp.where(gate, ls.U, s.U),
            lm=jnp.where(
                warm,
                s.lm,
                jnp.where(acc, jnp.maximum(s.lm / 10.0, 1e-12), s.lm * 10.0),
            ),
            # the warm start adopts T̄ = argmin of the initial curve
            # unconditionally (reference: solver.py:522)
            T_bar=jnp.where(warm | acc, T_star, s.T_bar),
            J_last=jnp.where(gate, ls.J, s.J_last),
            J_prev=jnp.where(gate, s.J_last, s.J_prev),
            n_acc=n_acc,
            T3=jnp.where(gate, _roll3(s.T3, T_star), s.T3),
            done=s.done,
            J_curve=J_curve,
            J_hist=jnp.where(
                gate, lax.dynamic_update_index_in_dim(s.J_hist, ls.J, s.n_acc, 0), s.J_hist
            ),
            T_hist=jnp.where(
                gate,
                lax.dynamic_update_index_in_dim(s.T_hist, T_star, s.n_acc, 0),
                s.T_hist,
            ),
            n_fb=s.n_fb,
        )

        # convergence: rel dJ < tol AND last three accepted horizons equal
        # (reference: solver.py:745-748)
        rel = jnp.abs(upd.J_last - upd.J_prev) / (jnp.abs(upd.J_prev) + 1e-12)
        conv = (
            (upd.n_acc >= 2)
            & (rel < opts.rel_tol)
            & (upd.n_acc >= 3)
            & jnp.all(upd.T3 == upd.T3[2])
        )
        upd = upd._replace(done=s.done | conv)

        return _tree_select(s.done, s, upd), None

    state = _run_outer_loop(body, state, opts, n_iters=opts.max_iter + 1)

    T_star = jnp.where(state.n_acc > 0, state.T3[2], state.T_bar).astype(i32)
    return SolveResult(
        X=state.X,
        U=state.U,
        T_star=T_star,
        J_star=state.J_last,
        J_curve=state.J_curve,
        J_hist=state.J_hist,
        T_hist=state.T_hist,
        n_accept=state.n_acc,
        lm_final=state.lm,
        n_fallback=state.n_fb,
        T_ties=flat_tie_set(state.J_curve, T_star, prob.T_min, prob.w),
    )


@full_matmul_precision
def _solve_traced(system: System, opts: SolveOptions, prob: Problem, U_init: jax.Array):
    if opts.method in ("propagator", "bruteforce"):
        return _solve_curve_methods(system, opts, prob, U_init)
    if opts.method == "onepass":
        from timeopt.solver.onepass import solve_onepass

        return solve_onepass(system, opts, prob, U_init)
    raise ValueError(f"unknown method {opts.method!r}")


@partial(jax.jit, static_argnums=(0, 1))
def _solve_jit(system: System, opts: SolveOptions, prob: Problem, U_init: jax.Array):
    return _solve_traced(system, opts, prob, U_init)


@partial(jax.jit, static_argnums=(0, 1))
def _solve_batch_jit(system: System, opts: SolveOptions, probs: Problem, U_inits: jax.Array):
    return jax.vmap(lambda p, u: _solve_traced(system, opts, p, u))(probs, U_inits)


def default_U_init(prob: Problem) -> jax.Array:
    """Nominal initial controls: u_ref tiled over the horizon
    (reference: solver.py:480-481)."""
    return jnp.broadcast_to(prob.u_ref, (prob.N, prob.u_ref.shape[-1]))


def solve(
    system: System,
    prob: Problem,
    U_init: Optional[jax.Array] = None,
    options: Optional[SolveOptions] = None,
) -> SolveResult:
    """Solve one horizon-optimal trajectory-optimization problem."""
    opts = options or SolveOptions()
    if U_init is None:
        U_init = default_U_init(prob)
    else:
        U_init = _pad_U(jnp.asarray(U_init, dtype=prob.x0.dtype), prob.N)
    return _solve_jit(system, opts, prob, U_init)


def solve_batch(
    system: System,
    probs: Problem,
    U_inits: Optional[jax.Array] = None,
    options: Optional[SolveOptions] = None,
) -> SolveResult:
    """Solve a batch of problems (all Problem leaves carrying a leading batch
    axis, e.g. via `stack_problems`)."""
    opts = options or SolveOptions()
    if U_inits is None:
        m = probs.u_ref.shape[-1]
        bshape = probs.u_ref.shape[:-1]
        U_inits = jnp.broadcast_to(
            probs.u_ref[..., None, :], bshape + (probs.N, m)
        )
    return _solve_batch_jit(system, opts, probs, U_inits)


def _pad_U(U: jax.Array, N: int) -> jax.Array:
    """Pad (tile last row) or truncate U_init to horizon length N
    (reference: solver.py:483-490)."""
    if U.ndim == 1:
        U = U[:, None]
    if U.shape[0] < N:
        pad = jnp.broadcast_to(U[-1:], (N - U.shape[0], U.shape[1]))
        U = jnp.concatenate([U, pad], axis=0)
    elif U.shape[0] > N:
        U = U[:N]
    return U


def stack_problems(problems: list) -> Problem:
    """Stack a list of same-shape Problems into one batched Problem pytree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *problems)


def broadcast_problem(prob: Problem, batch: int) -> Problem:
    """Tile one Problem into a batch of `batch` identical problems (cheap:
    broadcasts views instead of stacking copies). Combine with `.replace`
    to vary per-problem fields, e.g. x0."""
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), prob
    )
