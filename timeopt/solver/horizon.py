"""Horizon selection: LFT propagator sweep (HOP-DDP) and brute-force oracle.

Propagator (reference: propagator_all_Jt_aug,
reference horizon_selection.py:36-86): each time step contributes an
information-form LFT element (E, F, G); prefix composition of these elements
is *associative* (it is composition of linear-fractional maps), so the
reference's sequential Python loop becomes either a `lax.scan` (lowest total
FLOPs — right when a large problem batch already saturates the chip) or a
`lax.associative_scan` (O(log N) depth — right for latency-bound single
solves). Terminal queries for all N candidate horizons then evaluate in one
batched shot (vmap over t), and J(T) reduces to a single masked argmin.

Brute force (reference: bruteforce_all_Jt_backward_expansion,
reference solver.py:293-358): the exact quadratic-model J(T) for every
T via a full backward value expansion per T — here one masked reverse scan
vmapped over all T_max candidate horizons (the O(N^2 n^3) FLOPs stay, but run
as T_max parallel lanes instead of a nested Python loop).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from timeopt.ops.precision import full_matmul_precision
from timeopt.models.base import Problem, System
from timeopt.ops.linalg import psd_inv, psd_solve, sym
from timeopt.ops.wrap import wrap_error
from timeopt.solver.augmented import AugmentedBlocks
from timeopt.solver.backward import stage_expansion


class LFTElements(NamedTuple):
    E: jax.Array  # (N, p, p)
    F: jax.Array  # (N, p, p)
    G: jax.Array  # (N, p, p)


def lft_elements(blocks: AugmentedBlocks, *, psd_levels: int = 2) -> LFTElements:
    """Per-step LFT element: E = Q_aug^-1, F = E A', G = A E A' + B R^-1 B'
    (reference horizon_selection.py:57-64)."""
    A, B, Qa = blocks.A_aug, blocks.B_aug, blocks.Q_aug
    E = psd_inv(Qa, levels=psd_levels)
    F = E @ jnp.swapaxes(A, -1, -2)
    G = sym(A @ F + jnp.einsum("kim,mn,kjn->kij", B, blocks.R_inv, B))
    return LFTElements(E=E, F=F, G=G)


def lft_compose(first: LFTElements, second: LFTElements, *, psd_levels: int = 2) -> LFTElements:
    """Associative composition of LFT elements (first, then second):
      W = (E2 + G1)^-1
      E = E1 - F1 W F1',  F = F1 W F2,  G = G2 - F2' W F2
    (the reference's prefix recursion, reference horizon_selection.py:67-75,
    with `first` = accumulated prefix and `second` = next step). Broadcasts
    over any leading batch axes, so it drops directly into associative_scan.
    """
    E1, F1, G1 = first
    E2, F2, G2 = second
    W = psd_inv(E2 + G1, levels=psd_levels)
    F1W = F1 @ W
    E = sym(E1 - F1W @ jnp.swapaxes(F1, -1, -2))
    F = F1W @ F2
    G = sym(G2 - jnp.swapaxes(F2, -1, -2) @ W @ F2)
    return LFTElements(E=E, F=F, G=G)


def lft_prefix_scan(elems: LFTElements, *, mode: str = "sequential", psd_levels: int = 2) -> LFTElements:
    """All prefix compositions elem_0 ∘ ... ∘ elem_k for k = 0..N-1."""
    if mode == "associative":
        return LFTElements(
            *lax.associative_scan(
                lambda a, b: tuple(lft_compose(LFTElements(*a), LFTElements(*b), psd_levels=psd_levels)),
                tuple(elems),
                axis=0,
            )
        )
    if mode != "sequential":
        raise ValueError(f"unknown scan mode {mode!r}")

    def f(carry, elem_k):
        out = lft_compose(carry, LFTElements(*elem_k), psd_levels=psd_levels)
        return out, out

    first = jax.tree.map(lambda x: x[0], elems)
    rest = jax.tree.map(lambda x: x[1:], elems)
    _, tail = lax.scan(f, first, tuple(rest))
    return jax.tree.map(
        lambda h, t: jnp.concatenate([h[None], t], axis=0), first, LFTElements(*tail)
    )


def propagator_J_curve(
    prefixes: LFTElements,
    QT: jax.Array,
    *,
    psd_levels: int = 2,
) -> jax.Array:
    """Reference-parity terminal query (inverts the regularized homogeneous
    terminal block, reference horizon_selection.py:78-85):

    J(T) = 0.5 z0' X0^-1 z0 with
      X0 = Ebar_{T-1} - Fbar_{T-1} (QT_T^-1 + Gbar_{T-1})^-1 Fbar_{T-1}'
    and z0 = e_{n+1}, so z0' X0^-1 z0 is just the last component of the
    solve X0 y = z0 — no full inverse needed.

    NOTE: QT is rank-deficient by construction, so this path inherits the
    reference's O(1e-4) regularization error; prefer
    propagator_J_curve_factored.
    """
    Eb, Fb, Gb = prefixes
    Xt = psd_inv(QT, levels=psd_levels)  # (N, p, p)
    Wt = psd_inv(Xt + Gb, levels=psd_levels)
    X0 = sym(Eb - Fb @ Wt @ jnp.swapaxes(Fb, -1, -2))
    p = X0.shape[-1]
    z0 = jnp.zeros((p,), dtype=X0.dtype).at[-1].set(1.0)
    y = psd_solve(X0, jnp.broadcast_to(z0, X0.shape[:-1]), levels=psd_levels)
    return 0.5 * y[..., -1]


def propagator_J_curve_factored(
    prefixes: LFTElements,
    C: jax.Array,
    *,
    psd_levels: int = 2,
) -> jax.Array:
    """Exact inverse-free terminal query (default; an improvement over the
    reference's regularized inversion of a singular block).

    With QT = C'C (C = L'[I e_t] from build_terminal_factors), push-through:
      (QT^-1 + G)^-1 = C' (I_n + C G C')^-1 C
    so
      X0 = E - (F C') (I_n + C G C')^-1 (C F')
    and J(T) = 0.5 (X0^-1)[p-1, p-1] via one (n+1) solve. All inverted
    matrices are well-conditioned SPD; the identity is exact (validated to
    ~1e-9 against an independent Riccati oracle vs ~1e-4 for the reference
    formulation, matching the reference's own consistency_max_abs)."""
    Eb, Fb, Gb = prefixes
    n = C.shape[-2]
    Ct = jnp.swapaxes(C, -1, -2)  # (N, p, n)
    S = jnp.eye(n, dtype=C.dtype) + C @ Gb @ Ct  # (N, n, n) SPD
    FC = Fb @ Ct  # (N, p, n)
    Y = psd_solve(S, jnp.swapaxes(FC, -1, -2), jitter=0.0, levels=psd_levels)  # (N, n, p)
    X0 = sym(Eb - FC @ Y)
    p = X0.shape[-1]
    z0 = jnp.zeros((p,), dtype=X0.dtype).at[-1].set(1.0)
    y = psd_solve(X0, jnp.broadcast_to(z0, X0.shape[:-1]), levels=psd_levels)
    return 0.5 * y[..., -1]


@full_matmul_precision
def propagator_select(
    blocks: AugmentedBlocks,
    terminal: jax.Array,
    *,
    scan_mode: str = "sequential",
    psd_levels: int = 2,
    terminal_mode: str = "factored",
) -> jax.Array:
    """Full propagator sweep: blocks -> J(T) curve, T = 1..N.

    `terminal` is C from build_terminal_factors (terminal_mode="factored",
    default) or QT from build_terminal_blocks (terminal_mode="inverse",
    reference parity)."""
    elems = lft_elements(blocks, psd_levels=psd_levels)
    prefixes = lft_prefix_scan(elems, mode=scan_mode, psd_levels=psd_levels)
    if terminal_mode == "factored":
        return propagator_J_curve_factored(prefixes, terminal, psd_levels=psd_levels)
    return propagator_J_curve(prefixes, terminal, psd_levels=psd_levels)


# =============================================================================
# Brute-force oracle
# =============================================================================


def _value_expansion_arrays(
    A, B, lx, lu, l0, Qstage, eTs, QfT, R, T, *, lm_lambda=1e-6, psd_levels=2
):
    """Array-only masked value-expansion scan with terminal at (traced) T
    (reference inner loop reference solver.py:316-356).
    eTs[k] = wrap(x_{k+1} - xg); QfT = sym(Qf)."""
    N, m = lu.shape
    dtype = A.dtype
    I_m = jnp.eye(m, dtype=dtype)
    lam = jnp.asarray(lm_lambda, dtype)

    def f(carry, inp):
        Vx, Vxx, V0 = carry
        k, Ak, Bk, lxk, luk, l0k, Qsk, eT = inp

        is_term = (k + 1) == T
        Vx_in = jnp.where(is_term, QfT @ eT, Vx)
        Vxx_in = jnp.where(is_term, QfT, Vxx)
        V0_in = jnp.where(is_term, 0.5 * eT @ (QfT @ eT), V0)

        Qx = lxk + Ak.T @ Vx_in
        Qu = luk + Bk.T @ Vx_in
        Qxx = Qsk + Ak.T @ Vxx_in @ Ak
        Quu = R + Bk.T @ Vxx_in @ Bk
        Qux = Bk.T @ Vxx_in @ Ak

        Quu_reg = sym(Quu) + lam * I_m
        invQuuQu = psd_solve(Quu_reg, Qu, levels=psd_levels)
        invQuuQux = psd_solve(Quu_reg, Qux, levels=psd_levels)

        Vx_new = Qx - Qux.T @ invQuuQu
        Vxx_new = sym(Qxx - Qux.T @ invQuuQux)
        V0_new = l0k + V0_in - 0.5 * Qu @ invQuuQu

        active = k < T
        return (
            jnp.where(active, Vx_new, Vx_in),
            jnp.where(active, Vxx_new, Vxx_in),
            jnp.where(active, V0_new, V0_in),
        ), None

    n = A.shape[1]
    init = (
        jnp.zeros(n, dtype=dtype),
        jnp.zeros((n, n), dtype=dtype),
        jnp.zeros((), dtype=dtype),
    )
    ks = jnp.arange(N)
    (Vx0, Vxx0, V00), _ = lax.scan(
        f, init, (ks, A, B, lx, lu, l0, Qstage, eTs), reverse=True
    )
    return V00


def value_expansion_V0(
    system: System,
    prob: Problem,
    A: jax.Array,
    B: jax.Array,
    X: jax.Array,
    U: jax.Array,
    T: jax.Array,
    *,
    lm_lambda: float = 1e-6,
    psd_levels: int = 2,
) -> jax.Array:
    """V0(0) of the full quadratic value expansion with terminal at (traced)
    step T: one masked reverse scan (reference inner loop:
    reference solver.py:316-356)."""
    e, du, lx, lu, l0, Qstage = stage_expansion(system, prob, X, U)
    eTs = wrap_error(X[1:] - prob.xg, prob.wrap_mask)
    return _value_expansion_arrays(
        A, B, lx, lu, l0, Qstage, eTs, sym(prob.Qf), prob.R, T,
        lm_lambda=lm_lambda, psd_levels=psd_levels,
    )


@functools.lru_cache(maxsize=None)
def _make_bruteforce_cv(lm_lambda: float, psd_levels: int):
    """custom_vmap'd array-only brute-force curve for static (lm, levels).

    Under a problem-batch vmap at f32, the whole batch routes through the
    df32 two-lane-axis implementation (solver/bruteforce_df.py): the
    plain-f32 value-expansion recursion is precision-broken exactly like the
    propagator recursion (cartpole baseline1 T_median 232 vs the true 181),
    so baseline1 needs the same df32 treatment to stay the in-suite oracle.
    The route depends on the dtype alone, as in the one-pass sweep
    (solver/onepass.py); unbatched and f64 solves take the XLA vmap-over-T
    path."""

    def impl(A, B, lx, lu, l0, Qs, eTs, QfT, R):
        Tm = A.shape[0]
        Ts = jnp.arange(1, Tm + 1)
        return jax.vmap(
            lambda T: _value_expansion_arrays(
                A, B, lx, lu, l0, Qs, eTs, QfT, R, T,
                lm_lambda=lm_lambda, psd_levels=psd_levels,
            )
        )(Ts)

    @jax.custom_batching.custom_vmap
    def cv(A, B, lx, lu, l0, Qs, eTs, QfT, R):
        return impl(A, B, lx, lu, l0, Qs, eTs, QfT, R)

    @cv.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [
            a if b else jnp.broadcast_to(a, (axis_size,) + jnp.shape(a))
            for a, b in zip(args, in_batched)
        ]
        if args[0].dtype == jnp.float32:
            from timeopt.solver.bruteforce_df import bruteforce_lanes_df

            A, B, lx, lu, l0, Qs, eTs, QfT, R = args
            J = bruteforce_lanes_df(
                A, B, lx, lu, l0, Qs, eTs, QfT, R, lm_lambda=lm_lambda
            )
        else:
            J = jax.vmap(impl)(*args)
        return J, True

    return cv


@full_matmul_precision
def bruteforce_J_curve(
    system: System,
    prob: Problem,
    A: jax.Array,
    B: jax.Array,
    X: jax.Array,
    U: jax.Array,
    *,
    lm_lambda: float = 1e-6,
    psd_levels: int = 2,
) -> jax.Array:
    """J(T) for all T = 1..T_max — T_max masked value-expansion scans, run as
    one vmap over the candidate-horizon axis (df32 lanes under an f32 batch
    vmap; see _make_bruteforce_cv)."""
    e, du, lx, lu, l0, Qstage = stage_expansion(system, prob, X, U)
    eTs = wrap_error(X[1:] - prob.xg, prob.wrap_mask)
    QfT = sym(prob.Qf)
    return _make_bruteforce_cv(float(lm_lambda), int(psd_levels))(
        A, B, lx, lu, l0, Qstage, eTs, QfT, prob.R
    )


# =============================================================================
# Single-jitter-level sequential select (the default route)
# =============================================================================


def propagator_select_single_jitter(A_aug, B_aug, Q_aug, R_inv, C):
    """Sequential prefix scan + factored terminal query with one SPD jitter
    level: the J(T) curve for every T = 1..N (before the s_0^2 scale).
    Batches under `vmap` like any XLA function."""
    blocks = AugmentedBlocks(A_aug=A_aug, B_aug=B_aug, Q_aug=Q_aug, R_inv=R_inv)
    elems = lft_elements(blocks, psd_levels=1)
    pre = lft_prefix_scan(elems, mode="sequential", psd_levels=1)
    return propagator_J_curve_factored(pre, C, psd_levels=1)


def _assemble_from_fused(A, Bm, vecs, scal, Qq, R_inv, Lt):
    """XLA assembly of the augmented blocks from fused inputs (same
    arithmetic as solver/augmented.py build_augmented +
    build_terminal_factors after scaling)."""
    e, en, atil, Qe = vecs[:, 0], vecs[:, 1], vecs[:, 2], vecs[:, 3]
    corner, inv_sk, s_kp1, inv_skp1 = (
        scal[:, 0], scal[:, 1], scal[:, 2], scal[:, 3],
    )
    N, n = e.shape
    dtype = e.dtype

    Q_aug = jnp.zeros((N, n + 1, n + 1), dtype=dtype)
    Q_aug = Q_aug.at[:, :n, :n].set(jnp.broadcast_to(Qq, (N, n, n)))
    Q_aug = Q_aug.at[:, :n, n].set(Qe * inv_sk[:, None])
    Q_aug = Q_aug.at[:, n, :n].set(Qe * inv_sk[:, None])
    Q_aug = Q_aug.at[:, n, n].set(corner * inv_sk * inv_sk)

    A_aug = jnp.zeros((N, n + 1, n + 1), dtype=dtype)
    A_aug = A_aug.at[:, :n, :n].set(A)
    A_aug = A_aug.at[:, :n, n].set(atil * inv_sk[:, None])
    A_aug = A_aug.at[:, n, n].set(s_kp1 * inv_sk)

    B_aug = jnp.zeros((N, n + 1, Bm.shape[-1]), dtype=dtype)
    B_aug = B_aug.at[:, :n, :].set(Bm)

    Le = en @ Lt.T  # (N, n) = Lt e_{k+1}
    C = jnp.concatenate(
        [jnp.broadcast_to(Lt, (N, n, n)), (Le * inv_skp1[:, None])[..., None]],
        axis=-1,
    )
    return A_aug, B_aug, Q_aug, C


def propagator_select_fused(A, Bm, vecs, scal, Qq, R_inv, Lt):
    """The default select route: assemble the augmented blocks from the
    (n,)-sized fused inputs (solver/augmented.py build_fused_inputs), then
    run propagator_select_single_jitter."""
    A_aug, B_aug, Q_aug, C = _assemble_from_fused(A, Bm, vecs, scal, Qq, R_inv, Lt)
    return propagator_select_single_jitter(A_aug, B_aug, Q_aug, R_inv, C)
