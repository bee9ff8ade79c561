"""Homogeneous-coordinate (augmented) blocks for the propagator sweep.

Reference counterparts: build_augmented_sequence_QR and
build_terminal_aug_list (reference augmented.py:10-87); formulation in
the reference paper's method2 (homogeneous coordinate z = [dx; 1] absorbs the
affine residual and linear cost terms into (n+1)-dimensional blocks).

Everything is built as batched (N, n+1, n+1) tensors in a handful of fused
einsums — no per-step Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from timeopt.ops.precision import full_matmul_precision
from timeopt.models.base import Problem, System
from timeopt.ops.linalg import chol_lower, psd_inv, sym
from timeopt.ops.wrap import wrap_error
from timeopt.solver.cost import extra_cost_terms


class AugmentedBlocks(NamedTuple):
    A_aug: jax.Array  # (N, n+1, n+1)
    B_aug: jax.Array  # (N, n+1, m)
    Q_aug: jax.Array  # (N, n+1, n+1)
    R_inv: jax.Array  # (m, m)
    s: jax.Array = None  # (N+1,) homogeneous-coordinate scaling (None = 1)


def homogeneous_scales(prob: Problem, X: jax.Array) -> jax.Array:
    """Per-step similarity scaling s_k of the homogeneous coordinate.

    The raw augmented blocks are badly *graded*: the corner entry
    e'Qe + 2w spans ~1e-2..1e2 against O(1)..O(10) state blocks, and the
    time-penalty information (2w) sits several decimal digits below the
    quadratic term. In fp64 this costs a few digits (the reference runs
    fp64 and never notices); in fp32 it destroys the J(T) argmin entirely
    (measured: 0% T* agreement with fp64 on the quadrotor).

    Scaling z_k = [dx; 1] -> [dx; s_k] with s_k^2 = (e_k'Q e_k + 2w) / qbar
    balances every block (the corner becomes exactly qbar = tr(Q)/n, and by
    Cauchy-Schwarz the off-diagonal row lands between the two) while leaving
    J(T) mathematically unchanged up to the known factor s_0^2. With this
    scaling the fp32 propagator recovers the fp64 horizon selection.
    """
    e = wrap_error(X - prob.xg, prob.wrap_mask)  # (N+1, n)
    quad = jnp.einsum("ki,kj,ij->k", e, e, prob.Q)
    qbar = jnp.trace(prob.Q) / prob.n + jnp.asarray(1e-12, X.dtype)
    corner = quad + 2.0 * prob.w
    return jnp.sqrt(jnp.maximum(corner / qbar, 1e-12))


@full_matmul_precision
def build_augmented(
    system: System,
    prob: Problem,
    X: jax.Array,
    U: jax.Array,
    A: jax.Array,
    B: jax.Array,
    *,
    q_reg: float = 1e-9,
    rho_reg: float = 1e-12,
    psd_levels: int = 2,
    scale: bool = True,
) -> AugmentedBlocks:
    N, n, m = U.shape[0], prob.n, prob.m
    dtype = X.dtype

    e = wrap_error(X[:-1] - prob.xg, prob.wrap_mask)  # (N, n)
    du = U - prob.u_ref  # (N, m)

    # affine residuals a_k = f(x_k, u_k) - x_{k+1} (zero on exact rollouts);
    # atil = a - B du absorbs the control offset (reference augmented.py:50)
    a = jax.vmap(system.step)(X[:-1], U) - X[1:]
    atil = a - jnp.einsum("knm,km->kn", B, du)

    Qe = e @ prob.Q.T  # (N, n)
    quad = jnp.einsum("ki,kj,ij->k", e, e, prob.Q)  # e'Qe per step
    corner = quad + 2.0 * prob.w + rho_reg

    Qblock = jnp.broadcast_to(sym(prob.Q) + q_reg * jnp.eye(n, dtype=dtype), (N, n, n))

    extra = extra_cost_terms(system, X[:-1], U)
    if extra is not None:
        c, cx, cxx = extra
        Qblock = Qblock + sym(cxx)
        Qe = Qe + cx
        corner = corner + 2.0 * c

    Q_aug = jnp.zeros((N, n + 1, n + 1), dtype=dtype)
    Q_aug = Q_aug.at[:, :n, :n].set(Qblock)
    Q_aug = Q_aug.at[:, :n, n].set(Qe)
    Q_aug = Q_aug.at[:, n, :n].set(Qe)
    Q_aug = Q_aug.at[:, n, n].set(corner)
    Q_aug = sym(Q_aug)

    A_aug = jnp.zeros((N, n + 1, n + 1), dtype=dtype)
    A_aug = A_aug.at[:, :n, :n].set(A)
    A_aug = A_aug.at[:, :n, n].set(atil)
    A_aug = A_aug.at[:, n, n].set(1.0)

    B_aug = jnp.zeros((N, n + 1, m), dtype=dtype)
    B_aug = B_aug.at[:, :n, :].set(B)

    R_inv = psd_inv(prob.R, levels=psd_levels)

    if not scale:
        s = jnp.ones((N + 1,), dtype=dtype)
        return AugmentedBlocks(A_aug=A_aug, B_aug=B_aug, Q_aug=Q_aug, R_inv=R_inv, s=s)

    # homogeneous similarity scaling (see homogeneous_scales):
    #   Q~_k = D_k^-1 Q_aug D_k^-1,  A~_k = D_{k+1} A_aug D_k^-1,
    #   B~_k = D_{k+1} B_aug = B_aug (last row is zero)
    # with D_k = diag(1..1, s_k). J(T) picks up the factor s_0^2.
    s = homogeneous_scales(prob, X)  # (N+1,)
    inv_s = 1.0 / s
    ones_n = jnp.ones((N, n), dtype=dtype)
    d_col = jnp.concatenate([ones_n, inv_s[:N, None]], axis=1)  # (N, p): D_k^-1
    d_row = jnp.concatenate([ones_n, s[1:, None]], axis=1)  # (N, p): D_{k+1}
    Q_aug = Q_aug * d_col[:, :, None] * d_col[:, None, :]
    A_aug = A_aug * d_row[:, :, None] * d_col[:, None, :]
    return AugmentedBlocks(A_aug=A_aug, B_aug=B_aug, Q_aug=Q_aug, R_inv=R_inv, s=s)


class FusedInputs(NamedTuple):
    """Raw per-step inputs of the default select route
    (solver/horizon.py propagator_select_fused). Everything here is
    (N, n)-sized or smaller; the (N, p, p) augmented blocks are assembled
    from it."""

    A: jax.Array  # (N, n, n)
    B: jax.Array  # (N, n, m)
    vecs: jax.Array  # (N, 4, n): [e_k, e_{k+1}, atil_k, Q e_k]
    scal: jax.Array  # (N, 4): [corner_k, 1/s_k, s_{k+1}, 1/s_{k+1}]
    Qq: jax.Array  # (n, n) = sym(Q) + q_reg I
    R_inv: jax.Array  # (m, m)
    Lt: jax.Array  # (n, n) = chol(Qf + rho I)' (upper)
    s: jax.Array  # (N+1,) homogeneous scales (J carries s_0^2)


@full_matmul_precision
def build_fused_inputs(
    system: System,
    prob: Problem,
    X: jax.Array,
    U: jax.Array,
    A: jax.Array,
    B: jax.Array,
    *,
    q_reg: float = 1e-9,
    rho_reg: float = 1e-12,
    psd_levels: int = 2,
    scale: bool = True,
) -> FusedInputs:
    """Same arithmetic as build_augmented + build_terminal_factors, stopping
    at the raw ingredients (requires system.extra_cost is None — extra stage
    costs make the Q block step-dependent and take the assembled path)."""
    assert system.extra_cost is None
    N, n = U.shape[0], prob.n
    dtype = X.dtype

    e = wrap_error(X[:-1] - prob.xg, prob.wrap_mask)  # (N, n)
    en = wrap_error(X[1:] - prob.xg, prob.wrap_mask)  # (N, n)
    du = U - prob.u_ref
    a = jax.vmap(system.step)(X[:-1], U) - X[1:]
    atil = a - jnp.einsum("knm,km->kn", B, du)
    Qe = e @ prob.Q.T
    corner = jnp.einsum("ki,kj,ij->k", e, e, prob.Q) + 2.0 * prob.w + rho_reg

    Qq = sym(prob.Q) + q_reg * jnp.eye(n, dtype=dtype)
    R_inv = psd_inv(prob.R, levels=psd_levels)
    P = sym(prob.Qf) + rho_reg * jnp.eye(n, dtype=dtype)
    Lt = jnp.swapaxes(chol_lower(P), -1, -2)

    if scale:
        s = homogeneous_scales(prob, X)
    else:
        s = jnp.ones((N + 1,), dtype=dtype)
    scal = jnp.stack([corner, 1.0 / s[:N], s[1:], 1.0 / s[1:]], axis=1)
    vecs = jnp.stack([e, en, atil, Qe], axis=1)  # (N, 4, n)
    return FusedInputs(A=A, B=B, vecs=vecs, scal=scal, Qq=Qq, R_inv=R_inv, Lt=Lt, s=s)


@full_matmul_precision
def build_terminal_factors(
    prob: Problem, X: jax.Array, *, rho_reg: float = 1e-12, s: jax.Array = None
) -> jax.Array:
    """Factored terminal data for the exact (inverse-free) propagator query.

    The homogeneous terminal block QT_t = [I e_t]' P [I e_t] is rank-n —
    *singular by construction* — which is why the reference regularizes it
    and inverts anyway (reference augmented.py:63-87 +
    horizon_selection.py:79-81), paying an O(1e-4) consistency error
    (see plots/summary.csv `consistency_max_abs`). Here we return
    C_t = L' [I e_t] (n x (n+1), P + rho I = L L') so the query can use the
    push-through identity (QT^-1 + G)^-1 = C'(I + C G C')^-1 C — no singular
    inversion, exact to machine precision.
    """
    n = prob.n
    P = sym(prob.Qf) + rho_reg * jnp.eye(n, dtype=X.dtype)
    Lt = jnp.swapaxes(chol_lower(P), -1, -2)  # (n, n) upper = L'
    e = wrap_error(X[1:] - prob.xg, prob.wrap_mask)  # (N, n)
    Le = e @ Lt.T  # (N, n) = L' e_t
    N = e.shape[0]
    C = jnp.concatenate([jnp.broadcast_to(Lt, (N, n, n)), Le[..., None]], axis=-1)
    if s is not None:
        # homogeneous scaling: C~_t = C_t D_t^-1 (last column / s_t)
        C = C.at[:, :, n].multiply(1.0 / s[1:, None])
    return C  # (N, n, n+1)


@full_matmul_precision
def build_terminal_blocks(
    prob: Problem, X: jax.Array, *, rho_reg: float = 1e-12, s: jax.Array = None
) -> jax.Array:
    """Terminal (n+1)^2 block per candidate arrival step t = 1..N.

    QT[t-1] = [[P, P e_t], [e_t' P, e_t' P e_t + rho]] with P = Qf
    (reference augmented.py:63-87).
    """
    n = prob.n
    dtype = X.dtype
    P = sym(prob.Qf)
    e = wrap_error(X[1:] - prob.xg, prob.wrap_mask)  # (N, n), arrival steps 1..N
    px = e @ P.T  # (N, n)
    p0 = jnp.einsum("ki,kj,ij->k", e, e, P)  # e'Pe  (= 2 * 0.5 e'Pe)

    N = e.shape[0]
    QT = jnp.zeros((N, n + 1, n + 1), dtype=dtype)
    QT = QT.at[:, :n, :n].set(jnp.broadcast_to(P, (N, n, n)))
    QT = QT.at[:, :n, n].set(px)
    QT = QT.at[:, n, :n].set(px)
    QT = QT.at[:, n, n].set(p0 + rho_reg)
    if s is not None:
        inv_s = 1.0 / s[1:]
        d = jnp.concatenate([jnp.ones((N, n), dtype=dtype), inv_s[:, None]], axis=1)
        QT = QT * d[:, :, None] * d[:, None, :]
    return sym(QT)
