"""Pure df32 LFT math on lanes-layout arrays.

Used by the XLA associative select (`solver/select_assoc.py`): TIME on the
trailing axis, prefix composition as a Hillis-Steele tree of depth
ceil(log2 N) — a single solve parallelizes over its own horizon.

All functions take/return df32 values — (hi, lo) pairs of f32 arrays in
(rows, cols, lanes) layout — and are pure jnp (see ops/df32.py for why
plain f32 is numerically insufficient for this recursion).

Reference semantics: the per-step element and the prefix composition are
the information-form LFT maps of reference horizon_selection.py:57-75;
the factored terminal query is the exact inverse-free re-derivation of
reference horizon_selection.py:78-85 (see
solver/horizon.py:propagator_J_curve_factored).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from timeopt.ops import df32 as dfm


def eye_lanes(p: int, b, dtype) -> jax.Array:
    """(p, p) + batch-shape identity broadcast over the trailing batch axes.

    `b` is an int (trailing (b,)) or a shape tuple (several trailing batch
    axes)."""
    bshape = (b,) if isinstance(b, int) else tuple(b)
    shape = (p, p) + bshape
    rows = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return (rows == cols).astype(dtype)


def _mirror_lower(M):
    """Exactly-symmetric copy of a (p, p, *b) f32 array from its lower
    triangle (pure wiring; the upper-triangle entries of row-sum products
    round asymmetrically)."""
    p = M.shape[0]
    return jnp.stack(
        [
            jnp.concatenate(
                [M[i, : i + 1]] + [M[j, i : i + 1] for j in range(i + 1, p)],
                axis=0,
            )
            for i in range(p)
        ],
        axis=0,
    )


def df_lft_element_ldl(Ak, Qk, BRBk, *, jitter: float, trisym: bool = False):
    """LFT element from augmented blocks, arbitrary (k-varying) Q_aug.

    Ak, Qk, BRBk: f32 (p, p, b). Returns df32 (E, F, G) with
      E = (Q + jitter I)^-1,  F = E A',  G = A E A' + BRB
    via an unpivoted LDL' of Q (every inverse acts on an SPD matrix, so its
    action is a unit-lower trisolve + pivot scaling).

    trisym=True (no solver route sets it; see ops/df32.py): the A Q^-1 A'
    congruence computes only its lower triangle and mirrors; BRB and the
    trisolve-produced E are mirrored from their lower triangles instead of
    sym_half-averaged — exactly symmetric G/E with fewer flops.
    """
    p = Ak.shape[0]
    eye_p = eye_lanes(p, Ak.shape[2:], Ak.dtype)

    Lq, _, idq = dfm.df_ldl(dfm.df_mat(Qk), jitter, eye_p)
    # merged RHS [A' | I]: one L-chain walk at double slab width
    Z = dfm.df_trisolve_unit_lower_rows(
        Lq,
        dfm.df_rows_concat(dfm.df_rows_bt(dfm.df_mat(Ak)), dfm.df_rows(dfm.df_mat(eye_p))),
    )  # (p, 2p, b) = [L^-1 A' | L^-1]
    Zs = dfm.df_scale_rows(Z, idq)
    Z0 = (Z[0][:, :p], Z[1][:, :p])
    Z0s = (Zs[0][:, :p], Zs[1][:, :p])
    if trisym:
        G = dfm.df_add(
            dfm.df_matmul_tn_trisym(Z0, Z0s), dfm.df_mat(_mirror_lower(BRBk))
        )  # A Q^-1 A' + BRB
    else:
        G = dfm.df_sym_half(
            dfm.df_add(dfm.df_matmul_tn(Z0, Z0s), dfm.df_mat(BRBk))
        )  # A Q^-1 A' + BRB
    FE = dfm.df_trisolve_unit_lower_t(Lq, Zs)  # [E A' | E]
    F = (FE[0][:, :p], FE[1][:, :p])
    if trisym:
        Eh, El = FE[0][:, p:], FE[1][:, p:]
        E = (_mirror_lower(Eh), _mirror_lower(El))
    else:
        E = dfm.df_sym_half((FE[0][:, p:], FE[1][:, p:]))
    return E, F, G


def df_lft_compose(first, second, *, jitter: float, trisym: bool = False):
    """Associative composition of df32 LFT triples (first, then second):

        W = (E2 + G1 + jitter I)^-1
        E = E1 - F1 W F1',  F = F1 W F2,  G = G2 - F2' W F2

    (reference prefix recursion, reference horizon_selection.py:67-75).
    W is never formed: quadratic/bilinear forms reduce to forward trisolves
    against the LDL' factor of (E2 + G1) plus pivot row-scaling.

    trisym=True computes the two symmetric congruence products from their
    lower triangles (df32.df_matmul_tn_trisym — exactly symmetric, no
    sym_half averaging pass, ~46% fewer product flops); dense-tile kernels
    only (see the layout note in ops/df32.py).
    """
    E1, F1, G1 = first
    E2, F2, G2 = second
    p = E1[0].shape[0]
    eye_p = eye_lanes(p, E1[0].shape[2:], E1[0].dtype)

    #   Ē - F̄ W F̄' = Ē - U' Dw^-1 U,   U = Lw^-1 F̄'
    #   F̄ W F_k    = U' Dw^-1 V,       V = Lw^-1 F_k
    #   G_k - F_k' W F_k = G_k - V' Dw^-1 V
    Lw, _, idw = dfm.df_ldl(dfm.df_add(E2, G1), jitter, eye_p)
    # merged RHS [F̄' | F_k]: U = Lw^-1 F̄', V = Lw^-1 F_k in one walk
    UV = dfm.df_trisolve_unit_lower_rows(
        Lw, dfm.df_rows_concat(dfm.df_rows_bt(F1), dfm.df_rows(F2))
    )
    UVs = dfm.df_scale_rows(UV, idw)
    U2 = (UV[0][:, :p], UV[1][:, :p])
    U2s = (UVs[0][:, :p], UVs[1][:, :p])
    V2 = (UV[0][:, p:], UV[1][:, p:])
    V2s = (UVs[0][:, p:], UVs[1][:, p:])
    F = dfm.df_matmul_tn(U2s, V2)
    if trisym:
        E = dfm.df_sub(E1, dfm.df_matmul_tn_trisym(U2, U2s))
        G = dfm.df_sub(G2, dfm.df_matmul_tn_trisym(V2, V2s))
    else:
        E = dfm.df_sym_half(dfm.df_sub(E1, dfm.df_matmul_tn(U2, U2s)))
        G = dfm.df_sym_half(dfm.df_sub(G2, dfm.df_matmul_tn(V2, V2s)))
    return E, F, G


def df_lft_query_lastpivot(X0, *, jitter: float):
    """J = 0.5 (X0^-1)[p-1, p-1] = 0.5 / d_p — the last pivot of the
    unpivoted LDL' of (X0 + jitter I), reciprocal already computed.
    Returns f32 with the trailing batch shape (X0[0].shape[2:])."""
    p = X0[0].shape[0]
    eye_p = eye_lanes(p, X0[0].shape[2:], X0[0].dtype)
    _, _, idx0 = dfm.df_ldl(X0, jitter, eye_p)
    return 0.5 * (idx0[0][p - 1, 0] + idx0[1][p - 1, 0])


def df_lft_query_factored(prefix, Cdf, *, jitter: float, trisym: bool = False):
    """Factored terminal query in the generic C-form (C the (n, p, b)
    terminal factor): S = I + C G C', X0 = E - FC' S^-1 CF',
    J = 0.5 (X0^-1)[p-1, p-1]. Returns f32 (b,).

    trisym=True (no solver route sets it): the C G C' and Vq' D^-1 Vq
    congruences compute lower triangles only and mirror (requires G
    symmetric, which the trisym compose/element guarantee)."""
    Ep, Fp, Gp = prefix
    n = Cdf[0].shape[0]
    eye_n = eye_lanes(n, Ep[0].shape[2:], Ep[0].dtype)

    CG = dfm.df_matmul(Cdf, Gp)  # (n, p)
    if trisym:
        S = dfm.df_add(dfm.df_mat(eye_n), dfm.df_matmul_nt_trisym(CG, Cdf))
    else:
        S = dfm.df_add(dfm.df_mat(eye_n), dfm.df_matmul_nt(CG, Cdf))
    Lsq, _, idsq = dfm.df_ldl(S, 0.0, eye_n)
    FCt = dfm.df_matmul_nt(Fp, Cdf)  # (p, n)
    # X0 = Ep - FCt S^-1 FCt' = Ep - Vq' Dsq^-1 Vq,  Vq = Lsq^-1 FCt'
    Vq = dfm.df_trisolve_unit_lower_bt(Lsq, FCt)
    Vqs = dfm.df_scale_rows(Vq, idsq)
    if trisym:
        X0 = dfm.df_sub(Ep, dfm.df_matmul_tn_trisym(Vq, Vqs))
    else:
        X0 = dfm.df_sym_half(dfm.df_sub(Ep, dfm.df_matmul_tn(Vq, Vqs)))
    return df_lft_query_lastpivot(X0, jitter=jitter)
