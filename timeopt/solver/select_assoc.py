"""df32 propagator select: associative prefix scan with TIME on the
trailing (lane) axis.

The default select walks the N time steps sequentially, one problem per
batch lane. This module parallelizes a single solve over its own horizon
instead:

- the per-step LFT elements (E, F, G) are built for ALL time steps at once
  in (p, p, N) layout (N on the trailing axis);
- the prefix composition — associative, reference
  horizon_selection.py:67-75 composes linear-fractional maps
  (associativity property-tested in tests/test_propagator.py) — runs as a
  Hillis-Steele inclusive scan: ceil(log2 N) rounds, each one rotated df32
  compose over all N steps (O(N log N) work instead of O(N), but depth
  log N instead of N);
- all N terminal queries evaluate in one parallel shot.

Everything is double-single (df32) arithmetic from ops/lft_df.py (plain f32
corrupts the J(T) argmin; see ops/df32.py). Pure XLA: under jit and vmap (a
batch axis simply leads the layout), and in f64 (double-double) for CPU
oracle tests.

PRECISION CAVEAT: XLA's *CPU* backend degrades compiled df32 — LLVM FP
contraction substitutes an exact FMA product for the rounded product
Dekker's two_prod depends on whenever the multiply is rematerialized into a
consumer fusion (measured: df_matmul 2e-14 eager vs 5e-8 jitted;
--xla_backend_optimization_level=0 restores exactness, no narrower flag
does). So on CPU this path delivers ~f32-quality selection for f32 inputs
(use select_dtype="float64" there) and ~f64-quality for f64 inputs
(double-double collapses to plain f64). XLA-GPU may contract mul+add into
FMA as well; its df32 accuracy is whatever the oracle comparison measures.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from timeopt.ops import df32 as dfm
from timeopt.ops.lft_df import (
    df_lft_compose,
    df_lft_element_ldl,
    df_lft_query_factored,
)


def lft_elements_lanes_df(A_aug, B_aug, Q_aug, R_inv, *, jitter: float = 1e-9):
    """df32 LFT elements for all steps, time on lanes.

    A_aug, Q_aug: (N, p, p); B_aug: (N, p, m); R_inv: (m, m).
    Returns df32 (E, F, G) triples in (p, p, N) lanes layout."""
    BRB = jnp.einsum("nim,mo,njo->nij", B_aug, R_inv, B_aug)
    At = jnp.transpose(A_aug, (1, 2, 0))
    Qt = jnp.transpose(Q_aug, (1, 2, 0))
    BRBt = jnp.transpose(BRB, (1, 2, 0))
    return df_lft_element_ldl(At, Qt, BRBt, jitter=jitter)


def lft_prefix_scan_assoc_df(elems, *, jitter: float = 1e-9):
    """Hillis-Steele inclusive prefix scan of df32 LFT triples over lanes.

    elems: df32 (E, F, G), each a (hi, lo) pair of (p, p, N) arrays with
    time on the last (lane) axis. Round d composes each lane with the lane
    2^d to its left: after all ceil(log2 N) rounds, lane k holds
    elem_0 ∘ ... ∘ elem_k. Lanes with no left partner keep their value via
    masking (the compose monoid has no finite identity element in the
    (E, F, G) parametrization — its identity is a limit point — so masking
    replaces the usual identity padding). Rolled-around operand lanes are
    finite garbage, composed then discarded by the mask; they cannot poison
    selected lanes."""
    N = elems[0][0].shape[-1]
    idx = jax.lax.broadcasted_iota(jnp.int32, (1, 1, N), 2)
    n_rounds = max(1, (N - 1).bit_length())  # ceil(log2 N)

    def round_body(pre, s):
        # s is traced (jnp.roll lowers a traced shift to dynamic slices), so
        # the compose body is traced/compiled ONCE for all log2(N) rounds —
        # unrolling it made the XLA graph ~log2(N)x larger and blew compile
        # time past 30 min for the full solve program.
        shifted = tuple(
            (jnp.roll(h, s, axis=-1), jnp.roll(l, s, axis=-1)) for h, l in pre
        )
        comp = df_lft_compose(shifted, pre, jitter=jitter)
        mask = idx >= s
        out = tuple(
            (jnp.where(mask, ch, h), jnp.where(mask, cl, l))
            for (ch, cl), (h, l) in zip(comp, pre)
        )
        return out, None

    shifts = jnp.asarray([1 << d for d in range(n_rounds)], jnp.int32)
    pre, _ = jax.lax.scan(round_body, tuple(elems), shifts)
    return pre


def propagator_select_assoc_df(
    A_aug: jax.Array,
    B_aug: jax.Array,
    Q_aug: jax.Array,
    R_inv: jax.Array,
    C: jax.Array,
    *,
    jitter: float = 1e-9,
    t_min: int = 1,
) -> jax.Array:
    """Whole propagator selection for ONE problem, time on lanes.

    A_aug, Q_aug: (N, p, p); B_aug: (N, p, m); R_inv: (m, m); C: (N, n, p)
    (factored terminal, build_terminal_factors). Returns J: (N,) with +inf
    below t_min. Same semantics as the sequential select at Hillis-Steele
    depth.
    vmap adds a leading batch axis and everything broadcasts."""
    elems = lft_elements_lanes_df(A_aug, B_aug, Q_aug, R_inv, jitter=jitter)
    prefix = lft_prefix_scan_assoc_df(elems, jitter=jitter)
    Cdf = dfm.df_mat(jnp.transpose(C, (1, 2, 0)))  # (n, p, N)
    J = df_lft_query_factored(prefix, Cdf, jitter=jitter)  # (N,)
    N = J.shape[-1]
    Ts = jnp.arange(1, N + 1)
    return jnp.where(Ts >= t_min, J, jnp.asarray(jnp.inf, J.dtype))
