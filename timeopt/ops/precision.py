"""Full-precision dot products for f32 solves.

At DEFAULT precision XLA may run an f32 `dot_general` (einsum, @, matmul)
on reduced-precision matrix units: TF32 on an NVIDIA GPU keeps ~10
mantissa bits (rel error ~1e-3). That noise class matters here: a stage
cost einsum `0.5 e'Qe` off by ~1e-3 relative on far-from-goal states
(e ~ 2) perturbs the f32 path's costs, backward-pass inputs (lx, lu) and
augmented-block assembly (Q e, e'Qe corners), and shows up as an O(0.5)
J(T) curve error on iterate-0 nominals whose tracking error is large.

The df_matmul helpers are unaffected (elementwise multiply-adds, no
dot_general). What needs forcing is every TRAJECTORY-WIDE dot on the f32
path, including dots produced by AD (jacfwd of the dynamics), which cannot
be annotated at the call site — hence a dynamic-context decorator rather
than per-einsum `precision=` arguments.

`jax.default_matmul_precision("float32")` is trace-time scoped: applying
it to the function body covers every dot traced within, and is a no-op for
f64 dots, so the committed f64 artifacts are unchanged.
"""

from __future__ import annotations

import functools

import jax


def full_matmul_precision(fn):
    """Trace `fn` with float32 (HIGHEST) default matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
