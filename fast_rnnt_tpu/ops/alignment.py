"""Viterbi (best-path) scoring and forced alignment on the RNN-T lattice.

An extension with no reference equivalent: the same first-order
row recurrence as the mutual-information forward (ops/recursion.py), but in
the (max, +) tropical semiring instead of (logaddexp, +):

    v[b, s, t] = max(v[b, s-1, t(-1)] + px[b, s-1, t(-1)],
                     v[b, s, t-1]     + py[b, s, t-1])

The per-row recurrence is solved with the SAME associative-scan shape
(max-plus linear recurrences compose associatively), so everything stays
S+1 vectorized steps under jit.

The alignment falls out of autodiff: differentiating max() selects the
argmax branch, so the VJP of ``viterbi_scores`` w.r.t. (px, py) is exactly
the 0/1 indicator of the best path's arcs — no backtracking pass, no
sequential argmax chain.  ``viterbi_alignment`` converts the px indicator
into per-symbol emission frames (forced alignment).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .numerics import NEG_INF
from .recursion import _apply_boundary_mask, _normalize_boundary

__all__ = ["viterbi_scores", "viterbi_alignment"]


def _max_linear_scan(coeff: jax.Array, bias: jax.Array) -> jax.Array:
    """Solve x_t = max(coeff_t + x_{t-1}, bias_t), x_{-1} = -inf, along the
    last axis (tropical-semiring analog of numerics.log_linear_scan)."""

    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 + a2, jnp.maximum(b1 + a2, b2)

    _, x = jax.lax.associative_scan(combine, (coeff, bias), axis=-1)
    return x


def viterbi_scores(
    px: jax.Array,
    py: jax.Array,
    boundary: Optional[jax.Array] = None,
) -> jax.Array:
    """Best single-path score through the lattice (tropical-semiring analog
    of ``mutual_information_recursion``; same px/py/boundary contract).

    Differentiable: the gradient w.r.t. (px, py) is the 0/1 best-path
    indicator (autodiff through max selects the argmax branch).
    """
    B, S, T1 = px.shape
    T = py.shape[2]
    modified = T1 == T
    boundary = _normalize_boundary(boundary, B, S, T)
    px_m, py_m = _apply_boundary_mask(px, py, boundary, modified)

    px_t = jnp.moveaxis(px_m, 1, 0)  # (S, B, T1)
    py_t = jnp.moveaxis(py_m, 1, 0)  # (S+1, B, T)
    pad_row = jax.lax.full_like(px_t, NEG_INF, shape=(1, B, T1))
    px_pad = jnp.concatenate([pad_row, px_t], axis=0)  # (S+1, B, T1)

    sb = boundary[:, 0]
    tb = boundary[:, 1]
    se = boundary[:, 2]
    te = boundary[:, 3]
    t_iota = jax.lax.broadcasted_iota(jnp.int32, (B, T + 1), 1)
    source_t = t_iota == tb[:, None]
    end_t = t_iota == te[:, None]
    s_idx = jnp.arange(S + 1, dtype=jnp.int32)

    def step(carry, xs):
        prev_v, best = carry
        s, px_row, py_row = xs
        if modified:
            a = prev_v[:, :T] + px_row
            a = jnp.pad(a, ((0, 0), (1, 0)), constant_values=NEG_INF)
        else:
            a = prev_v + px_row
        src = jnp.where((s == sb)[:, None] & source_t, 0.0, NEG_INF).astype(a.dtype)
        b = jnp.maximum(a, src)
        coeff = jnp.pad(py_row, ((0, 0), (1, 0)), constant_values=NEG_INF)
        v_row = _max_linear_scan(coeff, b)
        # harvest v[s_end, t_end] when this row is the end row
        val = jnp.max(jnp.where(end_t, v_row, NEG_INF), axis=1)
        best = jnp.where(s == se, val, best)
        return (v_row, best), None

    init_v = jax.lax.full_like(py_t, NEG_INF, shape=(B, T + 1))
    # full_like so the carry's varying-mesh-axes match under shard_map
    init_best = jax.lax.full_like(py_t, NEG_INF, shape=(B,))
    (_, best), _ = jax.lax.scan(step, (init_v, init_best), (s_idx, px_pad, py_t))
    return best


def viterbi_alignment(
    px: jax.Array,
    py: jax.Array,
    boundary: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Forced alignment: per-symbol emission frames of the best path.

    One forward + one VJP pass (no backtracking loop).  Returns
    (scores, emit_frames, px_indicator):
      scores [B]: best-path scores (== viterbi_scores).
      emit_frames int32 [B, S]: frame index at which symbol s is emitted on
        the best path (-1 for symbols outside the utterance's boundary).
      px_indicator [B, S, T']: the 0/1 best-path symbol-arc indicator
        (the gradient of the scores w.r.t. px).
    """
    scores, vjp = jax.vjp(
        lambda px, py: viterbi_scores(px, py, boundary), px, py
    )
    px_ind, _py_ind = vjp(jnp.ones_like(scores))
    t_iota = jax.lax.broadcasted_iota(jnp.int32, px_ind.shape, 2)
    emitted = jnp.sum(px_ind, axis=2) > 0.5  # (B, S)
    emit_frames = jnp.where(
        emitted,
        jnp.sum(px_ind * t_iota, axis=2).astype(jnp.int32),
        -1,
    )
    return scores, emit_frames, px_ind
