"""Pruning-bound computation and am/lm pruning gathers.

Equivalent to the pruning pipeline of the reference
(/root/reference/tf_fast_rnnt/python/tf_fast_rnnt/rnnt_loss.py):

  _monotonic_lower_bound        rnnt_loss.py:553-585  -> ops/recursion.py
  _adjust_pruning_lower_bound   rnnt_loss.py:587-641
  get_rnnt_prune_ranges         rnnt_loss.py:647-761  (paper §3.2 bounds)
  do_rnnt_pruning               rnnt_loss.py:763-812

The reference needed a custom CUDA Blelloch scan for the running min; here
that is ``lax.cummin`` (see ops/recursion.py:monotonic_lower_bound for why
not an associative scan), so this whole module is pure XLA.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .lattice import matmul_precision
from .recursion import monotonic_lower_bound

__all__ = [
    "adjust_pruning_lower_bound",
    "get_rnnt_prune_ranges",
    "get_rnnt_prune_ranges_rows",
    "do_rnnt_pruning",
]


def adjust_pruning_lower_bound(s_begin: jax.Array, s_range: int) -> jax.Array:
    """Make the per-frame pruning lower bounds valid:

      * monotone non-decreasing,
      * starting at symbol 0,
      * stepping by < s_range between consecutive frames.

    Uses the reference's "magic transform" (proof in rnnt_loss.py:604-621):
    ``s' = -(s_begin - (s_range-1) * t)`` is monotone-bounded, clipped at 0,
    then transformed back.
    """
    B, T = s_begin.shape
    t_ramp = (s_range - 1) * jnp.arange(T, dtype=jnp.int32)
    s_begin = monotonic_lower_bound(s_begin.astype(jnp.int32))
    s_begin = -(s_begin - t_ramp)
    s_begin = monotonic_lower_bound(s_begin)
    s_begin = jnp.maximum(s_begin, 0)
    s_begin = -(s_begin - t_ramp)
    return s_begin


def get_rnnt_prune_ranges(
    px_grad: jax.Array,
    py_grad: jax.Array,
    boundary: jax.Array,
    s_range: int,
) -> jax.Array:
    """Per-frame symbol windows [B, T, s_range] from occupancy gradients.

    For each frame t, picks the window start maximizing the summed blank
    occupancy of the window minus the symbol occupancy of entering it
    (Pruned RNN-T paper §3.2; reference rnnt_loss.py:647-761), then repairs
    the starts to be monotone / step-bounded / 0-based.

    ``s_range`` must be a static Python int (it determines output shape).
    """
    return get_rnnt_prune_ranges_rows(
        jnp.moveaxis(px_grad, 1, 0),
        jnp.moveaxis(py_grad, 1, 0),
        boundary,
        s_range,
    )


def get_rnnt_prune_ranges_rows(
    px_grad_rows: jax.Array,
    py_grad_rows: jax.Array,
    boundary: jax.Array,
    s_range: int,
) -> jax.Array:
    """s-major variant of :func:`get_rnnt_prune_ranges` — consumes the
    (S, B, T)-major occupancies the fused pipeline's recursion emits, so
    no transpose sits between the two stages."""
    S, B, T1 = px_grad_rows.shape
    T = py_grad_rows.shape[-1]
    S1 = S + 1
    if not isinstance(s_range, int):
        raise TypeError("s_range must be a static Python int")
    # s_range > S would index past the last symbol window (rnnt_loss.py:710)
    if s_range > S:
        s_range = S + 1
    if T1 == T and s_range < 1:
        raise ValueError("modified/constrained RNN-T needs s_range >= 1")
    if T1 == T + 1 and s_range < 2:
        raise ValueError("regular RNN-T needs s_range >= 2")

    adjust_step = 2 if T1 == T else s_range
    s_begin = _window_argmax(px_grad_rows, py_grad_rows, s_range)  # (B, T)

    # Frames at/after each utterance's last real frame get the final window
    # start S - s_range + 1 (clipped at 0), so the last symbol is reachable
    # on the last frame (rnnt_loss.py:731-748).
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (B, T), 1)
    mask = t_idx < (boundary[:, 3][:, None].astype(jnp.int32) - 1)
    s_begin_padding = jnp.maximum(
        boundary[:, 2][:, None].astype(jnp.int32) - s_range + 1, 0
    )
    s_begin = jnp.where(mask, s_begin, s_begin_padding)

    # Step bound: modified/constrained emit at most one symbol per frame, so
    # consecutive starts may differ by at most 1 (rnnt_loss.py:750-756).
    s_begin = adjust_pruning_lower_bound(s_begin, adjust_step)

    return s_begin[:, :, None] + jnp.arange(s_range, dtype=jnp.int32)


def _window_argmax(
    px_grad_rows: jax.Array,
    py_grad_rows: jax.Array,
    s_range: int,
) -> jax.Array:
    """argmax_k of (window-sum of py_grad - px_grad entry) per frame
    (rnnt_loss.py:722-729): padded cumsum + argmax.

    The result is integer window starts — non-differentiable by
    construction — so tangents are stopped at the inputs."""
    px_grad_rows = jax.lax.stop_gradient(px_grad_rows)
    py_grad_rows = jax.lax.stop_gradient(py_grad_rows)

    S1, B, T = py_grad_rows.shape
    T1 = px_grad_rows.shape[2]
    if s_range == 1:
        # width-1 window: exact row values (the cumsum difference below
        # carries ~1e-7*S float drift that flips near-tie argmaxes)
        blk_sum_grad = py_grad_rows.astype(jnp.float32)
    else:
        cumsum = jnp.cumsum(
            py_grad_rows.astype(jnp.float32), axis=0
        )  # (S1, B, T)
        cumsum = jnp.concatenate(
            [jnp.zeros((1, B, T), jnp.float32), cumsum], axis=0
        )  # (S1+1, B, T)
        blk_sum_grad = cumsum[s_range:] - cumsum[: S1 - s_range + 1]
    px_grad_pad = jnp.concatenate(
        [jnp.zeros((1, B, T1), dtype=px_grad_rows.dtype), px_grad_rows], axis=0
    )  # (S1, B, T1)
    final_grad = blk_sum_grad - px_grad_pad[: S1 - s_range + 1, :, :T]
    return jnp.argmax(final_grad, axis=0).astype(jnp.int32)  # (B, T)


def do_rnnt_pruning(
    am: jax.Array, lm: jax.Array, ranges: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Prune encoder/predictor outputs to the per-frame symbol windows.

    Returns (am_pruned, lm_pruned), both [B, T, s_range, C]
    (equivalent to rnnt_loss.py:763-812).
    """
    B, T, s_range = ranges.shape
    S1, C = lm.shape[1], lm.shape[2]
    am_pruned = jnp.broadcast_to(am[:, :, None, :], (B, T, s_range, C))
    # lm_pruned[b, t, k, :] = lm[b, ranges[b, t, k], :], formulated as a
    # one-hot matmul instead of a per-row gather.
    onehot = (
        ranges[:, :, :, None] == jnp.arange(S1, dtype=ranges.dtype)
    ).astype(lm.dtype)  # (B, T, K, S1)
    lm_pruned = jnp.einsum(
        "btks,bsc->btkc", onehot, lm, preferred_element_type=jnp.float32,
        precision=matmul_precision(),
    )
    return am_pruned, lm_pruned
