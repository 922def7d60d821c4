"""(px, py) lattice construction for the RNN-T recursion.

JAX re-implementation of the lattice builders in
/root/reference/tf_fast_rnnt/python/tf_fast_rnnt/rnnt_loss.py:

  get_rnnt_logprobs           rnnt_loss.py:63-223    (simple/additive joiner)
  get_rnnt_logprobs_joint     rnnt_loss.py:340-452   (full joiner output)
  get_rnnt_logprobs_pruned    rnnt_loss.py:853-1020  (pruned joiner output)
  get_rnnt_logprobs_smoothed  rnnt_loss.py:1132-1367 (lm/am interpolated)
  fix_for_boundary            rnnt_loss.py:29-61

Shape/semantic contract is identical to the reference; the implementations
are pure jnp (symbol gathers as one-hot einsums, the normalizer as one
batched matmul) so they fuse under jit and shard under pjit.  Known
reference bugs fixed (each noted inline): the `modified` normalizer-width
mismatches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .numerics import NEG_INF

__all__ = [
    "band_mask_rows",
    "band_mask_rows_smajor",
    "fix_for_boundary",
    "get_rnnt_logprobs",
    "get_rnnt_logprobs_joint",
    "get_rnnt_logprobs_rows",
    "get_rnnt_logprobs_pruned",
    "get_rnnt_logprobs_pruned_simple",
    "get_rnnt_logprobs_smoothed",
    "get_rnnt_logprobs_smoothed_rows",
    "matmul_precision",
    "roll_by_shifts",
    "scatter_window",
    "set_matmul_precision",
]

RNNT_TYPES = ("regular", "modified", "constrained")

# Guard for log(0) in the normalizer matmul.  The reference adds
# nextafter(0, 1) = 1.4e-45 (rnnt_loss.py:181), a float32 denormal that
# flush-to-zero modes drop, so we use the smallest *normal* float32 instead.
# Only distinguishable when the inner product underflows below 1e-38.
_TINY = float(np.finfo(np.float32).tiny)

# Precision of the lattice einsums (normalizer matmuls and one-hot
# gathers).  HIGHEST keeps float32 products in float32; on a GPU without
# it a float32 matmul may run in TF32 (about three decimal digits), which
# puts visible error on the normalizer logs next to the ~1e-3 float32 noise
# floor of the whole pipeline.  "high"/"default" trade that accuracy for
# tensor-core speed via set_matmul_precision.
_MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def set_matmul_precision(precision) -> None:
    """Set the precision for lattice einsums: "default" | "high" |
    "highest" (or a jax.lax.Precision).  Takes effect at next trace."""
    global _MATMUL_PRECISION
    _MATMUL_PRECISION = jax.lax.Precision(precision)


def matmul_precision() -> jax.lax.Precision:
    return _MATMUL_PRECISION


def _check_rnnt_type(rnnt_type: str) -> None:
    if rnnt_type not in RNNT_TYPES:
        raise ValueError(f"rnnt_type must be one of {RNNT_TYPES}, got {rnnt_type!r}")


def _symbol_onehot(symbols: jax.Array, C: int, dtype) -> jax.Array:
    """One-hot of the symbol ids, [B, S, C].  Gather-free building block:
    the one-hot einsums run as matmuls and transpose to matmuls in the
    backward (no scatter-add)."""
    return (
        symbols.astype(jnp.int32)[:, :, None] == jnp.arange(C, dtype=jnp.int32)
    ).astype(dtype)


def _gather_am_symbols(am: jax.Array, symbols: jax.Array) -> jax.Array:
    """px_am[b, s, t] = am[b, t, symbols[b, s]] as a one-hot einsum (its
    VJP is a matmul, not a scatter-add; PERF.md has the H100 comparison
    with a plain gather)."""
    onehot = _symbol_onehot(symbols, am.shape[2], am.dtype)  # [B, S, C]
    return jnp.einsum(
        "bsc,btc->bst", onehot, am, preferred_element_type=jnp.float32,
        precision=matmul_precision(),
    )


def _gather_lm_symbols(lm: jax.Array, symbols: jax.Array) -> jax.Array:
    """px_lm[b, s] = lm[b, s, symbols[b, s]] as a masked reduction."""
    S = symbols.shape[1]
    onehot = _symbol_onehot(symbols, lm.shape[2], lm.dtype)  # [B, S, C]
    return jnp.sum(lm[:, :S, :] * onehot, axis=2, keepdims=True)  # [B, S, 1]


def fix_for_boundary(px: jax.Array, boundary: Optional[jax.Array] = None) -> jax.Array:
    """Set ``px[b, :, boundary[b, 3]] = -inf`` (regular rnnt_type only).

    On the per-utterance one-past-the-last frame no symbol can be emitted;
    with no boundary the -inf column appended at t = T already encodes this.
    Equivalent to rnnt_loss.py:29-61 (scatter replaced by a vector compare,
    a masked where that fuses into its neighbours).
    """
    if boundary is None:
        return px
    T1 = px.shape[2]
    t = jax.lax.broadcasted_iota(jnp.int32, (1, 1, T1), 2)
    return jnp.where(t == boundary[:, 3][:, None, None], NEG_INF, px)


def get_rnnt_logprobs(
    lm: jax.Array,
    am: jax.Array,
    symbols: jax.Array,
    termination_symbol: int,
    rnnt_type: str = "regular",
    boundary: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Reduce the simple (additive-joiner) RNN-T problem to (px, py).

    Equivalent to rnnt_loss.py:63-223.  The key memory trick is preserved:
    the per-(s, t) normalizer is a single [S+1, C] x [C, T] matmul
    (rnnt_loss.py:175-186) instead of materializing [B, T, S+1, C] logits.

    Args:
      lm: [B, S+1, C] language-model logits.
      am: [B, T, C] acoustic-model logits.
      symbols: int [B, S].
      termination_symbol: blank id in [0, C).
      rnnt_type: "regular" | "modified" | "constrained".
      boundary: optional int [B, 4] rows [s_begin, t_begin, s_end, t_end].

    Returns:
      px: [B, S, T+1] ("regular") or [B, S, T] (otherwise); py: [B, S+1, T].
    """
    _check_rnnt_type(rnnt_type)
    B, T, C = am.shape
    S = lm.shape[1] - 1
    # stability shifts only: the normalizer is shift-invariant, so their
    # gradient contributions cancel exactly — stop_gradient skips the
    # max-VJP scatter pass over the [B, T, C] tensor (~10% of step time)
    am_max = jax.lax.stop_gradient(jnp.max(am, axis=2, keepdims=True))
    lm_max = jax.lax.stop_gradient(jnp.max(lm, axis=2, keepdims=True))
    am_probs = jnp.exp(am - am_max)
    lm_probs = jnp.exp(lm - lm_max)
    normalizers = jnp.log(
        jnp.einsum(
            "bsc,btc->bst", lm_probs, am_probs, preferred_element_type=jnp.float32,
        precision=matmul_precision(),
        )
        + _TINY
    )
    normalizers = normalizers + lm_max + jnp.swapaxes(am_max, 1, 2)  # [B, S+1, T]

    px_am = _gather_am_symbols(am, symbols)  # [B, S, T]
    if rnnt_type == "regular":
        px_am = jnp.concatenate(
            [px_am, jnp.full((B, S, 1), NEG_INF, dtype=px_am.dtype)], axis=2
        )  # [B, S, T+1]
    px_lm = _gather_lm_symbols(lm, symbols)  # [B, S, 1]
    px = px_am + px_lm
    px = px - _pad_normalizers(normalizers, rnnt_type)[:, :S, :]

    py_am = am[:, :, termination_symbol][:, None, :]  # [B, 1, T]
    py_lm = lm[:, :, termination_symbol][:, :, None]  # [B, S+1, 1]
    py = py_am + py_lm - normalizers

    if rnnt_type == "regular":
        px = fix_for_boundary(px, boundary)
    elif rnnt_type == "constrained":
        px = px + py[:, 1:, :]
    return px, py


def get_rnnt_logprobs_rows(
    lm: jax.Array,
    am: jax.Array,
    symbols: jax.Array,
    termination_symbol: int,
    rnnt_type: str = "regular",
    boundary: Optional[jax.Array] = None,
    out_dtype=None,
) -> Tuple[jax.Array, jax.Array]:
    """s-major variant of :func:`get_rnnt_logprobs`: returns
    ``px_rows`` [S, B, T(+1)] and ``py_rows`` [S+1, B, T].

    The fused pipelines and the recursion consume rows in exactly this
    layout, so building it directly (einsums emit "sbt") removes a
    transpose pass between the lattice build and every recursion call.
    Numerically identical to ``moveaxis(get_rnnt_logprobs(...), 1, 0)``.

    ``out_dtype`` (optional) casts the returned lattice (the bf16
    mixed-precision storage mode).
    """
    _check_rnnt_type(rnnt_type)
    B, T, C = am.shape
    S = lm.shape[1] - 1
    # stability shifts only: gradient contributions cancel exactly (see
    # get_rnnt_logprobs)
    am_max = jax.lax.stop_gradient(jnp.max(am, axis=2, keepdims=True))
    lm_max = jax.lax.stop_gradient(jnp.max(lm, axis=2, keepdims=True))
    am_probs = jnp.exp(am - am_max)
    lm_probs = jnp.exp(lm - lm_max)
    normalizers = jnp.log(
        jnp.einsum(
            "bsc,btc->sbt", lm_probs, am_probs,
            preferred_element_type=jnp.float32,
            precision=matmul_precision(),
        )
        + _TINY
    )  # (S+1, B, T)
    normalizers = (
        normalizers
        + jnp.moveaxis(lm_max, 0, 1)          # (S+1, B, 1)
        + jnp.transpose(am_max, (2, 0, 1))    # (1, B, T)
    )

    onehot = _symbol_onehot(symbols, C, am.dtype)  # [B, S, C]
    px_am = jnp.einsum(
        "bsc,btc->sbt", onehot, am, preferred_element_type=jnp.float32,
        precision=matmul_precision(),
    )  # (S, B, T)
    px_lm = jnp.moveaxis(
        jnp.sum(lm[:, :S, :] * onehot, axis=2, keepdims=True), 0, 1
    )  # (S, B, 1)
    px = px_am + px_lm
    if rnnt_type == "regular":
        px = jnp.concatenate(
            [px, jax.lax.full_like(px, NEG_INF, shape=(S, B, 1))], axis=2
        )  # (S, B, T+1)
        norm_px = jnp.concatenate(
            [
                normalizers[:S],
                jax.lax.full_like(normalizers, 0.0, shape=(S, B, 1)),
            ],
            axis=2,
        )
    else:
        norm_px = normalizers[:S]
    px = px - norm_px

    py_am = jnp.transpose(
        am[:, :, termination_symbol][:, :, None], (2, 0, 1)
    )  # (1, B, T)
    py_lm = jnp.moveaxis(
        lm[:, :, termination_symbol][:, :, None], 0, 1
    )  # (S+1, B, 1)
    py = py_am + py_lm - normalizers

    if rnnt_type == "regular" and boundary is not None:
        # fix_for_boundary, s-major: px[:, b, boundary[b, 3]] = -inf
        t = jax.lax.broadcasted_iota(jnp.int32, (1, 1, T + 1), 2)
        px = jnp.where(t == boundary[:, 3][None, :, None], NEG_INF, px)
    elif rnnt_type == "constrained":
        px = px + py[1:]
    if out_dtype is not None:
        px = px.astype(out_dtype)
        py = py.astype(out_dtype)
    return px, py


def _pad_normalizers(normalizers: jax.Array, rnnt_type: str) -> jax.Array:
    """Width-match the normalizers to px: append a zero column for the extra
    t = T position of "regular" px (where px is -inf; -inf - 0 stays -inf).

    The reference appends the zero column unconditionally
    (rnnt_loss.py:211) which breaks the modified shapes — fixed here.
    """
    if rnnt_type == "regular":
        B, S1, _ = normalizers.shape
        return jnp.concatenate(
            [normalizers, jnp.zeros((B, S1, 1), dtype=normalizers.dtype)], axis=2
        )
    return normalizers


def get_rnnt_logprobs_joint(
    logits: jax.Array,
    symbols: jax.Array,
    termination_symbol: int,
    boundary: Optional[jax.Array] = None,
    rnnt_type: str = "regular",
) -> Tuple[jax.Array, jax.Array]:
    """(px, py) from full joiner output [B, T, S+1, C].

    Equivalent to rnnt_loss.py:340-452.  This is the unpruned/memory-hog
    path (the [B,T,S+1,C] logsumexp the pruned pipeline exists to avoid).
    """
    _check_rnnt_type(rnnt_type)
    B, T, S1, C = logits.shape
    S = S1 - 1

    normalizers = jax.nn.logsumexp(logits, axis=3)  # [B, T, S+1]
    normalizers = jnp.swapaxes(normalizers, 1, 2)  # [B, S+1, T]

    # px[b, t, s] = logits[b, t, s, symbols[b, s]]: fused compare+reduce
    sym_onehot = _symbol_onehot(symbols, C, logits.dtype)  # [B, S, C]
    px = jnp.einsum(
        "btsc,bsc->bst",
        logits[:, :, :S, :],
        sym_onehot,
        preferred_element_type=jnp.float32,
        precision=matmul_precision(),
    )  # [B, S, T]
    if rnnt_type == "regular":
        px = jnp.concatenate(
            [px, jnp.full((B, S, 1), NEG_INF, dtype=px.dtype)], axis=2
        )
    px = px - _pad_normalizers(normalizers, rnnt_type)[:, :S, :]

    py = jnp.swapaxes(logits[:, :, :, termination_symbol], 1, 2)  # [B, S+1, T]
    py = py - normalizers

    if rnnt_type == "regular":
        px = fix_for_boundary(px, boundary)
    elif rnnt_type == "constrained":
        px = px + py[:, 1:, :]
    return px, py


def roll_by_shifts(src: jax.Array, shifts: jax.Array) -> jax.Array:
    """Per-(b, t) circular right-roll of the last dim by ``shifts[b, t]``.

    Equivalent to ``_roll_by_shifts`` (rnnt_loss.py:814-851): a modular
    index gather.  The pruned lattice construction uses
    :func:`scatter_window` instead, which is gather-free.  This function is
    kept for API parity.
    """
    B, T, S = src.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, T, S), 2)
    idx = (idx - shifts[:, :, None].astype(jnp.int32)) % S
    return jnp.take_along_axis(src, idx, axis=2)


def scatter_window(
    win: jax.Array, shifts: jax.Array, out_width: int, fill: float = NEG_INF
) -> jax.Array:
    """Place each (b, t) window ``win[b, t, :]`` at offset ``shifts[b, t]``
    in a ``fill``-initialized row of ``out_width``:

        out[b, t, shifts[b,t] + k] = win[b, t, k];  out elsewhere = fill.

    Equivalent to the reference's pad-then-roll idiom
    (rnnt_loss.py:967-1011) whenever ``shifts + K <= out_width`` (always
    true for valid pruning ranges), but implemented as K vectorized selects
    that fuse into one elementwise pass — no per-row gather.
    """
    B, T, K = win.shape
    j = jax.lax.broadcasted_iota(jnp.int32, (B, T, out_width), 2)
    rel = j - shifts[:, :, None].astype(jnp.int32)
    out = jax.lax.full_like(win, fill, shape=(B, T, out_width))
    for k in range(K):
        out = jnp.where(rel == k, win[:, :, k : k + 1], out)
    return out


def get_rnnt_logprobs_pruned(
    logits: jax.Array,
    symbols: jax.Array,
    ranges: jax.Array,
    termination_symbol: int,
    boundary: Optional[jax.Array] = None,
    rnnt_type: str = "regular",
) -> Tuple[jax.Array, jax.Array]:
    """(px, py) from pruned joiner output [B, T, s_range, C].

    Equivalent to rnnt_loss.py:853-1020: per-frame logsumexp normalizer,
    pruned-symbol gather, then padding to full S(+1) width with -inf and
    un-shifting each frame's window back to absolute symbol positions with
    a modular roll.
    """
    _check_rnnt_type(rnnt_type)
    if rnnt_type == "constrained" and ranges.shape[2] < 2:
        # the constrained px fix adds py of the NEXT symbol row at t+1
        # (rnnt_loss.py:1015-1018); with a width-1 window that row is
        # outside the band, so EVERY px arc is -inf and the loss is
        # infinite for every utterance (the reference silently returns
        # inf here; fail loudly instead)
        raise ValueError("constrained RNN-T needs s_range >= 2")
    B, T, s_range, C = logits.shape
    S = symbols.shape[1]

    symbols_with_terminal = jnp.concatenate(
        [
            symbols.astype(jnp.int32),
            jnp.full((B, 1), termination_symbol, dtype=jnp.int32),
        ],
        axis=1,
    )  # [B, S+1]
    # pruned_symbols[b, t, k] = symbols_with_terminal[b, ranges[b, t, k]],
    # via a one-hot matmul (exact for symbol ids < 2^24 in fp32).
    ranges_onehot = (
        ranges.astype(jnp.int32)[:, :, :, None]
        == jnp.arange(S + 1, dtype=jnp.int32)
    ).astype(jnp.float32)  # [B, T, s_range, S+1]
    pruned_symbols = (
        jnp.einsum(
            "btks,bs->btk",
            ranges_onehot,
            symbols_with_terminal.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            # pinned: this reconstructs integer ids, and single-pass bf16
            # (matmul_precision()="default") rounds ids > 256
            precision=jax.lax.Precision.HIGHEST,
        )
        .round()
        .astype(jnp.int32)
    )  # [B, T, s_range]

    # px[b,t,k] = logits[b,t,k,sym] - lse;  py = logits[b,t,k,blank] - lse
    # (fused compare+reduce + logsumexp; XLA fuses all of it into two
    # passes over the pruned logits)
    normalizers = jax.nn.logsumexp(logits, axis=3)  # [B, T, s_range]
    px = (
        jnp.sum(
            jnp.where(
                pruned_symbols[:, :, :, None]
                == jnp.arange(C, dtype=jnp.int32),
                logits,
                0.0,
            ),
            axis=3,
        )
        - normalizers
    )
    py_band = logits[:, :, :, termination_symbol] - normalizers
    # place each frame's window at its absolute symbol offset, -inf elsewhere
    px = scatter_window(px, ranges[:, :, 0], S + 1)[:, :, :S]  # [B, T, S]
    px = jnp.swapaxes(px, 1, 2)  # [B, S, T]
    if rnnt_type == "regular":
        px = jnp.concatenate(
            [px, jnp.full((B, S, 1), NEG_INF, dtype=px.dtype)], axis=2
        )

    py = scatter_window(py_band, ranges[:, :, 0], S + 1)  # [B, T, S+1]
    py = jnp.swapaxes(py, 1, 2)  # [B, S+1, T]

    if rnnt_type == "regular":
        px = fix_for_boundary(px, boundary)
    elif rnnt_type == "constrained":
        px = px + py[:, 1:, :]
    return px, py


def get_rnnt_logprobs_pruned_simple(
    lm: jax.Array,
    am: jax.Array,
    symbols: jax.Array,
    ranges: jax.Array,
    termination_symbol: int,
    boundary: Optional[jax.Array] = None,
    rnnt_type: str = "regular",
) -> Tuple[jax.Array, jax.Array]:
    """(px, py) of the pruned ADDITIVE-joiner loss, built band-natively.

    Extension with no reference equivalent: when the joiner is
    ``logits = am_pruned + lm_pruned`` (the rnnt_loss_simple joiner), the
    pruned lattice is EXACTLY the simple lattice masked to the pruning band:

        px_pruned[b,s,t] = px_simple[b,s,t]  if ranges[b,t,0] <= s < ranges[b,t,0]+K
                           -inf              otherwise          (same for py)

    because lm_pruned[b,t,k] = lm[b, ranges[b,t,k]] lands back at absolute
    row s = ranges[b,t,k] after the un-shift, and the joint normalizer
    factorizes through the same [S+1,C]x[C,T] matmul as the simple loss
    (rnnt_loss.py:175-186).  So instead of materializing the [B,T,K,C]
    pruned logits (the reference pipeline: do_rnnt_pruning ->
    get_rnnt_logprobs_pruned, rnnt_loss.py:763-1020), everything stays in
    [B,S+1,T] tensors.

    Numerically equal (fp32 round-off) to
    ``get_rnnt_logprobs_pruned(am_p + lm_p, symbols, ranges, ...)`` with
    ``am_p, lm_p = do_rnnt_pruning(am, lm, ranges)``.
    """
    _check_rnnt_type(rnnt_type)
    if rnnt_type == "constrained" and ranges.shape[2] < 2:
        # see get_rnnt_logprobs_pruned: a width-1 window makes every
        # constrained px arc -inf (its py[s+1, t+1] term is out-of-band)
        raise ValueError("constrained RNN-T needs s_range >= 2")
    # build the simple lattice (without the constrained add, which must
    # happen AFTER band masking to match get_rnnt_logprobs_pruned,
    # rnnt_loss.py:1015-1018), then mask it to the band
    base_type = "modified" if rnnt_type == "constrained" else rnnt_type
    px, py = get_rnnt_logprobs(
        lm, am, symbols, termination_symbol, base_type, boundary
    )
    px = band_mask_rows(px, ranges)
    py = band_mask_rows(py, ranges)
    if rnnt_type == "constrained":
        px = px + py[:, 1:, :]
    return px, py


def band_mask_rows_smajor(x_rows: jax.Array, lo: jax.Array, K: int) -> jax.Array:
    """s-major :func:`band_mask_rows`: mask (S', B, T') rows to -inf outside
    ``lo[b, t] <= s < lo[b, t] + K`` (edge-padding lo for a regular px's
    extra t = T column)."""
    Sx, B, T1 = x_rows.shape
    lo = lo.astype(jnp.int32)
    if T1 == lo.shape[1] + 1:
        lo = jnp.concatenate([lo, lo[:, -1:]], axis=1)
    lo3 = lo[None, :, :]  # (1, B, T')
    s_i = jax.lax.broadcasted_iota(jnp.int32, (Sx, 1, 1), 0)
    return jnp.where((s_i >= lo3) & (s_i < lo3 + K), x_rows, NEG_INF)


def band_mask_rows(x: jax.Array, ranges: jax.Array) -> jax.Array:
    """Mask rows of x [B, S', T'] to -inf outside the pruning band
    ranges[b, t, 0] <= s < ranges[b, t, 0] + K.  For "regular" px, whose
    extra t = T column has no range entry, the last column is already -inf
    so an edge-padded bound is harmless."""
    B, Sx, T1 = x.shape
    K = ranges.shape[2]
    lo = ranges[:, :, 0].astype(jnp.int32)  # [B, T]
    if T1 == lo.shape[1] + 1:
        lo = jnp.concatenate([lo, lo[:, -1:]], axis=1)
    lo = lo[:, None, :]  # [B, 1, T']
    s_i = jax.lax.broadcasted_iota(jnp.int32, (1, Sx, 1), 1)
    return jnp.where((s_i >= lo) & (s_i < lo + K), x, NEG_INF)


def get_rnnt_logprobs_smoothed_rows(
    lm: jax.Array,
    am: jax.Array,
    symbols: jax.Array,
    termination_symbol: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[jax.Array] = None,
    rnnt_type: str = "regular",
) -> Tuple[jax.Array, jax.Array]:
    """s-major variant of :func:`get_rnnt_logprobs_smoothed` (same math,
    (S, B, T)-major outputs feeding the rows recursion directly)."""
    _check_rnnt_type(rnnt_type)
    B, T, C = am.shape
    S = lm.shape[1] - 1
    am_max = jax.lax.stop_gradient(jnp.max(am, axis=2, keepdims=True))
    lm_max = jax.lax.stop_gradient(jnp.max(lm, axis=2, keepdims=True))
    am_probs = jnp.exp(am - am_max)
    lm_probs = jnp.exp(lm - lm_max)
    normalizers = jnp.log(
        jnp.einsum(
            "bsc,btc->sbt", lm_probs, am_probs,
            preferred_element_type=jnp.float32,
            precision=matmul_precision(),
        )
        + _TINY
    )
    am_max_r = jnp.transpose(am_max, (2, 0, 1))  # (1, B, T)
    lm_max_r = jnp.moveaxis(lm_max, 0, 1)  # (S+1, B, 1)
    normalizers = normalizers + lm_max_r + am_max_r  # (S+1, B, T)

    # Unigram LM: average of per-position normalized lm probs over (B, S+1)
    # — including padding positions, to match the reference exactly
    # (rnnt_loss.py:1279-1280).
    lmonly_normalizers = jnp.sum(lm_probs, axis=2, keepdims=True)  # (B, S+1, 1)
    unigram_lm = (
        jnp.mean(lm_probs / lmonly_normalizers, axis=(0, 1), keepdims=True) + _TINY
    )  # (1, 1, C)
    amonly_normalizers = (
        jnp.log(
            jnp.einsum(
                "btc,c->bt", am_probs, unigram_lm[0, 0],
                preferred_element_type=jnp.float32,
                precision=matmul_precision(),
            )
        )[None, :, :]
        + am_max_r
    )  # (1, B, T)
    unigram_lm = jnp.log(unigram_lm)
    lmonly_normalizers = (
        jnp.moveaxis(jnp.log(lmonly_normalizers), 0, 1) + lm_max_r
    )  # (S+1, B, 1)

    onehot = _symbol_onehot(symbols, C, lm.dtype)  # (B, S, C)
    px_am = jnp.einsum(
        "bsc,btc->sbt", onehot, am, preferred_element_type=jnp.float32,
        precision=matmul_precision(),
    )  # (S, B, T)
    px_lm = jnp.moveaxis(
        jnp.sum(lm[:, :S, :] * onehot, axis=2, keepdims=True), 0, 1
    )  # (S, B, 1)
    px_lm_unigram = jnp.moveaxis(
        jnp.sum(unigram_lm * onehot, axis=2, keepdims=True), 0, 1
    )  # (S, B, 1)

    if rnnt_type == "regular":
        px_am = jnp.concatenate(
            [px_am, jax.lax.full_like(px_am, NEG_INF, shape=(S, B, 1))], axis=2
        )
        zero_col = jax.lax.full_like(normalizers, 0.0, shape=(S, B, 1))
        norm_px = jnp.concatenate([normalizers[:S], zero_col], axis=2)
        amonly_px = jnp.concatenate(
            [
                jnp.broadcast_to(amonly_normalizers, (S, B, T)),
                zero_col,
            ],
            axis=2,
        )
    else:
        norm_px = normalizers[:S]
        amonly_px = jnp.broadcast_to(amonly_normalizers, (S, B, T))

    px = px_am + px_lm - norm_px
    px_amonly = px_am + px_lm_unigram - amonly_px
    px_lmonly = px_lm - lmonly_normalizers[:S]

    py_am = jnp.transpose(
        am[:, :, termination_symbol][:, :, None], (2, 0, 1)
    )  # (1, B, T)
    py_lm = jnp.moveaxis(
        lm[:, :, termination_symbol][:, :, None], 0, 1
    )  # (S+1, B, 1)
    py = py_am + py_lm - normalizers
    py_lm_unigram = unigram_lm[0, 0, termination_symbol]  # scalar
    py_amonly = py_am + py_lm_unigram - amonly_normalizers  # (1, B, T)
    py_lmonly = py_lm - lmonly_normalizers  # (S+1, B, 1)

    combined_scale = 1.0 - lm_only_scale - am_only_scale
    # avoid 0 * -inf = NaN when any scale is exactly zero (see
    # get_rnnt_logprobs_smoothed)
    if combined_scale == 0.0:
        combined_scale = 1.0e-20
    if lm_only_scale == 0.0:
        lm_only_scale = 1.0e-20
    if am_only_scale == 0.0:
        am_only_scale = 1.0e-20

    px_interp = (
        px * combined_scale + px_lmonly * lm_only_scale + px_amonly * am_only_scale
    )
    py_interp = (
        py * combined_scale + py_lmonly * lm_only_scale + py_amonly * am_only_scale
    )

    if rnnt_type == "regular" and boundary is not None:
        t = jax.lax.broadcasted_iota(jnp.int32, (1, 1, T + 1), 2)
        px_interp = jnp.where(
            t == boundary[:, 3][None, :, None], NEG_INF, px_interp
        )
    elif rnnt_type == "constrained":
        px_interp = px_interp + py_interp[1:]
    return px_interp, py_interp


def get_rnnt_logprobs_smoothed(
    lm: jax.Array,
    am: jax.Array,
    symbols: jax.Array,
    termination_symbol: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[jax.Array] = None,
    rnnt_type: str = "regular",
) -> Tuple[jax.Array, jax.Array]:
    """Smoothed/interpolated simple lattice:

        combined * (1 - a - b) + lm_only * a + am_only * b

    where the am-only term uses a unigram LM (mean of the normalized lm
    probs over batch and position).  Equivalent to rnnt_loss.py:1132-1367,
    including the 1e-20 floor on zero scales to avoid 0 * -inf = NaN
    (rnnt_loss.py:1344-1349).
    """
    _check_rnnt_type(rnnt_type)
    B, T, C = am.shape
    S = lm.shape[1] - 1

    # stability shifts only: the normalizer is shift-invariant, so their
    # gradient contributions cancel exactly — stop_gradient skips the
    # max-VJP scatter pass over the [B, T, C] tensor (~10% of step time)
    am_max = jax.lax.stop_gradient(jnp.max(am, axis=2, keepdims=True))
    lm_max = jax.lax.stop_gradient(jnp.max(lm, axis=2, keepdims=True))
    am_probs = jnp.exp(am - am_max)
    lm_probs = jnp.exp(lm - lm_max)
    normalizers = jnp.log(
        jnp.einsum(
            "bsc,btc->bst", lm_probs, am_probs, preferred_element_type=jnp.float32,
        precision=matmul_precision(),
        )
        + _TINY
    )
    normalizers = normalizers + lm_max + jnp.swapaxes(am_max, 1, 2)  # [B, S+1, T]

    # Unigram LM: average of per-position normalized lm probs over (B, S+1)
    # — including padding positions, to match the reference exactly
    # (rnnt_loss.py:1279-1280).
    lmonly_normalizers = jnp.sum(lm_probs, axis=2, keepdims=True)  # [B, S+1, 1]
    unigram_lm = (
        jnp.mean(lm_probs / lmonly_normalizers, axis=(0, 1), keepdims=True) + _TINY
    )  # [1, 1, C]
    amonly_normalizers = (
        jnp.log(
            jnp.einsum(
                "btc,c->bt",
                am_probs,
                unigram_lm[0, 0],
                preferred_element_type=jnp.float32,
            precision=matmul_precision(),
            )
        )[:, :, None]
        + am_max
    )  # [B, T, 1]
    amonly_normalizers = jnp.swapaxes(amonly_normalizers, 1, 2)  # [B, 1, T]
    unigram_lm = jnp.log(unigram_lm)
    lmonly_normalizers = jnp.log(lmonly_normalizers) + lm_max  # [B, S+1, 1]

    px_am = _gather_am_symbols(am, symbols)  # [B, S, T]
    if rnnt_type == "regular":
        px_am = jnp.concatenate(
            [px_am, jnp.full((B, S, 1), NEG_INF, dtype=px_am.dtype)], axis=2
        )
    px_lm = _gather_lm_symbols(lm, symbols)  # [B, S, 1]
    sym_onehot = _symbol_onehot(symbols, C, lm.dtype)  # [B, S, C]
    px_lm_unigram = jnp.sum(
        unigram_lm * sym_onehot, axis=2, keepdims=True
    )  # [B, S, 1]

    px = px_am + px_lm
    px = px - _pad_normalizers(normalizers, rnnt_type)[:, :S, :]
    px_amonly = px_am + px_lm_unigram
    px_amonly = px_amonly - _pad_normalizers(amonly_normalizers, rnnt_type)
    px_lmonly = px_lm - lmonly_normalizers[:, :S, :]

    py_am = am[:, :, termination_symbol][:, None, :]  # [B, 1, T]
    py_lm = lm[:, :, termination_symbol][:, :, None]  # [B, S+1, 1]
    py = py_am + py_lm - normalizers
    py_lm_unigram = unigram_lm[0, 0, termination_symbol]  # scalar
    py_amonly = py_am + py_lm_unigram - amonly_normalizers  # [B, 1, T]
    py_lmonly = py_lm - lmonly_normalizers  # [B, S+1, 1]

    combined_scale = 1.0 - lm_only_scale - am_only_scale
    # avoid 0 * -inf = NaN when any scale is exactly zero (the reference
    # floors only the lm/am scales, rnnt_loss.py:1344-1349, so
    # lm_only + am_only == 1 NaNs there — fixed here)
    if combined_scale == 0.0:
        combined_scale = 1.0e-20
    if lm_only_scale == 0.0:
        lm_only_scale = 1.0e-20
    if am_only_scale == 0.0:
        am_only_scale = 1.0e-20

    px_interp = (
        px * combined_scale + px_lmonly * lm_only_scale + px_amonly * am_only_scale
    )
    py_interp = (
        py * combined_scale + py_lmonly * lm_only_scale + py_amonly * am_only_scale
    )

    if rnnt_type == "regular":
        px_interp = fix_for_boundary(px_interp, boundary)
    elif rnnt_type == "constrained":
        px_interp = px_interp + py_interp[:, 1:, :]
    return px_interp, py_interp
