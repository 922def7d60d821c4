"""Batched transducer decoding (greedy and modified beam search).

The reference ships no inference at all (loss-only library); this completes
the model family so the pruned transducer trained with models/training.py
can actually be used.  Design decisions:

  * fully batched, static shapes: greedy search is one `lax.while_loop`
    whose every trip is exactly one predictor+joiner evaluation per
    stream (frame pointers advance on blank/cap — see greedy_over_frames
    for why this beats a frames x emission-cap nested loop); beam search
    is one `lax.scan` over frames.  No data-dependent Python control
    flow, so each search jits to a single XLA program and can be
    `shard_map`-ped over the batch axis like the training step.
  * the stateless predictor (embedding + causal conv over the last
    `predictor_context` symbols, transducer.py:129-154) means the decode
    state is just a rolling (B, context) symbol buffer — no RNN carry.
  * finished utterances (t >= out_lens) keep emitting blanks into masked
    lanes; results are length-tracked, not ragged.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from .transducer import PrunedTransducer, TransducerConfig

__all__ = ["greedy_search", "greedy_over_frames", "modified_beam_search"]


def _encode(model: PrunedTransducer, params: Any, features, feature_lens):
    """Encoder + am projection only (the decode-time acoustic path; the
    predictor/simple projections would be dead compute here)."""
    return model.apply(
        params,
        features,
        feature_lens,
        method=lambda m, f, fl: (lambda enc_lens: (m.am_proj(enc_lens[0]),
                                                   enc_lens[1]))(m.encoder(f, fl)),
    )


def _predictor_last(model: PrunedTransducer, params: Any, ctx: jax.Array):
    """lm projection rows for the CURRENT context: run the predictor on the
    rolling (B, k) symbol buffer and keep its last position.

    The Predictor prepends BOS internally and returns (B, k+1, d); row k is
    the prediction context after all k symbols in the buffer."""
    lm_all = model.apply(params, ctx, method=lambda m, c: m.lm_proj(m.predictor(c)))
    return lm_all[:, -1, :]  # (B, d_joiner)


def greedy_over_frames(
    model: PrunedTransducer,
    params: Any,
    am: jax.Array,
    frame_active: jax.Array,
    ctx: jax.Array,
    hyps: jax.Array,
    lens: jax.Array,
    max_symbols_per_frame: int = 4,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Greedy-decode a block of encoder frames, resuming from carried state.

    The core frame loop shared by offline :func:`greedy_search` and the
    chunked :mod:`streaming` decoder (which calls it once per chunk with
    the carried (ctx, hyps, lens)).

    Args:
      am: (B, T_blk, d_joiner) joiner-space encoder rows for this block.
      frame_active: (B, T_blk) bool — frames past an utterance's end emit
        nothing (their state passes through unchanged).
      ctx: (B, k) rolling predictor symbol context.
      hyps / lens: (B, max_len) int32 output buffer and (B,) counts.

    Returns the updated (ctx, hyps, lens).

    Scheduling (round 3): ONE while loop whose every trip is exactly one
    predictor+joiner evaluation per stream; a stream advances its frame
    pointer on blank / cap / inactivity and emits otherwise.  The naive
    nested loops (scan over frames x fori over the emission cap) burn
    ``T_blk * max_symbols_per_frame`` sequential evals even though speech
    emits blank on most frames; this loop costs
    ``max over streams of (frames + emissions (+1 per capped frame))``
    trips — ~3-4x fewer sequential small-matmul launches, and these tiny
    steps are latency-bound.  Emitted sequences are IDENTICAL
    to the nested loops' (same greedy decisions in the same order; only
    the scheduling differs) — pinned by the streaming/decoding parity
    tests.
    """
    cfg: TransducerConfig = model.cfg
    blank = cfg.blank_id
    B, T_blk, _ = am.shape
    max_len = hyps.shape[1]

    def join_logits(am_rows, lm_rows):
        # joiner expects (B, T, s_range, d); use T = s_range = 1 slices
        lg = model.apply(
            params,
            am_rows[:, None, None, :],
            lm_rows[:, None, None, :],
            method=PrunedTransducer.join,
        )
        return lg[:, 0, 0, :]  # (B, C)

    def cond(carry):
        t_ptr = carry[0]
        return jnp.any(t_ptr < T_blk)

    def trip(carry):
        t_ptr, emit_cnt, ctx, hyps, lens = carry
        t_safe = jnp.minimum(t_ptr, T_blk - 1)
        am_t = jnp.take_along_axis(am, t_safe[:, None, None], axis=1)[:, 0, :]
        frame_ok = jnp.take_along_axis(
            frame_active, t_safe[:, None], axis=1
        )[:, 0]
        in_block = t_ptr < T_blk

        lm_rows = _predictor_last(model, params, ctx)
        logits = join_logits(am_t, lm_rows)
        sym = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # (B,)
        take = (
            in_block
            & frame_ok
            & (sym != blank)
            & (lens < max_len)
            & (emit_cnt < max_symbols_per_frame)
        )
        onehot_pos = (
            jax.lax.broadcasted_iota(jnp.int32, hyps.shape, 1) == lens[:, None]
        )
        hyps = jnp.where(onehot_pos & take[:, None], sym[:, None], hyps)
        lens = lens + take.astype(jnp.int32)
        ctx = jnp.where(
            take[:, None],
            jnp.concatenate([ctx[:, 1:], sym[:, None]], axis=1),
            ctx,
        )
        advance = in_block & ~take
        t_ptr = t_ptr + advance.astype(jnp.int32)
        emit_cnt = jnp.where(advance, 0, emit_cnt + take.astype(jnp.int32))
        return t_ptr, emit_cnt, ctx, hyps, lens

    # zeros_like(lens): under shard_map the carry must match the loop
    # body's varying-manual-axes type, which fresh jnp.zeros would not
    t0 = jnp.zeros_like(lens)
    _, _, ctx, hyps, lens = jax.lax.while_loop(
        cond, trip, (t0, jnp.zeros_like(lens), ctx, hyps, lens)
    )
    return ctx, hyps, lens


def greedy_search(
    model: PrunedTransducer,
    params: Any,
    features: jax.Array,
    feature_lens: jax.Array,
    max_symbols_per_frame: int = 4,
    max_len: int = 256,
) -> Tuple[jax.Array, jax.Array]:
    """Batched greedy (max-prob) transducer decoding.

    Args:
      model/params: a PrunedTransducer and its variables.
      features: (B, T_in, feature_dim) float.
      feature_lens: (B,) int frame counts before subsampling.
      max_symbols_per_frame: emission cap per frame (keeps shapes static).
      max_len: output buffer length.

    Returns:
      (hyps, hyp_lens): int32 (B, max_len) padded with blank, and (B,) counts.
    """
    cfg: TransducerConfig = model.cfg
    k = max(cfg.predictor_context, 1)

    # encode once
    am, out_lens = _encode(model, params, features, feature_lens)
    B, T, _ = am.shape
    frame_active = (
        jax.lax.broadcasted_iota(jnp.int32, (B, T), 1) < out_lens[:, None]
    )
    ctx0 = jnp.full((B, k), cfg.blank_id, jnp.int32)
    hyps0 = jnp.full((B, max_len), cfg.blank_id, jnp.int32)
    lens0 = jnp.zeros((B,), jnp.int32)
    _, hyps, lens = greedy_over_frames(
        model, params, am, frame_active, ctx0, hyps0, lens0,
        max_symbols_per_frame=max_symbols_per_frame,
    )
    return hyps, lens


def beam_over_frames(
    model: PrunedTransducer,
    params: Any,
    am: jax.Array,
    frame_active: jax.Array,
    scores: jax.Array,
    ctx: jax.Array,
    hyps: jax.Array,
    lens: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Beam-search a block of encoder frames, resuming from carried beam
    state (the beam analog of :func:`greedy_over_frames`; shared by
    offline :func:`modified_beam_search` and the streaming decoder).

    Args:
      am: (B, T_blk, d_joiner) encoder rows for this block.
      frame_active: (B, T_blk) bool.
      scores/ctx/hyps/lens: (B,H), (B,H,k), (B,H,L), (B,H) beam state.

    Returns the updated (scores, ctx, hyps, lens).
    """
    cfg: TransducerConfig = model.cfg
    blank = cfg.blank_id
    k = ctx.shape[2]
    B, H = scores.shape
    C = cfg.vocab_size
    max_len = hyps.shape[2]

    def frame_step(carry, inputs):
        am_t, act = inputs  # (B, d), (B,)
        scores, ctx, hyps, lens = carry  # (B,H), (B,H,k), (B,H,L), (B,H)
        active = act[:, None]  # (B,1)

        lm_rows = _predictor_last(
            model, params, ctx.reshape(B * H, k)
        ).reshape(B, H, -1)
        logits = model.apply(
            params,
            am_t[:, None, None, :],  # (B,1,1,d), broadcasts against H
            lm_rows[:, :, None, :],
            method=PrunedTransducer.join,
        )[:, :, 0, :]  # (B,H,C)
        logp = jax.nn.log_softmax(logits, axis=-1)

        # candidate scores; frozen (inactive) frames only allow blank
        cand = scores[:, :, None] + jnp.where(
            active[:, :, None], logp, jnp.where(
                jnp.arange(C) == blank, 0.0, -jnp.inf
            )[None, None, :],
        )  # (B,H,C)
        # hypotheses that can no longer grow: emissions only via blank
        full = (lens >= max_len)[:, :, None]
        cand = jnp.where(
            full & (jnp.arange(C)[None, None, :] != blank), -jnp.inf, cand
        )
        top_scores, flat_idx = jax.lax.top_k(cand.reshape(B, H * C), H)
        parent = flat_idx // C  # (B,H)
        sym = (flat_idx % C).astype(jnp.int32)

        # gather parent state via one-hot over the tiny H axis (gather-free)
        sel = (
            parent[:, :, None] == jnp.arange(H)[None, None, :]
        )  # (B, Hnew, Hold)
        gat = lambda x: jnp.einsum(
            "bno,bo...->bn...", sel.astype(x.dtype), x
        ).astype(x.dtype)
        new_ctx = gat(ctx)
        new_hyps = gat(hyps)
        new_lens = gat(lens)

        emit = sym != blank  # (B,H)
        pos_onehot = (
            jax.lax.broadcasted_iota(jnp.int32, new_hyps.shape, 2)
            == new_lens[:, :, None]
        )
        new_hyps = jnp.where(
            pos_onehot & emit[:, :, None], sym[:, :, None], new_hyps
        )
        new_lens = new_lens + emit.astype(new_lens.dtype)
        new_ctx = jnp.where(
            emit[:, :, None],
            jnp.concatenate([new_ctx[:, :, 1:], sym[:, :, None]], axis=2),
            new_ctx,
        )

        # merge beam slots holding IDENTICAL token sequences (icefall's
        # modified_beam_search semantics): the lowest-index slot of each
        # duplicate group absorbs the group's probability mass
        # (logaddexp) and the rest drop to -inf — duplicates would
        # otherwise split mass and shrink the effective beam.  Hyp
        # buffers are blank-padded past lens, so whole-buffer equality
        # plus equal lens identifies equal sequences; this also re-kills
        # the initial all-identical -inf slots each frame.
        same = (new_lens[:, :, None] == new_lens[:, None, :]) & jnp.all(
            new_hyps[:, :, None, :] == new_hyps[:, None, :, :], axis=3
        )  # (B, H, H), symmetric, diag True
        hi = jnp.arange(H)
        is_dup = jnp.any(same & (hi[None, :, None] < hi[None, None, :]), axis=1)
        merged = jax.nn.logsumexp(
            jnp.where(same, top_scores[:, None, :], -jnp.inf), axis=2
        )
        top_scores = jnp.where(is_dup, -jnp.inf, merged)
        return (top_scores, new_ctx, new_hyps, new_lens), None

    (scores, ctx, hyps, lens), _ = jax.lax.scan(
        frame_step,
        (scores, ctx, hyps, lens),
        (jnp.moveaxis(am, 0, 1), jnp.moveaxis(frame_active, 0, 1)),
    )
    return scores, ctx, hyps, lens


def beam_init_state(cfg: TransducerConfig, B: int, beam: int, max_len: int):
    """Fresh beam state: slot 0 live at score 0, the rest at -inf so the
    first frame fans out."""
    k = max(cfg.predictor_context, 1)
    return (
        jnp.full((B, beam), -jnp.inf).at[:, 0].set(0.0),
        jnp.full((B, beam, k), cfg.blank_id, jnp.int32),
        jnp.full((B, beam, max_len), cfg.blank_id, jnp.int32),
        jnp.zeros((B, beam), jnp.int32),
    )


def beam_best(scores, hyps, lens) -> Tuple[jax.Array, jax.Array]:
    """Select each utterance's best hypothesis (gather-free over H)."""
    H = scores.shape[1]
    best = jnp.argmax(scores, axis=1)  # (B,)
    bsel = (best[:, None] == jnp.arange(H)[None, :]).astype(jnp.int32)
    best_hyps = jnp.einsum("bh,bhl->bl", bsel, hyps).astype(jnp.int32)
    best_lens = jnp.einsum("bh,bh->b", bsel, lens).astype(jnp.int32)
    return best_hyps, best_lens


def modified_beam_search(
    model: PrunedTransducer,
    params: Any,
    features: jax.Array,
    feature_lens: jax.Array,
    beam: int = 4,
    max_len: int = 256,
) -> Tuple[jax.Array, jax.Array]:
    """Batched modified beam search (at most ONE emission per frame — the
    constraint k2/icefall's ``modified_beam_search`` uses, which matches the
    "modified" rnnt_type and keeps every shape static).

    Per frame each of the H live hypotheses expands over the full vocab
    (blank = stay, symbol = append); the top-H of the H*C candidates
    survive.  All bookkeeping is top_k + gather-free one-hot contractions
    over an H axis of ~4-8, so the whole search jits to a single XLA
    program.

    Returns (hyps, hyp_lens) for the best hypothesis per utterance:
    int32 (B, max_len) padded with blank, and (B,) lengths.
    """
    am, out_lens = _encode(model, params, features, feature_lens)
    B, T, _ = am.shape
    frame_active = (
        jax.lax.broadcasted_iota(jnp.int32, (B, T), 1) < out_lens[:, None]
    )
    state = beam_init_state(model.cfg, B, beam, max_len)
    scores, ctx, hyps, lens = beam_over_frames(
        model, params, am, frame_active, *state
    )
    return beam_best(scores, hyps, lens)
