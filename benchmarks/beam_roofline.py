"""Beam-search serving-step components.

This harness attributes the cost of beam=4 over greedy in the streaming
step: it times the
beam frame-step's components at the EXACT serving shapes (B=128, H=4,
d_joiner=512, C=500, 8 encoder frames per 320 ms chunk), plus candidate
variants for anything that looks structural (two-stage top-k, merge
ablation), each on the host clock around ``block_until_ready``.

Run on the GPU:  python benchmarks/beam_roofline.py
Prints one JSON line per measurement.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json

import jax
import jax.numpy as jnp
import numpy as np

from fast_rnnt_tpu.models import StreamingConfig, TransducerConfig, init_model
from fast_rnnt_tpu.models.decoding import _predictor_last
from fast_rnnt_tpu.models.transducer import PrunedTransducer
from fast_rnnt_tpu.utils.profiling import benchmark_fn

B, H, CHUNK = 128, 4, 32
FRAMES = CHUNK // 4  # encoder frames per chunk step


def main():
    cfg = TransducerConfig(causal=True, attention_left_context=32)
    model, params = init_model(jax.random.PRNGKey(0), cfg)
    k = max(cfg.predictor_context, 1)
    C, d = cfg.vocab_size, cfg.d_joiner
    L = 256
    rng = np.random.default_rng(0)

    ctx = jnp.asarray(rng.integers(0, C, size=(B * H, k)).astype(np.int32))
    am_t = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
    lm_rows = jnp.asarray(rng.normal(size=(B, H, d)).astype(np.float32))
    cand = jnp.asarray(rng.normal(size=(B, H, C)).astype(np.float32))
    hyps = jnp.asarray(rng.integers(0, C, size=(B, H, L)).astype(np.int32))
    lens = jnp.asarray(rng.integers(0, 20, size=(B, H)).astype(np.int32))
    scores = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))

    rows = []

    def emit(name, fn, *args, scale=FRAMES):
        dt = benchmark_fn(jax.jit(fn), *args, iters=100)
        rows.append((name, dt))
        print(json.dumps({
            "component": name, "us_per_call": round(dt * 1e6, 2),
            "us_per_chunk_step": round(dt * 1e6 * scale, 1),
        }), flush=True)
        return dt

    # 1. predictor fan-out: greedy runs it at B, beam at B*H
    emit("predictor_B", lambda c: _predictor_last(model, params, c),
         ctx[:B])
    emit("predictor_BH", lambda c: _predictor_last(model, params, c), ctx)

    # 2. joiner + log_softmax at beam width
    def join_beam(a, l):
        lg = model.apply(
            params, a[:, None, None, :], l[:, :, None, :],
            method=PrunedTransducer.join,
        )[:, :, 0, :]
        return jax.nn.log_softmax(lg, axis=-1)

    emit("join+logsoftmax_BH", join_beam, am_t, lm_rows)

    def join_greedy(a, l):
        lg = model.apply(
            params, a[:, None, None, :], l[:, None, None, :],
            method=PrunedTransducer.join,
        )[:, 0, 0, :]
        return jnp.argmax(lg, axis=-1)

    emit("join+argmax_B (greedy)", join_greedy, am_t, lm_rows[:, 0])

    # 3. top-k over the H*C candidate axis — shipped vs two-stage
    emit("topk_flat_HC", lambda c: jax.lax.top_k(c.reshape(B, H * C), H),
         cand)

    def topk_two_stage(c):
        s1, i1 = jax.lax.top_k(c, H)  # (B,H,H) over C per beam row
        s2, i2 = jax.lax.top_k(s1.reshape(B, H * H), H)
        parent = i2 // H
        sym = jnp.take_along_axis(
            i1.reshape(B, H * H), i2, axis=1
        )
        return s2, parent, sym

    emit("topk_two_stage", topk_two_stage, cand)

    # 4. beam bookkeeping: one-hot parent gathers + duplicate merge
    parent = jnp.asarray(rng.integers(0, H, size=(B, H)).astype(np.int32))

    def bookkeeping(p, hy, ln, sc):
        sel = (p[:, :, None] == jnp.arange(H)[None, None, :])
        gat = lambda x: jnp.einsum(
            "bno,bo...->bn...", sel.astype(x.dtype), x
        ).astype(x.dtype)
        new_hyps, new_lens = gat(hy), gat(ln)
        same = (new_lens[:, :, None] == new_lens[:, None, :]) & jnp.all(
            new_hyps[:, :, None, :] == new_hyps[:, None, :, :], axis=3
        )
        hi = jnp.arange(H)
        is_dup = jnp.any(
            same & (hi[None, :, None] < hi[None, None, :]), axis=1
        )
        merged = jax.nn.logsumexp(
            jnp.where(same, sc[:, None, :], -jnp.inf), axis=2
        )
        return jnp.where(is_dup, -jnp.inf, merged), new_hyps, new_lens

    emit("parent_gather+dup_merge", bookkeeping, parent, hyps, lens, scores)

    total = sum(dt for _, dt in rows if "greedy" not in _ and _ != "predictor_B")
    print(json.dumps({
        "summary": "per-frame beam components (excl. encoder)",
        "sum_us_per_frame": round(total * 1e6, 1),
        "sum_us_per_chunk": round(total * 1e6 * FRAMES, 1),
        "frames_per_chunk": FRAMES,
    }), flush=True)


if __name__ == "__main__":
    main()
