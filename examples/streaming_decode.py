"""Streaming transducer decoding: train a tiny CAUSAL model to memorize a
batch, then decode it chunk-by-chunk and verify the streamed tokens equal
the offline decode exactly.

Run:  python examples/streaming_decode.py   (CPU or GPU; a couple of minutes)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from fast_rnnt_tpu.models import (
    LossConfig,
    StreamingConfig,
    TransducerConfig,
    greedy_search,
    init_model,
    make_train_step,
    streaming_init,
    streaming_step,
)
from fast_rnnt_tpu.parallel import make_mesh, shard_batch


def main():
    cfg = TransducerConfig(
        vocab_size=16, feature_dim=8, d_model=32, d_joiner=32,
        num_layers=1, num_heads=2, conv_kernel=7, dtype=jnp.float32,
        causal=True, attention_left_context=8,   # streaming-capable encoder
    )
    model, params = init_model(jax.random.PRNGKey(0), cfg)

    rng = np.random.default_rng(0)
    B, T_in, S = 2, 64, 4
    feats = jnp.asarray(rng.normal(size=(B, T_in, cfg.feature_dim)).astype(np.float32))
    flens = jnp.full((B,), T_in, jnp.int32)
    syms = jnp.asarray(rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32))
    slens = jnp.full((B,), S, jnp.int32)

    # overfit the batch (same two-stage pruned loss as the offline example)
    mesh = make_mesh(jax.devices()[:1])
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh, loss_cfg=LossConfig(s_range=3))
    batch = shard_batch((feats, flens, syms, slens), mesh)
    for i in range(200):
        params, opt_state, metrics = step(params, opt_state, batch)
    print(f"trained: loss {float(metrics['loss']):.4f}")

    # offline decode
    off_hyps, off_lens = jax.jit(
        lambda f, l: greedy_search(model, params, f, l, max_len=16)
    )(feats, flens)

    # streaming decode: 16-frame chunks, 64 frames of history
    scfg = StreamingConfig(chunk=16, left=64, max_len=16)
    state = streaming_init(model, scfg, B)
    sstep = jax.jit(
        lambda st, fc, cl: streaming_step(model, params, scfg, st, fc, cl)
    )
    for i in range(T_in // scfg.chunk):
        fc = feats[:, i * scfg.chunk : (i + 1) * scfg.chunk]
        cl = jnp.clip(flens - i * scfg.chunk, 0, scfg.chunk)
        state, (hyps, lens) = sstep(state, fc, cl)
        print(f"after chunk {i}: emitted so far = {np.asarray(lens)}")

    assert np.array_equal(np.asarray(hyps), np.asarray(off_hyps))
    assert np.array_equal(np.asarray(lens), np.asarray(off_lens))
    print("streaming == offline decode, token for token:")
    for b in range(B):
        print(f"  ref: {np.asarray(syms)[b].tolist()}  "
              f"hyp: {np.asarray(hyps)[b, :int(lens[b])].tolist()}")

    # continuous-batching server: both utterances (and a repeat of the
    # first) multiplexed through ONE slot — each admission re-arms the
    # slot and still decodes exactly the offline tokens
    from fast_rnnt_tpu.models import StreamServer

    server = StreamServer(model, params, StreamingConfig(chunk=16, max_len=16),
                          capacity=1)
    f_np = np.asarray(feats)
    for sid, b in [("utt0", 0), ("utt1", 1), ("utt0-again", 0)]:
        server.submit(sid, f_np[b])
    results = server.run()
    for sid, b in [("utt0", 0), ("utt1", 1), ("utt0-again", 0)]:
        assert np.array_equal(
            results[sid], np.asarray(off_hyps)[b, : int(off_lens[b])]
        )
    print("StreamServer (1 slot, 3 admissions) == offline decode")


if __name__ == "__main__":
    main()
