"""End-to-end example: train a pruned transducer and decode with it.

Covers the whole framework surface a user needs — ragged batching
(native C++ planner), the two-stage pruned RNN-T loss, data-parallel
training over a device mesh, orbax checkpointing, and batched greedy
decoding — on a synthetic copy-task dataset (each symbol is painted into
~8 feature frames, so a converged model must transcribe the sequence).

  python examples/train_and_decode.py [--steps 300] [--ckpt /tmp/frt_ckpt]

Runs on a GPU or CPU alike; multi-device hosts data-parallelize
automatically (utterances sharded over the mesh, gradient psum).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from fast_rnnt_tpu.data.loader import RaggedBatcher
from fast_rnnt_tpu.models import (
    LossConfig,
    TransducerConfig,
    greedy_search,
    init_model,
    make_train_step,
    modified_beam_search,
)
from fast_rnnt_tpu.models.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from fast_rnnt_tpu.parallel import make_mesh, shard_batch

VOCAB = 16
FEAT = 16
FRAMES_PER_SYM = 8


def synth_utterance(rng, min_s=3, max_s=8):
    """Symbols painted into frames: features[t] ~ onehot(symbol) + noise."""
    S = int(rng.integers(min_s, max_s + 1))
    syms = rng.integers(1, VOCAB, size=S).astype(np.int32)
    frames = np.repeat(np.eye(FEAT, dtype=np.float32)[syms], FRAMES_PER_SYM, axis=0)
    frames = frames + 0.1 * rng.normal(size=frames.shape).astype(np.float32)
    return frames, syms


def token_accuracy(hyps, hlens, refs, rlens):
    hits = total = 0
    for h, hl, r, rl in zip(hyps, hlens, refs, rlens):
        total += int(rl)
        m = min(int(hl), int(rl))
        hits += int((h[:m] == r[:m]).sum())
    return hits / max(total, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--utts", type=int, default=64)
    ap.add_argument("--ckpt", type=str, default="")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    data = [synth_utterance(rng) for _ in range(args.utts)]
    features = [f for f, _ in data]
    symbols = [s for _, s in data]

    cfg = TransducerConfig(
        vocab_size=VOCAB, feature_dim=FEAT, d_model=64, d_joiner=64,
        num_layers=2, num_heads=2, conv_kernel=7, dtype=jnp.float32,
    )
    model, params = init_model(jax.random.PRNGKey(0), cfg)
    mesh = make_mesh()
    n_dev = len(mesh.devices.flat)
    print(f"devices: {n_dev} ({mesh.devices.flat[0]})")

    batcher = RaggedBatcher(
        max_frames=4096, max_batch=16 * n_dev, quantum=16,
        pad_batch_to=16 * n_dev,
    )
    batches = list(batcher.batches(features, symbols))
    print(f"{len(batches)} static-shape batches "
          f"(shapes: {sorted({b[0].shape for b in batches})})")

    opt = optax.adamw(3e-3)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, mesh=mesh, loss_cfg=LossConfig(s_range=4))

    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        start, state = restore_checkpoint(
            args.ckpt, template={"params": params, "opt_state": opt_state}
        )
        params, opt_state = state["params"], state["opt_state"]
        print(f"resumed from step {start}")

    # shard each distinct batch ONCE (re-transferring identical arrays every
    # step would add a host-to-device copy to each step)
    device_batches = [
        shard_batch(tuple(jnp.asarray(x) for x in b), mesh) for b in batches
    ]
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = device_batches[i % len(device_batches)]
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(metrics['loss']):8.3f}  "
                  f"({time.perf_counter() - t0:.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, args.steps, params, opt_state)
        print(f"checkpoint saved to {args.ckpt}")

    # decode the first batch back
    feats, flens, syms, slens = batches[0]
    hyps, hlens = jax.jit(
        lambda f, l: greedy_search(model, params, f, l, max_len=16)
    )(jnp.asarray(feats), jnp.asarray(flens))
    acc = token_accuracy(np.asarray(hyps), np.asarray(hlens), syms, slens)
    print(f"greedy-decode token accuracy on train batch: {acc:.1%}")
    bh, bl = jax.jit(
        lambda f, l: modified_beam_search(model, params, f, l, beam=4, max_len=16)
    )(jnp.asarray(feats), jnp.asarray(flens))
    bacc = token_accuracy(np.asarray(bh), np.asarray(bl), syms, slens)
    print(f"beam-search (H=4) token accuracy on train batch: {bacc:.1%}")
    for b in range(min(3, len(syms))):
        sl, hl = int(slens[b]), int(np.asarray(hlens)[b])
        print(f"  ref: {list(syms[b][:sl])}\n  hyp: {list(np.asarray(hyps)[b][:hl])}")


if __name__ == "__main__":
    main()
