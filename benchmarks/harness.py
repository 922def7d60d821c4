"""Benchmark + parity harness.

Reproduces the transducer-loss-benchmarking comparison the reference's
README cites (/root/reference/README.md:156-169; baselines in BASELINE.md)
on the current device: the pruned pipeline (38,112 µs baseline) via both
the materialized-logits path and the band-native fast path, the unpruned
full-joiner loss (274,407 µs baseline), the smoothed loss, throughput
(audio-seconds/s), peak-HBM from XLA's allocation analysis, and a parity
check against the native C++ oracle.

  python benchmarks/harness.py            # full report (JSON)
  python benchmarks/harness.py --quick    # smaller shapes
"""

from __future__ import annotations

import argparse
import json
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import fast_rnnt_tpu as frt
from fast_rnnt_tpu.utils import benchmark_fn, device_memory_stats

BASE_PRUNED_US = 38112.0
BASE_PRUNED_MB = 2647.8
BASE_UNPRUNED_US = 274407.0
BASE_UNPRUNED_MB = 15106.5


def make_inputs(B, T, S, C, seed=0):
    rng = np.random.default_rng(seed)
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    t_end = np.clip(rng.integers(T // 2, T + 1, size=B), S + 2, T).astype(np.int32)
    s_end = np.clip(rng.integers(S // 2, S + 1, size=B), 2, S).astype(np.int32)
    boundary = jnp.asarray(
        np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end], axis=1)
    )
    return am, lm, symbols, boundary


def pruned_step_materialized(am, lm, symbols, boundary, s_range):
    """Reference-shaped pipeline: pruning gathers + [B,T,K,C] logits."""

    def loss_fn(am, lm):
        simple, (gx, gy) = frt.rnnt_loss_simple(
            lm, am, symbols, 0, boundary, reduction="sum", calc_gradients=True
        )
        ranges = frt.get_rnnt_prune_ranges(gx, gy, boundary, s_range)
        ap, lp = frt.do_rnnt_pruning(am, lm, ranges)
        pruned = frt.rnnt_loss_pruned(
            ap + lp, symbols, ranges, 0, boundary, reduction="sum"
        )
        return 0.5 * simple + pruned

    return jax.value_and_grad(loss_fn, argnums=(0, 1))(am, lm)


def pruned_step_fast(am, lm, symbols, boundary, s_range):
    """Fused band-native pipeline (numerically equal for the additive
    joiner): one lattice build shared between both stages."""

    def loss_fn(am, lm):
        simple, pruned, _ = frt.rnnt_loss_simple_pruned(
            lm, am, symbols, 0, s_range, boundary, reduction="sum"
        )
        return 0.5 * simple + pruned

    return jax.value_and_grad(loss_fn, argnums=(0, 1))(am, lm)


def unpruned_step(am, lm, symbols, boundary):
    def loss_fn(am, lm):
        logits = lm[:, None, :, :] + am[:, :, None, :]
        return frt.rnnt_loss(logits, symbols, 0, boundary, reduction="sum")

    return jax.value_and_grad(loss_fn, argnums=(0, 1))(am, lm)


def smoothed_step(am, lm, symbols, boundary):
    def loss_fn(am, lm):
        loss, _ = frt.rnnt_loss_smoothed(
            lm, am, symbols, 0, 0.25, 0.0, boundary,
            reduction="sum", calc_gradients=True,
        )
        return loss

    return jax.value_and_grad(loss_fn, argnums=(0, 1))(am, lm)


def model_step_bench(iters):
    """BASELINE config #5: LibriSpeech-scale pruned-transducer training step
    (conformer encoder, vocab 500) on the local mesh.  Single-chip here;
    the loss is per-utterance so scaling to N chips/hosts is linear up to
    the gradient psum (validated functionally on virtual CPU meshes in
    tests/test_parallel.py and the driver's multichip dry-run)."""
    import optax

    from fast_rnnt_tpu.models import (
        LossConfig,
        TransducerConfig,
        init_model,
        make_train_step,
    )
    from fast_rnnt_tpu.parallel import make_mesh, shard_batch

    cfg = TransducerConfig()  # d_model=256, 6 conformer layers, vocab 500
    model, params = init_model(jax.random.PRNGKey(0), cfg)
    mesh = make_mesh()
    B, T_in, S = 8, 1000, 100  # ~10 s utterances, 10 ms frames, 4x subsample
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(B, T_in, cfg.feature_dim)).astype(np.float32))
    flens = jnp.full((B,), T_in, jnp.int32)
    syms = jnp.asarray(rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32))
    slens = jnp.full((B,), S, jnp.int32)
    batch = shard_batch((feats, flens, syms, slens), mesh)

    opt = optax.adamw(1e-3)
    opt_state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh, loss_cfg=LossConfig(s_range=5))

    def one(feats):
        b = (feats,) + batch[1:]
        p2, o2, metrics = step(params, opt_state, b)
        # fold the UPDATED PARAMETERS into the result: returning only the
        # loss lets XLA dead-code-eliminate the whole backward pass and
        # optimizer update (verified via FLOP counts), silently turning the
        # "train step" benchmark into a forward-only one
        psum = sum(
            jnp.sum(leaf.astype(jnp.float32))
            for leaf in jax.tree_util.tree_leaves(p2)
        )
        return metrics["loss"], psum

    dt = benchmark_fn(jax.jit(one), batch[0], iters=iters)
    audio_s = B * T_in * 0.01
    return {
        "step_us": round(dt * 1e6, 1),
        "audio_seconds_per_s": round(audio_s / dt, 1),
        "workload": {"B": B, "T_in": T_in, "S": S, "model": "conformer-6L-256d"},
    }


def parity_check(B=2, T=16, S=6, C=12, seed=1234):
    """Loss + occupancy parity vs the native C++ oracle (fp32)."""
    from fast_rnnt_tpu.csrc import mi_backward_cpu, mi_forward_cpu

    am, lm, symbols, boundary = make_inputs(B, T, S, C, seed)
    px, py = frt.get_rnnt_logprobs(lm, am, symbols, 0, "regular", boundary)
    scores, (gx, gy) = frt.mutual_information_recursion(
        px, py, boundary, calc_gradients=True
    )
    p_c, scores_c = mi_forward_cpu(np.asarray(px), np.asarray(py), np.asarray(boundary))
    gx_c, gy_c = mi_backward_cpu(
        np.asarray(px), np.asarray(py), p_c, np.asarray(boundary),
        np.ones(B, np.float32),
    )
    return {
        "scores_max_abs_err": float(np.abs(np.asarray(scores) - scores_c).max()),
        "px_grad_max_abs_err": float(np.abs(np.asarray(gx) - gx_c).max()),
        "py_grad_max_abs_err": float(np.abs(np.asarray(gy) - gy_c).max()),
    }


def _measure(step, args, iters, baseline_us=None, baseline_mb=None, audio_s=None):
    dt = benchmark_fn(jax.jit(step), *args, iters=iters)
    entry = {"step_us": round(dt * 1e6, 1)}
    if baseline_us:
        entry["vs_baseline"] = round(baseline_us / (dt * 1e6), 3)
    # the allocator's peak since the process started (cumulative)
    entry["peak_mb_in_use_so_far"] = round(
        device_memory_stats()["peak_mb_in_use"], 1
    )
    if audio_s:
        entry["audio_seconds_per_s"] = round(audio_s / dt, 1)
    return entry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    if args.quick:
        B, T, S, C = 8, 200, 40, 500  # BASELINE config #3 scale
    else:
        B, T, S, C = 30, 1000, 100, 500  # benchmark config #4
    s_range = 5

    am, lm, symbols, boundary = make_inputs(B, T, S, C)
    audio_seconds = float(np.asarray(boundary)[:, 3].sum()) * 0.04

    report = {
        "device": str(jax.devices()[0]),
        "workload": {"B": B, "T": T, "S": S, "C": C, "s_range": s_range},
        "parity_vs_cpp_oracle": parity_check(),
    }

    report["pruned_fast"] = _measure(
        lambda am, lm: pruned_step_fast(am, lm, symbols, boundary, s_range),
        (am, lm), args.iters, BASE_PRUNED_US, BASE_PRUNED_MB, audio_seconds,
    )
    report["pruned_materialized"] = _measure(
        lambda am, lm: pruned_step_materialized(am, lm, symbols, boundary, s_range),
        (am, lm), args.iters, BASE_PRUNED_US, BASE_PRUNED_MB, audio_seconds,
    )
    report["unpruned"] = _measure(
        lambda am, lm: unpruned_step(am, lm, symbols, boundary),
        (am, lm), max(args.iters // 4, 3),
        BASE_UNPRUNED_US, BASE_UNPRUNED_MB, audio_seconds,
    )
    report["smoothed_simple"] = _measure(
        lambda am, lm: smoothed_step(am, lm, symbols, boundary),
        (am, lm), args.iters, audio_s=audio_seconds,
    )
    try:
        report["model_train_step"] = model_step_bench(max(args.iters // 2, 5))
    except Exception as e:  # models extras (flax/optax) unavailable
        report["model_train_step"] = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
