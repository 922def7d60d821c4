"""Benchmark: pruned RNN-T loss training step on the transducer-loss-
benchmarking workload (BASELINE.md; B=30, T=1000, S=100, C=500, s_range=5),
on one CUDA GPU.

Measures what the reference's published 38,112 µs covers: forward + backward
of the full pruned pipeline (simple loss w/ occupancy grads -> prune ranges
-> pruning gathers -> additive joiner -> pruned loss) w.r.t. (am, lm).

    python bench.py            # fp32 and bf16 loss-step rows

Prints the device (platform, kind, count), the card's name and power limit,
the compile cache, then ONE JSON line per row:
  {"metric": ..., "value": <avg step µs>, "unit": "us", "vs_baseline": <x>}
vs_baseline > 1 means faster than the reference's GPU number.  Exits
non-zero without a GPU, when the parity gate fails, or when any row fails.
"""

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import fast_rnnt_tpu as frt

BASELINE_US = 38112.0  # the reference's published step time (BASELINE.md)

B, T, S, C = 30, 1000, 100, 500
S_RANGE = 5
ITERS = 20


def make_inputs(seed=0, batch=B):
    rng = np.random.default_rng(seed)
    am = jnp.asarray(rng.normal(size=(batch, T, C)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(batch, S + 1, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(batch, S)).astype(np.int32))
    # ragged lengths like the benchmarking workload
    t_end = np.clip(rng.integers(T // 2, T + 1, size=batch), S + 2, T).astype(np.int32)
    s_end = np.clip(rng.integers(S // 2, S + 1, size=batch), 2, S).astype(np.int32)
    zeros = np.zeros(batch, np.int32)
    boundary = jnp.asarray(np.stack([zeros, zeros, s_end, t_end], axis=1))
    return am, lm, symbols, boundary


def _round_salt():
    """Parity-gate input seed derived from git HEAD (override:
    FRT_BENCH_SALT env var), so each commit's parity numbers come from
    fresh inputs — a gate whose inputs never move cannot catch a kernel
    rewrite that is wrong only elsewhere.  The golden-vector arm keeps its
    committed fixed inputs; the TIMED workload stays at seed 0 so step
    times stay comparable across commits."""
    import hashlib
    import os
    import subprocess

    salt = os.environ.get("FRT_BENCH_SALT", "")
    if not salt:
        try:
            salt = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"],
                capture_output=True, text=True, timeout=10,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip()
        except Exception:
            salt = ""
    if not salt:
        salt = time.strftime("%Y%m%d")  # still fresh per day
    seed = int(hashlib.sha256(salt.encode()).hexdigest()[:8], 16)
    return salt, seed


def _input_hash(arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.asarray(a).tobytes())
    return h.hexdigest()[:12]


def step_fn(am, lm, symbols, boundary, rnnt_type="regular", impl=None):
    lattice_dtype = jnp.bfloat16 if am.dtype == jnp.bfloat16 else None

    def loss_fn(am, lm):
        # The benchmark workload's joiner is additive (logits = am_p + lm_p),
        # so the fused band-native pipeline applies: numerically equal to
        # rnnt_loss_simple(calc_gradients=True) -> get_rnnt_prune_ranges ->
        # do_rnnt_pruning -> rnnt_loss_pruned(am_p + lm_p, ...) (parity-
        # tested in tests/test_losses.py), but the lattice is built once,
        # band-masked in-register, and the [B, T, s_range, C] logits are
        # never materialized.  bf16 inputs also store the lattice bf16
        # (recursion still computes f32 in-register).
        simple_loss, pruned_loss, _ranges = frt.rnnt_loss_simple_pruned(
            lm, am, symbols, 0, S_RANGE, boundary, rnnt_type=rnnt_type,
            reduction="sum", lattice_dtype=lattice_dtype, impl=impl,
        )
        return 0.5 * simple_loss + pruned_loss

    loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(am, lm)
    return loss, grads


def main():
    from fast_rnnt_tpu.utils.parity import (
        describe,
        enforce_parity,
        onchip_parity_gate,
    )
    from fast_rnnt_tpu.utils.profiling import (
        benchmark_fn,
        device_memory_stats,
        gpu_identity,
        require_gpu,
        setup_compile_cache,
    )

    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    cache = setup_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    devices = require_gpu()
    dev = devices[0]
    card = gpu_identity()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}")
    print(f"card (name, power limit): {card}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} compile_cache={cache}",
          flush=True)

    inputs = make_inputs()
    step = jax.jit(step_fn)
    # audio throughput: benchmark frames are 4x-subsampled 10 ms hops
    audio_seconds = float(np.asarray(inputs[3])[:, 3].sum()) * 0.04
    am, lm, symbols, boundary = inputs
    rows = []
    for name, args_ in (
        ("pruned_rnnt_train_step", inputs),
        ("pruned_rnnt_train_step_bf16_inputs",
         (am.astype(jnp.bfloat16), lm.astype(jnp.bfloat16), symbols, boundary)),
    ):
        avg_s = benchmark_fn(step, *args_, iters=ITERS)
        # the allocator's peak since the process started: the bf16 row's
        # figure includes the fp32 row's
        peak_mb = device_memory_stats(dev)["peak_mb_in_use"]
        rows.append({
            "metric": name,
            "value": round(avg_s * 1e6, 1),
            "unit": "us",
            "vs_baseline": round(BASELINE_US / (avg_s * 1e6), 3),
            "peak_mb_in_use_so_far": round(peak_mb, 1),
            "audio_seconds_per_s": round(audio_seconds / avg_s, 1),
            "device": device,
            "card": card,
            "workload": {"B": B, "T": T, "S": S, "C": C, "s_range": S_RANGE},
        })

    # compiled correctness gate on this device, on fresh inputs per commit
    salt, parity_seed = _round_salt()
    parity_inputs = make_inputs(seed=parity_seed)
    parity = onchip_parity_gate(*parity_inputs, s_range=S_RANGE)
    for k, line in describe(parity).items():
        print(f"parity {k}: {line}")
    enforce_parity(parity)
    parity = {k: (round(v, 8) if isinstance(v, float) else v)
              for k, v in parity.items()}
    parity.update(ok=True, salt=salt, input_hash=_input_hash(parity_inputs))
    rows[0]["parity"] = parity
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
