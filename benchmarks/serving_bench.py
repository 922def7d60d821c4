"""Measure the cost of continuous batching: the server's device program
(slot reset fused with the streaming step, models/serving.py) vs the plain
streaming step, at serving batch sizes.

The reset is one fused ``where`` per state leaf, so the expectation is
~zero marginal cost — this script turns that expectation into a number
(the server's per-step overhead).

Run: python benchmarks/serving_bench.py   (uses the default device)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from fast_rnnt_tpu.models import (
    StreamingConfig,
    TransducerConfig,
    init_model,
    streaming_init,
    streaming_reset,
    streaming_step,
)


def _carried(step, state, *args, iters=150):
    """Seconds per call of ``state = step(state, *args)``, the state
    carried from call to call: host clock around ``block_until_ready``."""
    step = jax.jit(step)
    state = jax.block_until_ready(step(state, *args))  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state, *args)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / iters


def main(B=128, chunk=32, churn=6):
    cfg = TransducerConfig(causal=True, attention_left_context=32)
    model, params = init_model(jax.random.PRNGKey(0), cfg)
    scfg = StreamingConfig(chunk=chunk, max_len=256)

    rng = np.random.default_rng(0)
    feats = jnp.asarray(
        rng.normal(size=(B, chunk, cfg.feature_dim)).astype(np.float32)
    )
    lens = jnp.full((B,), chunk, jnp.int32)
    state = streaming_init(model, scfg, B)
    # a churn step re-arms `churn` slots for newly admitted streams
    reset = jnp.asarray(np.arange(B) < churn)

    def plain(st, fc, cl):
        new, _ = streaming_step(model, params, scfg, st, fc, cl)
        return new

    def served(st, rs, fc, cl):
        st = streaming_reset(model, scfg, st, rs)
        new, _ = streaming_step(model, params, scfg, st, fc, cl)
        return new

    def reset_only(st, rs, fc, cl):
        return streaming_reset(model, scfg, st, rs)

    def reset_enc(st, rs, fc, cl):
        st = dict(st, enc=streaming_reset(model, scfg, st, rs)["enc"])
        new, _ = streaming_step(model, params, scfg, st, fc, cl)
        return new

    dt_p = _carried(plain, state, feats, lens)
    dt_s = _carried(served, state, reset, feats, lens)
    dt_r = _carried(reset_only, state, reset, feats, lens)
    dt_e = _carried(reset_enc, state, reset, feats, lens)
    print(
        json.dumps(
            {
                "metric": "serving_reset_overhead",
                "slots": B,
                "churn_per_step": churn,
                "plain_step_us": round(dt_p * 1e6, 1),
                "server_step_us": round(dt_s * 1e6, 1),
                "overhead_us": round((dt_s - dt_p) * 1e6, 1),
                "reset_alone_us": round(dt_r * 1e6, 1),
                "reset_enc_only_step_us": round(dt_e * 1e6, 1),
                "device": str(jax.devices()[0]),
            }
        )
    )


if __name__ == "__main__":
    main()
