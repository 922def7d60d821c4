"""Step time of the pruned pipeline at larger shapes (production mode,
ragged boundaries).

Run on the GPU:  python benchmarks/scaling.py
Prints one JSON line per shape.  Optional arg ``fp32`` re-runs the same
shapes in the fp32-faithful mode.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

import fast_rnnt_tpu as frt
from fast_rnnt_tpu.utils.profiling import benchmark_fn, gpu_identity

S_RANGE = 5
FP32 = "fp32" in sys.argv[1:]

SHAPES = [
    (30, 1000, 100, 500),
    (64, 1000, 100, 500),
    (128, 1000, 100, 500),
    (30, 4000, 100, 500),
    (8, 12000, 200, 500),
]


def run(B, T, S, C):
    rng = np.random.default_rng(0)
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    lattice_dtype = None
    if not FP32:
        am, lm = am.astype(jnp.bfloat16), lm.astype(jnp.bfloat16)
        lattice_dtype = jnp.bfloat16
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    t_end = np.clip(rng.integers(T // 2, T + 1, size=B), S + 2, T).astype(np.int32)
    s_end = np.clip(rng.integers(S // 2, S + 1, size=B), 2, S).astype(np.int32)
    boundary = jnp.asarray(
        np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end],
                 axis=1)
    )
    audio_s = float(t_end.sum()) * 0.04  # 40 ms effective hop (4x subsampled)

    def step(am_, lm_):
        def loss_fn(a, l):
            simple, pruned, _ = frt.rnnt_loss_simple_pruned(
                l, a, symbols, 0, S_RANGE, boundary, reduction="sum",
                lattice_dtype=lattice_dtype,
            )
            return simple + pruned

        return jax.value_and_grad(loss_fn, argnums=(0, 1))(am_, lm_)

    t = benchmark_fn(jax.jit(step), am, lm, iters=10)
    row = {
        "B": B, "T": T, "S": S, "C": C,
        "mode": "fp32" if FP32 else "production",
        "step_ms": round(t * 1e3, 2),
        "audio_s_per_s": round(audio_s / t, 1),
    }
    print(json.dumps(row), flush=True)


def main():
    print(json.dumps({"device": str(jax.devices()[0]), "card": gpu_identity()}),
          flush=True)
    for shape in SHAPES:
        run(*shape)


if __name__ == "__main__":
    main()
