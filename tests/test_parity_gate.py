"""The bench parity gate itself (utils/parity.py): runs the four checks
at reduced shapes on the default path (the XLA core on the CPU; the GPU
kernels on a card) and checks every metric carries a limit and a
reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_rnnt_tpu.utils.parity import (
    TOLERANCES,
    describe,
    enforce_parity,
    onchip_parity_gate,
)


def test_parity_gate_passes():
    rng = np.random.default_rng(0)
    B, T, S, C = 4, 64, 12, 32
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    t_end = np.clip(rng.integers(T // 2, T + 1, size=B), S + 2, T).astype(np.int32)
    s_end = np.clip(rng.integers(S // 2, S + 1, size=B), 2, S).astype(np.int32)
    boundary = jnp.asarray(
        np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end], 1)
    )
    parity = onchip_parity_gate(am, lm, symbols, boundary, s_range=4)
    assert set(TOLERANCES) <= set(parity)
    assert parity["golden_cases"] == 5
    lines = describe(parity)
    assert set(lines) == set(TOLERANCES)
    assert all("(" in line for line in lines.values())
    enforce_parity(parity)  # must not raise


def test_enforce_parity_fails_loudly():
    good = {k: 0.0 for k in TOLERANCES}
    enforce_parity(good)
    bad = dict(good, golden_grads_max_abs_err=1.0)
    with pytest.raises(FloatingPointError, match="golden_grads_max_abs_err"):
        enforce_parity(bad)
    nan = dict(good, roundtrip_max_abs_err=float("nan"))
    with pytest.raises(FloatingPointError, match="roundtrip"):
        enforce_parity(nan)
