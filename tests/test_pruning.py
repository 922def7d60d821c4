"""Property tests of the pruning invariants documented (but untested) in the
reference (rnnt_loss.py:591-621, 673-677): monotonicity, bounded step,
start-at-0, last-symbol reachability."""

import jax.numpy as jnp
import numpy as np
import pytest

from fast_rnnt_tpu import (
    adjust_pruning_lower_bound,
    do_rnnt_pruning,
    get_rnnt_prune_ranges,
    rnnt_loss_simple,
)


def _grads(rng, B=3, T=12, S=6, C=10, rnnt_type="regular"):
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(0, C, size=(B, S)).astype(np.int32))
    se = rng.integers(2, S + 1, size=B).astype(np.int32)
    te = np.maximum(se + 1, rng.integers(S, T + 1, size=B)).astype(np.int32)
    boundary = jnp.asarray(
        np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), se, te], axis=1)
    )
    _, (px_grad, py_grad) = rnnt_loss_simple(
        lm,
        am,
        symbols,
        termination_symbol=0,
        boundary=boundary,
        rnnt_type=rnnt_type,
        reduction="none",
        calc_gradients=True,
    )
    return px_grad, py_grad, boundary, lm, am


def test_adjust_pruning_lower_bound_constraints():
    rng = np.random.default_rng(0)
    s_begin = jnp.asarray(rng.integers(0, 10, size=(4, 16)).astype(np.int32))
    for s_range in (2, 3, 5):
        out = np.asarray(adjust_pruning_lower_bound(s_begin, s_range))
        assert np.all(out[:, 0] == 0), "must start at symbol 0"
        diffs = out[:, 1:] - out[:, :-1]
        assert np.all(diffs >= 0), "must be monotone non-decreasing"
        assert np.all(diffs < s_range), "step must be < s_range"


@pytest.mark.parametrize("s_range", [2, 3, 5])
def test_prune_ranges_invariants(s_range):
    rng = np.random.default_rng(1)
    px_grad, py_grad, boundary, _, _ = _grads(rng)
    ranges = np.asarray(get_rnnt_prune_ranges(px_grad, py_grad, boundary, s_range))
    B, T, K = ranges.shape
    assert K == s_range
    starts = ranges[:, :, 0]
    assert np.all(starts[:, 0] == 0)
    diffs = starts[:, 1:] - starts[:, :-1]
    assert np.all(diffs >= 0)
    assert np.all(diffs < s_range)
    # windows are contiguous
    assert np.all(ranges == starts[:, :, None] + np.arange(s_range))
    # last real frame's window must reach the last symbol (rnnt_loss.py:731-748)
    bnd = np.asarray(boundary)
    for b in range(B):
        te, se = bnd[b, 3], bnd[b, 2]
        assert starts[b, te - 1] == max(se - s_range + 1, 0)
    # windows never index past S (the padded terminal row)
    S = px_grad.shape[1]
    assert ranges.max() <= S


def test_prune_ranges_clamps_large_s_range():
    rng = np.random.default_rng(2)
    px_grad, py_grad, boundary, _, _ = _grads(rng, S=3)
    ranges = np.asarray(get_rnnt_prune_ranges(px_grad, py_grad, boundary, 100))
    assert ranges.shape[2] == 4  # clamped to S + 1
    np.testing.assert_array_equal(ranges[:, :, 0], 0)


def test_prune_ranges_modified_step_bound():
    rng = np.random.default_rng(3)
    px_grad, py_grad, boundary, _, _ = _grads(rng, rnnt_type="modified")
    ranges = np.asarray(get_rnnt_prune_ranges(px_grad, py_grad, boundary, 4))
    starts = ranges[:, :, 0]
    diffs = starts[:, 1:] - starts[:, :-1]
    # modified emits at most 1 symbol/frame: step < 2
    assert np.all(diffs >= 0) and np.all(diffs < 2)


def test_do_rnnt_pruning_gather_semantics():
    rng = np.random.default_rng(4)
    px_grad, py_grad, boundary, lm, am = _grads(rng)
    ranges = get_rnnt_prune_ranges(px_grad, py_grad, boundary, 3)
    am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
    B, T, K = ranges.shape
    C = lm.shape[2]
    assert am_p.shape == (B, T, K, C) and lm_p.shape == (B, T, K, C)
    am_np, lm_np, r_np = np.asarray(am), np.asarray(lm), np.asarray(ranges)
    for b in range(B):
        for t in range(0, T, 5):
            for k in range(K):
                np.testing.assert_array_equal(np.asarray(am_p)[b, t, k], am_np[b, t])
                np.testing.assert_array_equal(
                    np.asarray(lm_p)[b, t, k], lm_np[b, r_np[b, t, k]]
                )


def test_s_range_too_small_raises():
    rng = np.random.default_rng(5)
    px_grad, py_grad, boundary, _, _ = _grads(rng)
    with pytest.raises(ValueError):
        get_rnnt_prune_ranges(px_grad, py_grad, boundary, 1)


def _window_argmax_np(gx, gy, K):
    """Brute-force window argmax (rnnt_loss.py:722-729): for each frame
    the start k maximizing sum(gy[k:k+K]) - gx[k-1] (gx[-1] = 0), first
    maximum on ties."""
    S1, B, T = gy.shape
    gx_pad = np.concatenate([np.zeros((1, B, gx.shape[2]), gx.dtype), gx])
    score = np.stack(
        [gy[k:k + K].sum(0) - gx_pad[k, :, :T] for k in range(S1 - K + 1)]
    )
    return np.argmax(score, axis=0).astype(np.int32)


def _adjust_np(s_begin, step):
    T = s_begin.shape[1]
    ramp = (step - 1) * np.arange(T)
    mlb = lambda v: np.minimum.accumulate(v[:, ::-1], axis=1)[:, ::-1]
    v = -(mlb(s_begin) - ramp)
    v = np.maximum(mlb(v), 0)
    return (-(v - ramp)).astype(np.int32)


def test_window_argmax_matches_numpy_oracle():
    """The cumsum+argmax formulation equals brute-force window sums,
    including first-max tie-breaking, across window widths and both px
    widths (values on a 1/4 grid so every sum is exact)."""
    from fast_rnnt_tpu.ops.pruning import _window_argmax

    rng = np.random.default_rng(17)
    for S, B, T, regular in [(6, 3, 10, True), (9, 2, 7, False)]:
        S1 = S + 1
        T1 = T + 1 if regular else T
        gx = np.round(rng.random((S, B, T1)) * 4).astype(np.float32) / 4
        gy = np.round(rng.random((S1, B, T)) * 4).astype(np.float32) / 4
        for K in (1, 2, 3, S1):
            want = _window_argmax_np(gx, gy, K)
            got = np.asarray(_window_argmax(jnp.asarray(gx), jnp.asarray(gy), K))
            np.testing.assert_array_equal(got, want, err_msg=f"S={S} K={K}")


def test_prune_ranges_rows_match_numpy_pipeline():
    """get_rnnt_prune_ranges_rows = window argmax + end-of-utterance padding
    + monotone/step-bound repair, each written out in numpy, for both rnnt
    shapes (adjust step 2 vs s_range) and ragged boundaries."""
    from fast_rnnt_tpu import get_rnnt_prune_ranges_rows

    rng = np.random.default_rng(23)
    for S, B, T, regular in [(6, 3, 12, True), (9, 5, 9, False), (4, 2, 140, True),
                             (4, 2, 128, True), (5, 9, 256, False)]:
        S1 = S + 1
        T1 = T + 1 if regular else T
        gx = np.round(rng.random((S, B, T1)) * 4).astype(np.float32) / 4
        gy = np.round(rng.random((S1, B, T)) * 4).astype(np.float32) / 4
        se = rng.integers(2, S + 1, size=B).astype(np.int32)
        te = np.clip(rng.integers(3, T + 1, size=B), 3, T).astype(np.int32)
        boundary = np.stack(
            [np.zeros(B, np.int32), np.zeros(B, np.int32), se, te], axis=1
        )
        for K in (2, 3, S1):
            step = K if regular else 2
            raw = _window_argmax_np(gx, gy, K)
            mask = np.arange(T)[None, :] < (te[:, None] - 1)
            pad = np.maximum(se[:, None] - K + 1, 0)
            want = _adjust_np(np.where(mask, raw, pad), step)
            got = np.asarray(get_rnnt_prune_ranges_rows(
                jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(boundary), K
            ))
            np.testing.assert_array_equal(
                got, want[:, :, None] + np.arange(K),
                err_msg=f"S={S} T={T} K={K} regular={regular}",
            )


def test_window_argmax_k1_exact_no_drift():
    """K=1 window sums must be EXACT (no cumsum-difference float drift):
    with width-1 windows the score is a direct read, so the argmax equals
    numpy's bit-for-bit even on adversarially near-tied random occupancies
    (the drift used to flip near-tie argmaxes and move the pruned band)."""
    from fast_rnnt_tpu.ops.pruning import _window_argmax

    rng = np.random.default_rng(11)
    for S, B, T in [(69, 8, 271), (7, 3, 40)]:
        S1 = S + 1
        # tiny magnitudes + many exact zeros: the near-tie regime
        gy = rng.random((S1, B, T)).astype(np.float32) * 1e-6
        gy[rng.random(gy.shape) < 0.7] = 0.0
        gx = rng.random((S, B, T)).astype(np.float32) * 1e-6
        gx[rng.random(gx.shape) < 0.7] = 0.0
        got = np.asarray(_window_argmax(jnp.asarray(gx), jnp.asarray(gy), 1))
        np.testing.assert_array_equal(
            got, _window_argmax_np(gx, gy, 1), err_msg=f"S={S} T={T}"
        )


def check_ranges_at_bench_shape(regular):
    """get_rnnt_prune_ranges_rows and adjust_pruning_lower_bound, jitted on
    the default device at the benchmark's shape (B=30, T=1000, S=100,
    s_range=5: the repair steps by 5 for regular lattices), against
    utils/parity.host_prune_ranges and the numpy repair.  Occupancies sit
    on a 1/4 grid, so every window sum is exact and ties break to the
    first maximum on both sides: the two must agree exactly."""
    import jax

    from fast_rnnt_tpu import get_rnnt_prune_ranges_rows
    from fast_rnnt_tpu.utils.parity import host_prune_ranges

    rng = np.random.default_rng(29)
    B, T, S, K = 30, 1000, 100, 5
    T1 = T + 1 if regular else T
    gx = np.round(rng.random((S, B, T1)) * 4).astype(np.float32) / 4
    gy = np.round(rng.random((S + 1, B, T)) * 4).astype(np.float32) / 4
    se = rng.integers(S // 2, S + 1, size=B).astype(np.int32)
    te = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    boundary = np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), se, te], 1)
    got = np.asarray(jax.jit(get_rnnt_prune_ranges_rows, static_argnums=3)(
        jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(boundary), K))
    _, raw, want = host_prune_ranges(gx, gy, boundary, K)
    np.testing.assert_array_equal(raw, _window_argmax_np(gx, gy, K))
    np.testing.assert_array_equal(got, want)

    step = K if regular else 2
    starts = rng.integers(0, S - K + 2, size=(B, T)).astype(np.int32)
    got = np.asarray(jax.jit(adjust_pruning_lower_bound, static_argnums=1)(
        jnp.asarray(starts), step))
    np.testing.assert_array_equal(got, _adjust_np(starts, step))


@pytest.mark.parametrize("regular", [True, False])
def test_ranges_match_host_at_bench_shape(regular):
    check_ranges_at_bench_shape(regular)
