"""Stress test of the full pruned pipeline over an s_range sweep.

Mirrors the reference's only active test,
``test_rnnt_loss_pruned_stress`` (/root/reference/tf_fast_rnnt/python/
tests/simple_rnnt_loss_test.py:256-369: B=2, T<=200, S<=50, C=50,
s_range swept 5..50) — but with real assertions instead of prints
(the reference's tests only check "doesn't crash"; SURVEY.md §4):

  * losses finite and reductions consistent,
  * occupancy sums == s_end + t_end (total arc flow through the lattice),
  * pruning-range invariants (monotone, step < s_range, within [0, S]),
  * pruned loss >= unpruned loss (pruning removes paths),
  * pruned loss -> unpruned simple loss as s_range -> S+1,
  * gradients finite through the whole two-stage pipeline,
  * fast band-native path == materialized path at every s_range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fast_rnnt_tpu as frt


def _stress_inputs(seed=12345, B=2, T=200, S=50, C=50):
    rng = np.random.default_rng(seed)
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    t_end = np.array([T, T - 21], np.int32)
    s_end = np.array([S, S - 9], np.int32)
    boundary = jnp.asarray(
        np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end], 1)
    )
    return am, lm, symbols, boundary


@pytest.mark.parametrize(
    "s_range",
    [
        5,
        pytest.param(10, marks=pytest.mark.slow),
        pytest.param(20, marks=pytest.mark.slow),
        51,
    ],
)
def test_pruned_pipeline_stress(s_range):
    am, lm, symbols, boundary = _stress_inputs()
    B, T, C = am.shape
    S = lm.shape[1] - 1

    simple, (gx, gy) = frt.rnnt_loss_simple(
        lm, am, symbols, 0, boundary, reduction="none", calc_gradients=True
    )
    assert np.all(np.isfinite(np.asarray(simple)))
    # occupancy flow: sum of occupancies == path length s_end + t_end
    occ = np.asarray(gx.sum((1, 2)) + gy.sum((1, 2)))
    np.testing.assert_allclose(
        occ, np.asarray(boundary)[:, 2] + np.asarray(boundary)[:, 3], rtol=1e-3
    )

    ranges = frt.get_rnnt_prune_ranges(gx, gy, boundary, s_range)
    r = np.asarray(ranges)
    k = min(s_range, S + 1)
    assert r.shape == (B, T, k)
    assert r.min() >= 0 and r.max() <= S
    s_begin = r[:, :, 0]
    assert (np.diff(s_begin, axis=1) >= 0).all(), "s_begin must be monotone"
    assert (np.diff(s_begin, axis=1) < k).all(), "step must be < s_range"
    assert (s_begin[:, 0] == 0).all(), "window must start at 0"
    # window rows are contiguous
    assert (r == s_begin[:, :, None] + np.arange(k)).all()
    # last symbol reachable: window covers s_end-1 by t_end-1
    for b in range(B):
        te = int(np.asarray(boundary)[b, 3])
        se = int(np.asarray(boundary)[b, 2])
        assert s_begin[b, te - 1] + k >= se, (
            f"b={b}: window [{s_begin[b, te - 1]}, {s_begin[b, te - 1] + k})"
            f" misses s_end={se} at t_end-1"
        )

    def loss_marginal(am, lm):
        am_p, lm_p = frt.do_rnnt_pruning(am, lm, ranges)
        return jnp.sum(
            frt.rnnt_loss_pruned(
                am_p + lm_p, symbols, ranges, 0, boundary, reduction="none"
            )
        )

    def loss_fast(am, lm):
        return jnp.sum(
            frt.rnnt_loss_pruned_simple(
                lm, am, symbols, ranges, 0, boundary, reduction="none"
            )
        )

    (l_m, g_m) = jax.value_and_grad(loss_marginal, argnums=(0, 1))(am, lm)
    (l_f, g_f) = jax.value_and_grad(loss_fast, argnums=(0, 1))(am, lm)
    np.testing.assert_allclose(float(l_m), float(l_f), rtol=1e-4)
    np.testing.assert_allclose(g_m[0], g_f[0], rtol=1e-3, atol=3e-4)
    np.testing.assert_allclose(g_m[1], g_f[1], rtol=1e-3, atol=3e-4)
    assert np.all(np.isfinite(np.asarray(g_m[0])))
    assert np.all(np.isfinite(np.asarray(g_m[1])))

    # pruning removes paths => pruned loss >= unpruned simple loss, with
    # equality as the window covers the whole lattice
    total_simple = float(jnp.sum(simple))
    assert float(l_f) >= total_simple - 1e-2
    if s_range >= S + 1:
        np.testing.assert_allclose(float(l_f), total_simple, rtol=1e-4)


def test_pruned_loss_decreases_with_wider_windows():
    """Wider pruning windows keep more paths: loss non-increasing in s_range."""
    am, lm, symbols, boundary = _stress_inputs(seed=777, T=80, S=20)
    _, (gx, gy) = frt.rnnt_loss_simple(
        lm, am, symbols, 0, boundary, reduction="none", calc_gradients=True
    )
    losses = []
    for s_range in (2, 8, 21):
        ranges = frt.get_rnnt_prune_ranges(gx, gy, boundary, s_range)
        losses.append(
            float(
                frt.rnnt_loss_pruned_simple(
                    lm, am, symbols, ranges, 0, boundary, reduction="sum"
                )
            )
        )
    assert all(a >= b - 1e-2 for a, b in zip(losses, losses[1:])), losses


def _fuzz_module():
    import importlib.util
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "fuzz_onchip", os.path.join(root, "benchmarks", "fuzz_onchip.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["fuzz_onchip"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("i", range(3))
def test_component_fuzz_cpu_cases(i):
    """Cases of the fuzz sweep's component arm (benchmarks/fuzz_onchip.py)
    cut to CPU size: stage 1 vs a float64 recursion, the ranges vs the host
    restatement (tie-aware), stage 2 vs a float64 lattice, random shapes
    and rnnt_types.  The full sweep runs on the card."""
    mod = _fuzz_module()
    rng = np.random.default_rng(3 + i)
    case = mod.shrink(mod.draw(rng), B=4, T=96, S=24, s_range_max=24)
    cfg, errs, fail = mod.run_case(case, i)
    assert fail is None, (fail, cfg, errs)


@pytest.mark.parametrize("i", range(3))
def test_e2e_fuzz_cpu_cases(i):
    """Cases of the fuzz sweep's end-to-end arm: the fused
    rnnt_loss_{simple,smoothed}_pruned with delay_penalty and smoothing
    scales vs the materialized reference-shaped pipeline, on the CPU."""
    mod = _fuzz_module()
    rng = np.random.default_rng(7 + i)
    case = mod.shrink(mod.draw_e2e(rng), B=3, T=80, S=12, s_range_max=6)
    cfg, errs, fail = mod.run_case_e2e(case, i)
    assert fail is None, (fail, cfg, errs)
