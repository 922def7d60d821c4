"""End-to-end loss tests, including BASELINE config #1 (B=2 T=10 S=5 C=20)
against the numpy oracle and the full pruned pipeline of the reference
README (/root/reference/README.md:101-154)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_rnnt_tpu import (
    do_rnnt_pruning,
    get_rnnt_logprobs,
    get_rnnt_prune_ranges,
    rnnt_loss,
    rnnt_loss_pruned,
    rnnt_loss_pruned_simple,
    rnnt_loss_simple,
    rnnt_loss_simple_pruned,
    rnnt_loss_smoothed,
)

from .oracle import mi_loop


def _inputs(rng, B=2, T=10, S=5, C=20, ragged=True):
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(0, C, size=(B, S)).astype(np.int32))
    if ragged:
        se = rng.integers(1, S + 1, size=B).astype(np.int32)
        te = np.maximum(se, rng.integers(S, T + 1, size=B)).astype(np.int32)
    else:
        se = np.full(B, S, np.int32)
        te = np.full(B, T, np.int32)
    boundary = jnp.asarray(
        np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), se, te], axis=1)
    )
    return lm, am, symbols, boundary


@pytest.mark.parametrize("rnnt_type", ["regular", "modified", "constrained"])
def test_simple_loss_matches_oracle(rnnt_type):
    """BASELINE config #1: loss + occupancy grads vs the loop oracle."""
    rng = np.random.default_rng(1234)
    lm, am, symbols, boundary = _inputs(rng)
    px, py = get_rnnt_logprobs(lm, am, symbols, 0, rnnt_type, boundary)
    ref_scores, ref_pxg, ref_pyg, _ = mi_loop(
        np.asarray(px), np.asarray(py), np.asarray(boundary)
    )
    loss, (pxg, pyg) = rnnt_loss_simple(
        lm,
        am,
        symbols,
        termination_symbol=0,
        boundary=boundary,
        rnnt_type=rnnt_type,
        reduction="none",
        calc_gradients=True,
    )
    np.testing.assert_allclose(loss, -ref_scores, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pxg, ref_pxg, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pyg, ref_pyg, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_simple_equals_full_joiner_loss(rnnt_type):
    rng = np.random.default_rng(2)
    lm, am, symbols, boundary = _inputs(rng)
    logits = lm[:, None, :, :] + am[:, :, None, :]
    l1 = rnnt_loss_simple(
        lm, am, symbols, 0, boundary, rnnt_type, reduction="none"
    )
    l2 = rnnt_loss(logits, symbols, 0, boundary, rnnt_type, reduction="none")
    # fp32 matmul-trick vs logsumexp normalizers: ~1e-3-level differences
    np.testing.assert_allclose(l1, l2, rtol=2e-3, atol=2e-2)


def test_reductions():
    rng = np.random.default_rng(3)
    lm, am, symbols, boundary = _inputs(rng)
    ln = rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="none")
    lm_ = rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="mean")
    ls = rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="sum")
    np.testing.assert_allclose(np.asarray(ln).mean(), lm_, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ln).sum(), ls, rtol=1e-6)
    with pytest.raises(ValueError):
        rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="max")


def test_delay_penalty_changes_loss_and_runs_without_boundary():
    rng = np.random.default_rng(4)
    lm, am, symbols, boundary = _inputs(rng, ragged=False)
    l0 = rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="sum")
    l1 = rnnt_loss_simple(
        lm, am, symbols, 0, boundary, reduction="sum", delay_penalty=0.2
    )
    assert not np.allclose(np.asarray(l0), np.asarray(l1))
    # boundary=None delay-penalty path (broken in the reference,
    # rnnt_loss.py:312-314) must work here
    l2 = rnnt_loss_simple(lm, am, symbols, 0, None, reduction="sum", delay_penalty=0.2)
    assert np.isfinite(np.asarray(l2))
    np.testing.assert_allclose(l1, l2, rtol=1e-5)


def test_pruned_pipeline_full_range_equals_unpruned():
    """With s_range = S+1 the pruned loss must equal the unpruned joint loss
    exactly: the windows cover every symbol."""
    rng = np.random.default_rng(5)
    B, T, S, C = 3, 12, 6, 16
    lm, am, symbols, boundary = _inputs(rng, B=B, T=T, S=S, C=C)
    _, (pxg, pyg) = rnnt_loss_simple(
        lm, am, symbols, 0, boundary, reduction="none", calc_gradients=True
    )
    ranges = get_rnnt_prune_ranges(pxg, pyg, boundary, S + 1)
    am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
    logits_pruned = am_p + lm_p
    l_pruned = rnnt_loss_pruned(
        logits_pruned, symbols, ranges, 0, boundary, reduction="none"
    )
    logits = lm[:, None, :, :] + am[:, :, None, :]
    l_full = rnnt_loss(logits, symbols, 0, boundary, reduction="none")
    np.testing.assert_allclose(l_pruned, l_full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "s_range", [2, pytest.param(4, marks=pytest.mark.slow)]
)
def test_pruned_pipeline_end_to_end(s_range):
    """Reference README usage flow (README.md:101-154): simple loss w/ grads
    -> prune ranges -> pruning -> joiner -> pruned loss, plus jax.grad."""
    rng = np.random.default_rng(6)
    B, T, S, C = 3, 12, 6, 16
    lm, am, symbols, boundary = _inputs(rng, B=B, T=T, S=S, C=C)

    simple_loss, (pxg, pyg) = rnnt_loss_simple(
        lm, am, symbols, 0, boundary, reduction="none", calc_gradients=True
    )
    assert np.all(np.isfinite(np.asarray(simple_loss)))
    ranges = get_rnnt_prune_ranges(pxg, pyg, boundary, s_range)

    def pruned_loss_fn(am, lm):
        am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
        logits = am_p + lm_p
        return rnnt_loss_pruned(logits, symbols, ranges, 0, boundary, reduction="sum")

    loss, grads = jax.value_and_grad(pruned_loss_fn, argnums=(0, 1))(am, lm)
    assert np.isfinite(np.asarray(loss))
    assert np.all(np.isfinite(np.asarray(grads[0])))
    assert np.all(np.isfinite(np.asarray(grads[1])))
    # pruning can only remove paths: pruned total loss >= unpruned total loss
    logits = lm[:, None, :, :] + am[:, :, None, :]
    l_full = rnnt_loss(logits, symbols, 0, boundary, reduction="sum")
    assert np.asarray(loss) >= np.asarray(l_full) - 1e-3


def test_smoothed_loss_runs_and_matches_simple_at_zero():
    rng = np.random.default_rng(7)
    lm, am, symbols, boundary = _inputs(rng)
    l_simple = rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="none")
    l_sm0 = rnnt_loss_smoothed(
        lm, am, symbols, 0, 0.0, 0.0, boundary, reduction="none"
    )
    np.testing.assert_allclose(l_simple, l_sm0, rtol=1e-3, atol=1e-3)
    l_sm, (pxg, pyg) = rnnt_loss_smoothed(
        lm, am, symbols, 0, 0.1, 0.1, boundary, reduction="none", calc_gradients=True
    )
    assert np.all(np.isfinite(np.asarray(l_sm)))
    assert np.all(np.isfinite(np.asarray(pxg)))


def test_losses_differentiable_wrt_inputs():
    rng = np.random.default_rng(8)
    lm, am, symbols, boundary = _inputs(rng, B=2, T=6, S=3, C=8)

    g_lm, g_am = jax.grad(
        lambda lm, am: rnnt_loss_simple(lm, am, symbols, 0, boundary, reduction="sum"),
        argnums=(0, 1),
    )(lm, am)
    assert np.all(np.isfinite(np.asarray(g_lm)))
    assert np.all(np.isfinite(np.asarray(g_am)))
    # grads of the am/lm-shift-invariant loss sum to ~zero over the vocab
    np.testing.assert_allclose(np.asarray(g_am).sum(-1), 0.0, atol=1e-4)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified", "constrained"])
def test_pruned_simple_fast_path_matches_materialized(rnnt_type):
    """rnnt_loss_pruned_simple (band-native, no [B,T,K,C] logits) must be
    numerically equal to the materialized pipeline do_rnnt_pruning ->
    rnnt_loss_pruned(am_p + lm_p, ...) — losses AND gradients."""
    from fast_rnnt_tpu import rnnt_loss_pruned_simple

    rng = np.random.default_rng(42)
    lm, am, symbols, boundary = _inputs(rng, B=3, T=12, S=6, C=16)
    _, (pxg, pyg) = rnnt_loss_simple(
        lm, am, symbols, 0, boundary, reduction="sum", calc_gradients=True
    )
    # every (s_range, rnnt_type) pair is a distinct XLA compile on the one
    # slow CI core; regular sweeps two widths, the variants pin one
    for s_range in (2, 5) if rnnt_type == "regular" else (3,):
        ranges = get_rnnt_prune_ranges(
            pxg, pyg, boundary, s_range
        )

        def loss_ref(am, lm):
            am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
            return jnp.sum(
                rnnt_loss_pruned(
                    am_p + lm_p, symbols, ranges, 0, boundary,
                    rnnt_type=rnnt_type, reduction="none",
                )
            )

        def loss_fast(am, lm):
            return jnp.sum(
                rnnt_loss_pruned_simple(
                    lm, am, symbols, ranges, 0, boundary,
                    rnnt_type=rnnt_type, reduction="none",
                )
            )

        l_ref, g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1))(am, lm)
        l_fast, g_fast = jax.value_and_grad(loss_fast, argnums=(0, 1))(am, lm)
        np.testing.assert_allclose(l_ref, l_fast, rtol=1e-4)
        np.testing.assert_allclose(g_ref[0], g_fast[0], rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(g_ref[1], g_fast[1], rtol=1e-3, atol=2e-4)


def test_pruned_simple_fast_path_delay_penalty_and_reductions():
    from fast_rnnt_tpu import rnnt_loss_pruned_simple

    rng = np.random.default_rng(43)
    lm, am, symbols, boundary = _inputs(rng, B=3, T=12, S=6, C=16)
    _, (pxg, pyg) = rnnt_loss_simple(
        lm, am, symbols, 0, boundary, reduction="sum", calc_gradients=True
    )
    ranges = get_rnnt_prune_ranges(pxg, pyg, boundary, 3)

    def mk(fast, **kw):
        if fast:
            return rnnt_loss_pruned_simple(
                lm, am, symbols, ranges, 0, boundary, **kw
            )
        am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
        return rnnt_loss_pruned(
            am_p + lm_p, symbols, ranges, 0, boundary, **kw
        )

    for kw in (
        {"delay_penalty": 0.3, "reduction": "none"},
        {"reduction": "mean"},
        {"reduction": "sum"},
    ):
        np.testing.assert_allclose(
            np.asarray(mk(True, **kw)), np.asarray(mk(False, **kw)), rtol=1e-4
        )


@pytest.mark.parametrize("rnnt_type", ["regular", "modified", "constrained"])
def test_fused_simple_pruned_pipeline_matches_separate(rnnt_type):
    """rnnt_loss_simple_pruned (one lattice build, shared VJP) must equal
    the separate simple -> ranges -> pruned_simple calls exactly."""
    from fast_rnnt_tpu import rnnt_loss_pruned_simple, rnnt_loss_simple_pruned

    rng = np.random.default_rng(99)
    lm, am, symbols, boundary = _inputs(rng, B=3, T=12, S=6, C=16)
    s_range = 3

    def sep(am, lm):
        s, (gx, gy) = rnnt_loss_simple(
            lm, am, symbols, 0, boundary, rnnt_type=rnnt_type,
            reduction="none", calc_gradients=True,
        )
        ranges = get_rnnt_prune_ranges(gx, gy, boundary, s_range)
        p = rnnt_loss_pruned_simple(
            lm, am, symbols, ranges, 0, boundary, rnnt_type=rnnt_type,
            reduction="none",
        )
        return s, p, ranges

    def fused(am, lm):
        return rnnt_loss_simple_pruned(
            lm, am, symbols, 0, s_range, boundary, rnnt_type=rnnt_type,
            reduction="none",
        )

    s1, p1, r1 = sep(am, lm)
    s2, p2, r2 = fused(am, lm)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))

    g1 = jax.grad(lambda am, lm: jnp.sum(sep(am, lm)[1]), argnums=(0, 1))(am, lm)
    g2 = jax.grad(lambda am, lm: jnp.sum(fused(am, lm)[1]), argnums=(0, 1))(am, lm)
    np.testing.assert_allclose(g1[0], g2[0], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(g1[1], g2[1], rtol=1e-3, atol=2e-4)


def test_fused_pipeline_delay_penalty():
    from fast_rnnt_tpu import rnnt_loss_pruned_simple, rnnt_loss_simple_pruned

    rng = np.random.default_rng(100)
    lm, am, symbols, boundary = _inputs(rng, B=2, T=10, S=5, C=12)
    s, (gx, gy) = rnnt_loss_simple(
        lm, am, symbols, 0, boundary, delay_penalty=0.2,
        reduction="none", calc_gradients=True,
    )
    ranges = get_rnnt_prune_ranges(gx, gy, boundary, 3)
    p = rnnt_loss_pruned_simple(
        lm, am, symbols, ranges, 0, boundary, delay_penalty=0.2, reduction="none"
    )
    s2, p2, r2 = rnnt_loss_simple_pruned(
        lm, am, symbols, 0, 3, boundary, delay_penalty=0.2, reduction="none"
    )
    np.testing.assert_allclose(np.asarray(s), np.asarray(s2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p2), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(ranges), np.asarray(r2))


@pytest.mark.slow
def test_smoothed_full_grad_check_config3():
    """BASELINE config #3: rnnt_loss_smoothed at B=8 T=200 S=40 C=500 with a
    full gradient check (finiteness, vocab-shift invariance, occupancy
    consistency with jax.grad).  The full size is slow-marked; the same
    checks run at reduced size in the default suite below."""
    _smoothed_grad_check(B=8, T=200, S=40, C=500)


def test_smoothed_full_grad_check_small():
    _smoothed_grad_check(B=3, T=48, S=10, C=64)


def _smoothed_grad_check(B, T, S, C):
    rng = np.random.default_rng(3)
    lm, am, symbols, boundary = _inputs(rng, B=B, T=T, S=S, C=C)

    def loss_fn(lm, am):
        return rnnt_loss_smoothed(
            lm, am, symbols, 0, 0.25, 0.1, boundary, reduction="sum"
        )

    loss, (g_lm, g_am) = jax.value_and_grad(loss_fn, argnums=(0, 1))(lm, am)
    assert np.isfinite(float(loss))
    assert np.all(np.isfinite(np.asarray(g_lm)))
    assert np.all(np.isfinite(np.asarray(g_am)))
    # loss is invariant to per-(b, t) shifts of am (softmax-normalized), so
    # the am grad sums to ~0 over the vocab
    np.testing.assert_allclose(
        np.asarray(g_am).sum(-1), 0.0, atol=2e-3
    )

    # calc_gradients occupancies == jax.grad of the negated-sum scores
    _, (pxg, pyg) = rnnt_loss_smoothed(
        lm, am, symbols, 0, 0.25, 0.1, boundary,
        reduction="none", calc_gradients=True,
    )
    occ = np.asarray(pxg.sum((1, 2)) + pyg.sum((1, 2)))
    np.testing.assert_allclose(
        occ, np.asarray(boundary)[:, 2] + np.asarray(boundary)[:, 3], rtol=1e-3
    )


def test_fused_pipeline_boundary_none():
    """boundary=None must work through the fused pipeline (the package
    lifts the reference's mandatory-boundary limitation everywhere)."""
    from fast_rnnt_tpu import rnnt_loss_simple_pruned

    rng = np.random.default_rng(5)
    lm, am, symbols, _ = _inputs(rng, B=2, T=10, S=5, C=12, ragged=False)
    s, p, r = rnnt_loss_simple_pruned(
        lm, am, symbols, 0, 3, None, reduction="none"
    )
    B, S = symbols.shape
    T = am.shape[1]
    full = jnp.asarray(
        np.tile(np.array([0, 0, S, T], np.int32), (B, 1))
    )
    s2, p2, r2 = rnnt_loss_simple_pruned(
        lm, am, symbols, 0, 3, full, reduction="none"
    )
    np.testing.assert_allclose(np.asarray(s), np.asarray(s2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p2), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(r), np.asarray(r2))


def test_smoothed_no_nan_when_scales_sum_to_one():
    """combined_scale == 0 (lm_only + am_only == 1) must not produce NaN
    from 0 * -inf (a latent bug in the reference, which floors only the
    lm/am scales, rnnt_loss.py:1344-1349)."""
    rng = np.random.default_rng(6)
    lm, am, symbols, boundary = _inputs(rng, B=2, T=8, S=4, C=10)
    loss = rnnt_loss_smoothed(
        lm, am, symbols, 0, 0.5, 0.5, boundary, reduction="none"
    )
    assert np.all(np.isfinite(np.asarray(loss))), loss


def test_fused_smoothed_pipeline_matches_reference_shaped():
    """rnnt_loss_smoothed_pruned must equal the reference's own test
    pipeline (simple_rnnt_loss_test.py:108-143): smoothed w/ grads ->
    ranges -> do_rnnt_pruning -> rnnt_loss_pruned(am_p + lm_p)."""
    from fast_rnnt_tpu import rnnt_loss_smoothed_pruned

    rng = np.random.default_rng(202)
    lm, am, symbols, boundary = _inputs(rng, B=3, T=12, S=6, C=16)
    s_range = 3

    sm, (gx, gy) = rnnt_loss_smoothed(
        lm, am, symbols, 0, 0.25, 0.1, boundary,
        reduction="none", calc_gradients=True,
    )
    ranges = get_rnnt_prune_ranges(gx, gy, boundary, s_range)
    am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
    pr = rnnt_loss_pruned(
        am_p + lm_p, symbols, ranges, 0, boundary, reduction="none"
    )

    sm2, pr2, r2 = rnnt_loss_smoothed_pruned(
        lm, am, symbols, 0, s_range, 0.25, 0.1, boundary, reduction="none"
    )
    np.testing.assert_allclose(np.asarray(sm), np.asarray(sm2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(pr), np.asarray(pr2), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(ranges), np.asarray(r2))

    g1 = jax.grad(
        lambda am, lm: jnp.sum(
            rnnt_loss_pruned(
                (lambda t: t[0] + t[1])(do_rnnt_pruning(am, lm, ranges)),
                symbols, ranges, 0, boundary, reduction="none",
            )
        ),
        argnums=(0, 1),
    )(am, lm)
    g2 = jax.grad(
        lambda am, lm: jnp.sum(
            rnnt_loss_smoothed_pruned(
                lm, am, symbols, 0, s_range, 0.25, 0.1, boundary,
                reduction="none",
            )[1]
        ),
        argnums=(0, 1),
    )(am, lm)
    np.testing.assert_allclose(g1[0], g2[0], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(g1[1], g2[1], rtol=1e-3, atol=2e-4)


def test_bfloat16_inputs_mixed_precision():
    """bf16 am/lm inputs (the mixed-precision mode): the lattice promotes to fp32 where it matters (normalizer
    einsums accumulate in fp32; the recursion runs fp32 after the f32
    normalizer subtraction), so losses match fp32 to ~1e-3 relative and
    grads stay finite."""
    from fast_rnnt_tpu import rnnt_loss_simple_pruned

    rng = np.random.default_rng(77)
    lm, am, symbols, boundary = _inputs(rng, B=3, T=12, S=6, C=16)

    def total(am, lm):
        s, p, _ = rnnt_loss_simple_pruned(
            lm, am, symbols, 0, 3, boundary, reduction="sum"
        )
        return 0.5 * s + p

    l32, g32 = jax.value_and_grad(total, argnums=(0, 1))(am, lm)
    lbf, gbf = jax.value_and_grad(total, argnums=(0, 1))(
        am.astype(jnp.bfloat16), lm.astype(jnp.bfloat16)
    )
    np.testing.assert_allclose(
        float(l32), float(lbf), rtol=2e-3
    )
    assert gbf[0].dtype == jnp.bfloat16
    assert np.all(np.isfinite(np.asarray(gbf[0], np.float32)))
    assert np.all(np.isfinite(np.asarray(gbf[1], np.float32)))
    np.testing.assert_allclose(
        np.asarray(g32[0]), np.asarray(gbf[0], np.float32), atol=0.05
    )


def test_rnnt_loss_chunked_matches_materialized():
    """rnnt_loss_chunked (joiner streamed over T-chunks with remat) must
    equal rnnt_loss on the materialized joiner output — values AND
    gradients w.r.t. the pre-joiner features — for a real (non-additive)
    joiner, including a T that does not divide the chunk size."""
    from fast_rnnt_tpu import rnnt_loss_chunked

    rng = np.random.default_rng(31)
    B, T, S, C, D = 2, 11, 4, 12, 8
    am = jnp.asarray(rng.normal(size=(B, T, D)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, D)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(D, C)).astype(np.float32) * 0.5)
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    boundary = jnp.asarray(
        np.stack(
            [np.zeros(B, np.int32), np.zeros(B, np.int32),
             np.array([S, S - 1], np.int32), np.array([T, T - 3], np.int32)],
            axis=1,
        )
    )

    def joiner(am_c, lm_full):
        return jnp.tanh(am_c[:, :, None, :] + lm_full[:, None, :, :]) @ w

    def loss_materialized(am, lm):
        logits = joiner(am, lm)
        return rnnt_loss(logits, symbols, 0, boundary, reduction="sum")

    def loss_chunked(am, lm):
        return rnnt_loss_chunked(
            joiner, am, lm, symbols, 0, boundary, reduction="sum", chunk=4
        )

    lm_, gm = jax.value_and_grad(loss_materialized, argnums=(0, 1))(am, lm)
    lc_, gc = jax.value_and_grad(loss_chunked, argnums=(0, 1))(am, lm)
    np.testing.assert_allclose(float(lm_), float(lc_), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gm[0]), np.asarray(gc[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gm[1]), np.asarray(gc[1]),
                               rtol=1e-4, atol=1e-5)


def test_rnnt_loss_chunked_memory_is_chunk_bound():
    """The chunked path's compiled peak must be far below the materialized
    path's (which holds the [B,T,S+1,C] tensor) — the point of the API."""
    from fast_rnnt_tpu import rnnt_loss_chunked

    def compiled_peak_mb(fn, *args):
        """XLA's allocation sizes for the compiled program (arguments +
        outputs + temporaries - aliases): a property of the program, not a
        device measurement."""
        ma = jax.jit(fn).lower(*args).compile().memory_analysis()
        return (ma.argument_size_in_bytes + ma.output_size_in_bytes
                + ma.temp_size_in_bytes - ma.alias_size_in_bytes) / 2**20

    rng = np.random.default_rng(32)
    B, T, S, C, D = 2, 256, 24, 256, 16
    am = jnp.asarray(rng.normal(size=(B, T, D)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, D)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(D, C)).astype(np.float32) * 0.5)
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))

    def joiner(am_c, lm_full):
        return jnp.tanh(am_c[:, :, None, :] + lm_full[:, None, :, :]) @ w

    def loss_materialized(am, lm):
        return jnp.sum(jax.grad(
            lambda a: rnnt_loss(joiner(a, lm), symbols, 0, None, reduction="sum")
        )(am))

    def loss_chunked(am, lm):
        return jnp.sum(jax.grad(
            lambda a: rnnt_loss_chunked(
                joiner, a, lm, symbols, 0, None, reduction="sum", chunk=32
            )
        )(am))

    mb_mat = compiled_peak_mb(loss_materialized, am, lm)
    mb_chk = compiled_peak_mb(loss_chunked, am, lm)
    # materialized holds several [B,T,S+1,C] = 13 MB tensors; chunked holds
    # [B,32,S+1,C] = 1.6 MB transients
    assert mb_chk < 0.45 * mb_mat, (mb_chk, mb_mat)


def test_bf16_lattice_mode():
    """lattice_dtype=bf16 (the full mixed-precision production mode: narrow
    HBM storage, f32 in-register recursion) must track the fp32 pipeline
    to bf16-level tolerance for losses, ranges, and gradients."""
    from fast_rnnt_tpu import rnnt_loss_simple_pruned

    rng = np.random.default_rng(88)
    lm, am, symbols, boundary = _inputs(rng, B=3, T=12, S=6, C=16)

    def total(am, lm, dt):
        s, p, r = rnnt_loss_simple_pruned(
            lm, am, symbols, 0, 3, boundary, reduction="sum",
            lattice_dtype=dt,
        )
        return 0.5 * s + p, r

    l32, g32 = jax.value_and_grad(
        lambda a, l: total(a, l, None)[0], argnums=(0, 1)
    )(am, lm)
    lbf, gbf = jax.value_and_grad(
        lambda a, l: total(a, l, jnp.bfloat16)[0], argnums=(0, 1)
    )(am, lm)
    np.testing.assert_allclose(float(l32), float(lbf), rtol=5e-3)
    # ranges from bf16 occupancies stay valid windows
    _, rbf = jax.jit(lambda a, l: total(a, l, jnp.bfloat16))(am, lm)
    rb = np.asarray(rbf)
    assert (np.diff(rb[:, :, 0], axis=1) >= 0).all()
    assert rb.min() >= 0
    # gradients finite and close at bf16 tolerance
    for a, b in zip(g32, gbf):
        assert np.all(np.isfinite(np.asarray(b)))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=0.06
        )


def test_rnnt_loss_chunked_calc_gradients_parity():
    """Chunked-path occupancies must equal the materialized path's — the
    chunked stage 1 feeds get_rnnt_prune_ranges for real joiners
    (VERDICT r2 item 4)."""
    from fast_rnnt_tpu import rnnt_loss_chunked

    rng = np.random.default_rng(41)
    B, T, S, C, D = 2, 13, 5, 12, 8
    am = jnp.asarray(rng.normal(size=(B, T, D)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, D)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(D, C)).astype(np.float32) * 0.5)
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    boundary = jnp.asarray(
        np.stack(
            [np.zeros(B, np.int32), np.zeros(B, np.int32),
             np.array([S, S - 2], np.int32), np.array([T, T - 4], np.int32)],
            axis=1,
        )
    )

    def joiner(am_c, lm_full):
        return jnp.tanh(am_c[:, :, None, :] + lm_full[:, None, :, :]) @ w

    l_mat, (gx_m, gy_m) = rnnt_loss(
        joiner(am, lm), symbols, 0, boundary, reduction="none",
        calc_gradients=True,
    )
    l_chk, (gx_c, gy_c) = rnnt_loss_chunked(
        joiner, am, lm, symbols, 0, boundary, reduction="none",
        chunk=4, calc_gradients=True,
    )
    np.testing.assert_allclose(np.asarray(l_mat), np.asarray(l_chk), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gx_m), np.asarray(gx_c),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gy_m), np.asarray(gy_c),
                               rtol=1e-4, atol=1e-6)


def test_chunked_two_stage_pipeline():
    """End-to-end REAL-joiner two-stage training recipe with a chunked
    stage 1: chunked loss + occupancies -> get_rnnt_prune_ranges ->
    do_rnnt_pruning -> rnnt_loss_pruned.  Must equal the fully
    materialized pipeline (ranges AND pruned loss AND its gradients)
    without ever building [B, T, S+1, C] in stage 1."""
    from fast_rnnt_tpu import rnnt_loss_chunked

    rng = np.random.default_rng(42)
    B, T, S, C, D = 2, 24, 8, 16, 8
    s_range = 3
    am = jnp.asarray(rng.normal(size=(B, T, D)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, D)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(D, C)).astype(np.float32) * 0.5)
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    boundary = jnp.asarray(
        np.stack(
            [np.zeros(B, np.int32), np.zeros(B, np.int32),
             np.array([S, S - 3], np.int32), np.array([T, T - 7], np.int32)],
            axis=1,
        )
    )

    def joiner(am_c, lm_full):
        return jnp.tanh(am_c[:, :, None, :] + lm_full[:, None, :, :]) @ w

    def stage2(am, lm, ranges):
        # the pruned stage materializes only [B, T, s_range, C]
        am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
        logits_p = jnp.tanh(am_p + lm_p) @ w
        return rnnt_loss_pruned(
            logits_p, symbols, ranges, 0, boundary, reduction="sum"
        )

    # materialized reference pipeline
    _, (gx_m, gy_m) = rnnt_loss(
        joiner(am, lm), symbols, 0, boundary, reduction="none",
        calc_gradients=True,
    )
    ranges_m = get_rnnt_prune_ranges(gx_m, gy_m, boundary, s_range)
    lp_m, gp_m = jax.value_and_grad(lambda a: stage2(a, lm, ranges_m))(am)

    # chunked stage-1 pipeline
    _, (gx_c, gy_c) = rnnt_loss_chunked(
        joiner, am, lm, symbols, 0, boundary, reduction="none",
        chunk=8, calc_gradients=True,
    )
    ranges_c = get_rnnt_prune_ranges(gx_c, gy_c, boundary, s_range)
    np.testing.assert_array_equal(np.asarray(ranges_m), np.asarray(ranges_c))
    lp_c, gp_c = jax.value_and_grad(lambda a: stage2(a, lm, ranges_c))(am)
    np.testing.assert_allclose(float(lp_m), float(lp_c), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gp_m), np.asarray(gp_c), rtol=1e-5,
                               atol=1e-7)


def test_constrained_s_range_1_raises():
    """Width-1 pruning bands are provably infeasible for constrained
    RNN-T (the px fix needs py of the NEXT row at t+1, which is outside
    the band) — fuzz finding; the reference silently returns inf, we
    raise.  Covers the fused, band-native and materialized paths."""
    from fast_rnnt_tpu import (
        do_rnnt_pruning,
        rnnt_loss_pruned,
        rnnt_loss_pruned_simple,
        rnnt_loss_simple_pruned,
    )

    rng = np.random.default_rng(5)
    B, T, S, C = 2, 12, 4, 8
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    boundary = jnp.asarray(
        np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32),
                  np.full(B, S, np.int32), np.full(B, T, np.int32)], axis=1))
    ranges = jnp.zeros((B, T, 1), jnp.int32)

    with pytest.raises(ValueError, match="constrained.*s_range >= 2"):
        rnnt_loss_simple_pruned(
            lm, am, symbols, 0, 1, boundary, rnnt_type="constrained")
    with pytest.raises(ValueError, match="constrained.*s_range >= 2"):
        rnnt_loss_pruned_simple(
            lm, am, symbols, ranges, 0, boundary, "constrained")
    am_p, lm_p = do_rnnt_pruning(am, lm, ranges)
    with pytest.raises(ValueError, match="constrained.*s_range >= 2"):
        rnnt_loss_pruned(am_p + lm_p, symbols, ranges, 0, boundary,
                         "constrained")
    # modified stays legal at s_range=1
    out = rnnt_loss_simple_pruned(
        lm, am, symbols, 0, 1, boundary, rnnt_type="modified",
        reduction="none")
    assert np.all(np.isfinite(np.asarray(out[0])))


@pytest.mark.parametrize("layout", ["rows", "bst"])
def test_delay_penalty_on_bf16_lattice_rounds_once(layout):
    """On a bfloat16 lattice the delay penalty is computed in float32 and
    the sum rounded once into px: frame indices past 256 and the scale 0.3
    stay exact, so each entry is within half a bf16 ulp of the exact sum.
    (Computed in bf16, 0.3 rounded to 0.30078 and t=257 to 256: a
    systematic error of several nats on a pruned loss, found by the fuzz
    sweep's end-to-end arm.)"""
    from fast_rnnt_tpu.ops import losses

    rng = np.random.default_rng(41)
    B, S, T = 2, 3, 400
    t_end = np.array([T, T - 57])
    boundary = jnp.asarray(np.stack(
        [np.zeros(B, np.int32), np.zeros(B, np.int32), np.full(B, S, np.int32),
         t_end.astype(np.int32)], axis=1))
    px = jnp.asarray((rng.normal(size=(B, S, T + 1)) * 5).astype(np.float32))
    px = px.astype(jnp.bfloat16)
    penalty = ((t_end[:, None, None] - 1) / 2.0 - np.arange(T + 1)) * 0.3
    want = np.asarray(px, np.float64) + penalty
    if layout == "rows":
        got = losses._apply_delay_penalty_rows(
            jnp.moveaxis(px, 1, 0), boundary, "regular", 0.3)
        got = jnp.moveaxis(got, 0, 1)
    else:
        got = losses._apply_delay_penalty(px, boundary, "regular", 0.3)
    assert got.dtype == jnp.bfloat16
    half_ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 8)
    assert np.all(np.abs(np.asarray(got, np.float64) - want) <= half_ulp * 1.001)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_bf16_lattice_with_delay_penalty_tracks_f32(rnnt_type):
    """lattice_dtype=bfloat16 with a delay penalty at T=400: px, which
    carries a penalty up to 60 nats here, stays float32 and only py is
    narrowed, so the simple loss and the pruned loss (on the same ranges)
    stay within 0.1 nats of the float32 lattice's per utterance.  Storing
    px + penalty in bf16, with the penalty computed in bf16, was 0.3 and
    8.5 nats off."""
    rng = np.random.default_rng(43)
    B, T, S, C, K = 2, 400, 30, 40, 4
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32)).astype(jnp.bfloat16)
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32)).astype(jnp.bfloat16)
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    boundary = jnp.asarray(np.array([[0, 0, S, T], [0, 0, S - 5, T - 60]], np.int32))
    simple, pruned, ranges = rnnt_loss_simple_pruned(
        lm, am, symbols, 0, K, boundary, rnnt_type, delay_penalty=0.3,
        reduction="none", lattice_dtype=jnp.bfloat16,
    )
    simple32, _, _ = rnnt_loss_simple_pruned(
        lm, am, symbols, 0, K, boundary, rnnt_type, delay_penalty=0.3,
        reduction="none",
    )
    pruned32 = rnnt_loss_pruned_simple(
        lm, am, symbols, ranges, 0, boundary, rnnt_type, delay_penalty=0.3,
        reduction="none",
    )
    np.testing.assert_allclose(np.asarray(simple), np.asarray(simple32), atol=0.1, rtol=0)
    np.testing.assert_allclose(np.asarray(pruned), np.asarray(pruned32), atol=0.1, rtol=0)
