"""Parity tests: XLA associative-scan recursion vs the independent numpy
oracle, plus autodiff-composability and boundary/edge-case checks.

This supplies the rigor the reference's own tests lack (its tests are
assertion-free smoke tests; see SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_rnnt_tpu import cummin, monotonic_lower_bound, mutual_information_recursion

from .oracle import mi_loop


def _random_pxpy(rng, B, S, T, modified=False, neg_inf_frac=0.0):
    T1 = T if modified else T + 1
    px = rng.normal(size=(B, S, T1)).astype(np.float32) * 2.0
    py = rng.normal(size=(B, S + 1, T)).astype(np.float32) * 2.0
    if not modified:
        px[:, :, -1] = -np.inf  # the standard "regular" last-frame column
    if neg_inf_frac:
        px[rng.random(px.shape) < neg_inf_frac] = -np.inf
        py[rng.random(py.shape) < neg_inf_frac] = -np.inf
    return px, py


def _random_boundary(rng, B, S, T, ragged=True):
    if not ragged:
        return np.tile(np.array([0, 0, S, T], dtype=np.int32), (B, 1))
    se = rng.integers(1, S + 1, size=B)
    te = np.maximum(rng.integers(1, T + 1, size=B), se)
    return np.stack(
        [np.zeros(B, np.int32), np.zeros(B, np.int32), se, te], axis=1
    ).astype(np.int32)


@pytest.mark.parametrize("modified", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_scores_and_occupancies_match_oracle(modified, ragged):
    rng = np.random.default_rng(1234)
    B, S, T = 3, 5, 9
    px, py = _random_pxpy(rng, B, S, T, modified=modified)
    boundary = _random_boundary(rng, B, S, T, ragged=ragged)

    ref_scores, ref_pxg, ref_pyg, _ = mi_loop(px, py, boundary)
    scores, (pxg, pyg) = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary), calc_gradients=True
    )

    np.testing.assert_allclose(scores, ref_scores, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pxg, ref_pxg, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pyg, ref_pyg, rtol=2e-4, atol=2e-5)


def test_boundary_optional_defaults_to_full():
    rng = np.random.default_rng(7)
    B, S, T = 2, 4, 6
    px, py = _random_pxpy(rng, B, S, T)
    full = np.tile(np.array([0, 0, S, T], dtype=np.int32), (B, 1))
    s_none = mutual_information_recursion(jnp.asarray(px), jnp.asarray(py))
    s_full = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(full)
    )
    np.testing.assert_allclose(s_none, s_full, rtol=1e-6)


def test_nonzero_begin_boundary():
    rng = np.random.default_rng(11)
    B, S, T = 2, 6, 10
    px, py = _random_pxpy(rng, B, S, T)
    boundary = np.array([[1, 2, 5, 9], [0, 0, 6, 10]], dtype=np.int32)
    ref_scores, ref_pxg, ref_pyg, _ = mi_loop(px, py, boundary)
    scores, (pxg, pyg) = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary), calc_gradients=True
    )
    np.testing.assert_allclose(scores, ref_scores, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pxg, ref_pxg, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pyg, ref_pyg, rtol=2e-4, atol=2e-5)
    # occupancies vanish outside the boundary rectangle
    assert np.all(np.asarray(pxg)[0, 5:, :] == 0)
    assert np.all(np.asarray(pyg)[0, :, 9:] == 0)
    assert np.all(np.asarray(pyg)[0, :, :2] == 0)


def test_occupancy_totals():
    """Total blank occupancy per utterance must equal t_end - t_begin, and
    (regular) total symbol occupancy must equal s_end - s_begin: every path
    crosses exactly that many arcs of each kind."""
    rng = np.random.default_rng(3)
    B, S, T = 4, 5, 8
    px, py = _random_pxpy(rng, B, S, T)
    boundary = _random_boundary(rng, B, S, T, ragged=True)
    _, (pxg, pyg) = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary), calc_gradients=True
    )
    np.testing.assert_allclose(
        np.asarray(pyg).sum(axis=(1, 2)), boundary[:, 3] - boundary[:, 1], rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(pxg).sum(axis=(1, 2)), boundary[:, 2] - boundary[:, 0], rtol=1e-4
    )


def test_grad_composes_with_jax_grad():
    """jax.grad of scores.sum() must equal the calc_gradients occupancies
    (the reference documents exactly this equivalence, __init__.py:108-113)."""
    rng = np.random.default_rng(5)
    B, S, T = 2, 4, 7
    px, py = _random_pxpy(rng, B, S, T)
    boundary = _random_boundary(rng, B, S, T)
    px_j, py_j, b_j = jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary)

    def total(px, py):
        return mutual_information_recursion(px, py, b_j).sum()

    gx, gy = jax.grad(total, argnums=(0, 1))(px_j, py_j)
    _, (pxg, pyg) = mutual_information_recursion(px_j, py_j, b_j, calc_gradients=True)
    np.testing.assert_allclose(gx, pxg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gy, pyg, rtol=1e-5, atol=1e-6)


def test_grad_scales_linearly_with_cotangent():
    rng = np.random.default_rng(6)
    B, S, T = 2, 3, 5
    px, py = _random_pxpy(rng, B, S, T)
    b = jnp.asarray(_random_boundary(rng, B, S, T))
    w = jnp.asarray([0.5, -2.0])

    def weighted(px, py):
        return (mutual_information_recursion(px, py, b) * w).sum()

    gx, gy = jax.grad(weighted, argnums=(0, 1))(jnp.asarray(px), jnp.asarray(py))
    _, (pxg, pyg) = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), b, calc_gradients=True
    )
    np.testing.assert_allclose(gx, w[:, None, None] * pxg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gy, w[:, None, None] * pyg, rtol=1e-5, atol=1e-6)


def test_grad_through_calc_gradients_path():
    """Differentiating a loss that used calc_gradients=True must give the
    same input grads (the fused op must be autodiff-transparent)."""
    rng = np.random.default_rng(8)
    B, S, T = 2, 3, 5
    px, py = _random_pxpy(rng, B, S, T)
    b = jnp.asarray(_random_boundary(rng, B, S, T))

    def loss_fused(px, py):
        scores, _ = mutual_information_recursion(px, py, b, calc_gradients=True)
        return scores.sum()

    def loss_plain(px, py):
        return mutual_information_recursion(px, py, b).sum()

    g1 = jax.grad(loss_fused, argnums=(0, 1))(jnp.asarray(px), jnp.asarray(py))
    g2 = jax.grad(loss_plain, argnums=(0, 1))(jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_allclose(g1[0], g2[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g1[1], g2[1], rtol=1e-5, atol=1e-6)


def test_finite_differences():
    rng = np.random.default_rng(9)
    B, S, T = 1, 3, 4
    px, py = _random_pxpy(rng, B, S, T)
    b = jnp.asarray(_random_boundary(rng, B, S, T, ragged=False))

    def total(px, py):
        return mutual_information_recursion(px, py, b).sum()

    gx, gy = jax.grad(total, argnums=(0, 1))(jnp.asarray(px), jnp.asarray(py))
    eps = 1e-3
    for (s, t) in [(0, 0), (1, 2), (2, 3)]:
        d = np.zeros_like(px)
        d[0, s, t] = eps
        f1 = total(jnp.asarray(px + d), jnp.asarray(py))
        f0 = total(jnp.asarray(px - d), jnp.asarray(py))
        np.testing.assert_allclose(
            (f1 - f0) / (2 * eps), gx[0, s, t], rtol=1e-2, atol=1e-3
        )


def test_neg_inf_inputs_no_nan():
    rng = np.random.default_rng(10)
    B, S, T = 2, 4, 6
    px, py = _random_pxpy(rng, B, S, T, neg_inf_frac=0.3)
    b = jnp.asarray(_random_boundary(rng, B, S, T))
    scores, (pxg, pyg) = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), b, calc_gradients=True
    )
    assert not np.any(np.isnan(np.asarray(scores)))
    assert not np.any(np.isnan(np.asarray(pxg)))
    assert not np.any(np.isnan(np.asarray(pyg)))
    ref_scores, ref_pxg, ref_pyg, _ = mi_loop(px, py, np.asarray(b))
    np.testing.assert_allclose(
        np.where(np.isneginf(ref_scores), -1e30, ref_scores),
        np.where(np.isneginf(np.asarray(scores)), -1e30, np.asarray(scores)),
        rtol=2e-5,
        atol=2e-5,
    )
    np.testing.assert_allclose(pxg, ref_pxg, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pyg, ref_pyg, rtol=2e-4, atol=2e-5)


def test_empty_sequence_boundary():
    """s_begin == s_end and t_begin == t_end gives score 0 (empty alignment)."""
    rng = np.random.default_rng(12)
    B, S, T = 2, 3, 4
    px, py = _random_pxpy(rng, B, S, T)
    b = jnp.asarray(np.array([[1, 2, 1, 2], [0, 0, 3, 4]], dtype=np.int32))
    scores = mutual_information_recursion(jnp.asarray(px), jnp.asarray(py), b)
    assert np.allclose(np.asarray(scores)[0], 0.0)


def test_jit_and_vmap():
    rng = np.random.default_rng(13)
    B, S, T = 4, 3, 5
    px, py = _random_pxpy(rng, B, S, T)
    b = jnp.asarray(_random_boundary(rng, B, S, T))
    f = jax.jit(lambda px, py, b: mutual_information_recursion(px, py, b))
    s1 = f(jnp.asarray(px), jnp.asarray(py), b)
    s2 = mutual_information_recursion(jnp.asarray(px), jnp.asarray(py), b)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


def test_cummin_and_monotonic_lower_bound():
    x = jnp.asarray(np.array([[0, 2, 1, 3, 6, 5, 8]], dtype=np.int32))
    # reference docstring example (rnnt_loss.py:560-563)
    out = monotonic_lower_bound(x)
    np.testing.assert_array_equal(np.asarray(out)[0], [0, 1, 1, 3, 5, 5, 8])
    y = jnp.asarray(np.array([[3, 1, 2, 0]], dtype=np.int32))
    np.testing.assert_array_equal(np.asarray(cummin(y))[0], [3, 1, 1, 0])
    rng = np.random.default_rng(0)
    z = jnp.asarray(rng.integers(0, 20, size=(3, 6)).astype(np.int32))
    m = np.asarray(monotonic_lower_bound(z))
    assert np.all(m[:, :-1] <= m[:, 1:])
    assert np.all(m <= np.asarray(z))


def test_recursion_float64():
    """Double-precision support (the reference instantiates float AND double
    kernels, mutual_information_cuda.cu:1015-1036); the XLA scan core is
    dtype-generic and reaches machine precision in f64."""
    with jax.enable_x64(True):
        rng = np.random.default_rng(0)
        B, S, T = 2, 5, 9
        px = jnp.asarray(rng.normal(size=(B, S, T + 1)) - 2.0)
        py = jnp.asarray(rng.normal(size=(B, S + 1, T)) - 2.0)
        assert px.dtype == jnp.float64
        s, (gx, gy) = mutual_information_recursion(
            px, py, None, calc_gradients=True, impl="xla"
        )
        ref_s, ref_gx, ref_gy, _ = mi_loop(px, py, None)
        np.testing.assert_allclose(np.asarray(s), ref_s, atol=1e-12)
        np.testing.assert_allclose(np.asarray(gx), ref_gx, atol=1e-12)
        np.testing.assert_allclose(np.asarray(gy), ref_gy, atol=1e-12)


@pytest.mark.parametrize(
    "trials", [6, pytest.param(12, marks=pytest.mark.slow)]
)
def test_fuzz_boundaries_incl_nonzero_begins(trials):
    """Property fuzz: random shapes and FULL random boundaries — including
    nonzero s_begin/t_begin, which the reference supports
    (mutual_information_cuda.cu:232-268) — against the loop oracle, for
    the default implementation and the XLA core.  6 trials in the default
    run; the full 12 behind -m slow (every trial is a fresh set of XLA
    compiles)."""
    rng = np.random.default_rng(2024)
    for trial in range(trials):
        B = int(rng.integers(1, 4))
        S = int(rng.integers(1, 7))
        T = int(rng.integers(2, 12))
        modified = bool(rng.integers(0, 2))
        px, py = _random_pxpy(rng, B, S, T, modified=modified)
        sb = rng.integers(0, S, size=B)
        se = rng.integers(sb + 1, S + 1, size=B) if S > 0 else sb
        tb = rng.integers(0, T // 2 + 1, size=B)
        # enough frames for a feasible alignment: modified consumes one
        # frame per symbol, so te - tb >= se - sb (sufficient for regular too)
        lo = np.minimum(tb + (se - sb), T)
        te = np.array([rng.integers(max(l, 1), T + 1) for l in lo])
        boundary = np.stack([sb, tb, se, te], axis=1).astype(np.int32)

        ref_scores, ref_gx, ref_gy, _ = mi_loop(px, py, boundary)
        for impl in (None, "xla"):
            s, (gx, gy) = mutual_information_recursion(
                jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary),
                calc_gradients=True, impl=impl,
            )
            np.testing.assert_allclose(
                np.asarray(s), ref_scores, rtol=2e-4, atol=1e-5,
                err_msg=f"trial {trial} impl={impl} boundary={boundary}",
            )
            np.testing.assert_allclose(
                np.asarray(gx), ref_gx, rtol=1e-3, atol=1e-5,
                err_msg=f"trial {trial} impl={impl}",
            )
            np.testing.assert_allclose(
                np.asarray(gy), ref_gy, rtol=1e-3, atol=1e-5,
                err_msg=f"trial {trial} impl={impl}",
            )


def test_f64_dtype_policy():
    """f64 inputs: auto-dispatch runs the dtype-generic XLA core even where
    the GPU kernels would be chosen (they cover float32/bfloat16 storage
    only), and an explicit impl="cuda" request raises instead of silently
    downcasting."""
    from fast_rnnt_tpu.ops import recursion as rec

    with jax.enable_x64(True):
        rng = np.random.default_rng(3)
        B, S, T = 2, 4, 7
        px = jnp.asarray(rng.normal(size=(B, S, T + 1)) - 1.0)
        py = jnp.asarray(rng.normal(size=(B, S + 1, T)) - 1.0)
        assert px.dtype == jnp.float64

        rows = (jnp.moveaxis(px, 1, 0), jnp.moveaxis(py, 1, 0))
        assert not rec._use_cuda(None, *rows)
        s = mutual_information_recursion(px, py, None)
        assert s.dtype == jnp.float64
        ref_s, _, _, _ = mi_loop(px, py, None)
        np.testing.assert_allclose(np.asarray(s), ref_s, atol=1e-12)

        with pytest.raises(TypeError, match="float32"):
            mutual_information_recursion(px, py, None, impl="cuda")


def test_bf16_storage_default_path():
    """bf16 px/py are a supported STORAGE dtype (upcast in-register, f32
    recursion): the default path must track the f32 result to bf16
    tolerance, keep f32 scores and return occupancies in bf16."""
    rng = np.random.default_rng(21)
    B, S, T = 2, 5, 9
    px, py = _random_pxpy(rng, B, S, T)
    s32 = mutual_information_recursion(jnp.asarray(px), jnp.asarray(py), None)
    sbf, (gx, gy) = mutual_information_recursion(
        jnp.asarray(px).astype(jnp.bfloat16),
        jnp.asarray(py).astype(jnp.bfloat16),
        None, calc_gradients=True,
    )
    assert sbf.dtype == jnp.float32  # scores always f32
    assert gx.dtype == jnp.bfloat16  # occupancies inherit storage dtype
    np.testing.assert_allclose(
        np.asarray(s32), np.asarray(sbf), rtol=5e-2, atol=0.1
    )
    occ = np.asarray(gx.astype(jnp.float32)).sum((1, 2)) + np.asarray(
        gy.astype(jnp.float32)
    ).sum((1, 2))
    # bf16 storage rounds each occupancy cell (~0.4%); flows sum to ~7%
    np.testing.assert_allclose(occ, S + T, rtol=8e-2)


def test_debug_self_check_passes_and_fails():
    """The opt-in backward round-trip check (the reference kernel's
    always-on debug identity, mutual_information_cuda.cu:510-514): passes
    on healthy inputs, raises when the occupancies are corrupted."""
    from fast_rnnt_tpu.ops.recursion import (
        occupancy_roundtrip_check,
        _raise_on_roundtrip_error,
    )

    rng = np.random.default_rng(11)
    B, S, T = 3, 5, 9
    px, py = _random_pxpy(rng, B, S, T)
    boundary = _random_boundary(rng, B, S, T)

    # healthy: runs clean through both code paths (with/without grads out)
    s1 = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary),
        debug_self_check=True,
    )
    s2, (gx, gy) = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary),
        calc_gradients=True, debug_self_check=True,
    )
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-6)

    # the identity itself: occupancies at the origin sum to the seed
    err = occupancy_roundtrip_check(
        gx, gy, jnp.asarray(boundary), jnp.ones((B,), jnp.float32)
    )
    assert float(jnp.max(err)) < 1e-3

    # corrupted occupancies must trip the raiser
    with pytest.raises(FloatingPointError, match="round-trip"):
        _raise_on_roundtrip_error(np.array([0.0, 0.5]), 1e-2)
    # NaN must also trip it
    with pytest.raises(FloatingPointError, match="round-trip"):
        _raise_on_roundtrip_error(np.array([np.nan]), 1e-2)


def test_debug_self_check_degenerate_boundaries():
    """Round-trip check on zero-length utterances: (sb,tb)==(se,te) makes
    the origin the seed cell itself."""
    B, S, T = 2, 3, 4
    px = np.full((B, S, T + 1), -1.0, np.float32)
    py = np.full((B, S + 1, T), -0.5, np.float32)
    boundary = np.array([[1, 2, 1, 2], [0, 0, 3, 4]], np.int32)
    s = mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary),
        debug_self_check=True,
    )
    assert np.asarray(s).shape == (B,)
    assert float(s[0]) == 0.0  # empty path scores 0


def test_debug_self_check_bf16_storage_no_spurious_raise():
    """bf16 STORAGE inputs round occupancies to ~1e-3: the self-check
    tolerance must be keyed on storage precision, not default to the f64
    bound (ADVICE r2: recursion.py)."""
    rng = np.random.default_rng(5)
    B, S, T = 3, 6, 11
    px, py = _random_pxpy(rng, B, S, T)
    s, (gx, gy) = mutual_information_recursion(
        jnp.asarray(px).astype(jnp.bfloat16),
        jnp.asarray(py).astype(jnp.bfloat16),
        None, calc_gradients=True, debug_self_check=True,
    )
    assert gx.dtype == jnp.bfloat16
    assert np.isfinite(np.asarray(s)).all()


def test_rows_api_f64_dtype_policy():
    """mutual_information_rows applies the same dtype policy as the
    (B,S,T)-major API: f64 runs on the XLA core; explicit "cuda" raises."""
    from fast_rnnt_tpu.ops import recursion as rec
    from fast_rnnt_tpu.ops.recursion import mutual_information_rows

    with jax.enable_x64(True):
        rng = np.random.default_rng(7)
        B, S, T = 2, 4, 7
        px, py = _random_pxpy(rng, B, S, T)
        px_rows = jnp.moveaxis(jnp.asarray(px, jnp.float64), 1, 0)
        py_rows = jnp.moveaxis(jnp.asarray(py, jnp.float64), 1, 0)
        boundary = jnp.asarray(_random_boundary(rng, B, S, T))

        assert not rec._use_cuda(None, px_rows, py_rows)
        s = mutual_information_rows(px_rows, py_rows, boundary)
        assert s.dtype == jnp.float64
        with pytest.raises(TypeError, match="float32"):
            mutual_information_rows(px_rows, py_rows, boundary, impl="cuda")
