"""The XLA lattice builds (simple and smoothed, b-major and s-major) and
their VJPs against the float64 numpy builds in tests/oracle.py, written
from the definition (log-softmax of the additive joiner) with no code in
common with fast_rnnt_tpu."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_rnnt_tpu import rnnt_loss_simple
from fast_rnnt_tpu.ops import lattice

from .oracle import lattice_simple, lattice_smoothed, numeric_vjp

RNNT_TYPES = ["regular", "modified", "constrained"]


def _inputs(rng, B, T, S, C):
    lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
    am = rng.normal(size=(B, T, C)).astype(np.float32)
    symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
    t_end = np.clip(rng.integers(max(2, T // 2), T + 1, size=B), 2, T)
    s_end = np.clip(rng.integers(max(1, S // 2), S + 1, size=B), 1, S)
    boundary = np.stack(
        [np.zeros(B, np.int32), np.zeros(B, np.int32),
         s_end.astype(np.int32), t_end.astype(np.int32)], axis=1
    )
    return lm, am, symbols, boundary


def _close(got, want, rtol=1e-5, atol=2e-5):
    got = np.asarray(jnp.asarray(got).astype(jnp.float32), np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _bmajor(rows):
    return tuple(jnp.moveaxis(x, 0, 1) for x in rows)


@pytest.mark.parametrize("with_boundary", [True, False])
@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_simple_build_matches_oracle(rnnt_type, with_boundary):
    rng = np.random.default_rng(0)
    lm, am, symbols, boundary = _inputs(rng, 3, 17, 5, 11)
    bnd = boundary if with_boundary else None
    want = lattice_simple(lm, am, symbols, 0, rnnt_type, bnd)
    got = lattice.get_rnnt_logprobs(
        jnp.asarray(lm), jnp.asarray(am), jnp.asarray(symbols), 0, rnnt_type,
        None if bnd is None else jnp.asarray(bnd),
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_rows_build_matches_oracle(rnnt_type):
    """The s-major build the pipelines use, at a width past one 128-lane
    tile (T = 129) and with C odd."""
    rng = np.random.default_rng(1)
    lm, am, symbols, boundary = _inputs(rng, 2, 129, 6, 13)
    want = lattice_simple(lm, am, symbols, 0, rnnt_type, boundary)
    got = lattice.get_rnnt_logprobs_rows(
        jnp.asarray(lm), jnp.asarray(am), jnp.asarray(symbols), 0, rnnt_type,
        jnp.asarray(boundary),
    )
    for g, w in zip(_bmajor(got), want):
        _close(g, w)


def _check_vjp(build_jax, build_np, lm, am, seed):
    """jax.vjp of the build (cotangents on finite entries) against the
    float64 central-difference gradient of the numpy build."""
    rng = np.random.default_rng(seed)
    px0, py0 = build_np(lm, am)
    gpx = rng.normal(size=px0.shape)
    gpy = rng.normal(size=py0.shape)

    def scalar(lm_, am_):
        px, py = build_jax(lm_, am_)
        return (jnp.sum(jnp.where(jnp.isfinite(px), gpx * px, 0.0))
                + jnp.sum(jnp.where(jnp.isfinite(py), gpy * py, 0.0)))

    g_lm, g_am = jax.grad(scalar, argnums=(0, 1))(jnp.asarray(lm), jnp.asarray(am))
    w_lm, w_am = numeric_vjp(build_np, lm, am, gpx, gpy)
    np.testing.assert_allclose(np.asarray(g_lm), w_lm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g_am), w_am, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_simple_build_vjp_matches_oracle(rnnt_type):
    rng = np.random.default_rng(2)
    lm, am, symbols, boundary = _inputs(rng, 2, 7, 3, 5)
    _check_vjp(
        lambda l, a: _bmajor(lattice.get_rnnt_logprobs_rows(
            l, a, jnp.asarray(symbols), 0, rnnt_type, jnp.asarray(boundary))),
        lambda l, a: lattice_simple(l, a, symbols, 0, rnnt_type, boundary),
        lm, am, seed=3,
    )


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
@pytest.mark.parametrize("scales", [(0.1, 0.1), (0.25, 0.0), (0.0, 0.3)])
def test_smoothed_build_matches_oracle(rnnt_type, scales):
    rng = np.random.default_rng(4)
    lm, am, symbols, boundary = _inputs(rng, 3, 21, 5, 9)
    want = lattice_smoothed(lm, am, symbols, 0, *scales, rnnt_type, boundary)
    got = lattice.get_rnnt_logprobs_smoothed(
        jnp.asarray(lm), jnp.asarray(am), jnp.asarray(symbols), 0, *scales,
        jnp.asarray(boundary), rnnt_type,
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_smoothed_rows_build_matches_oracle(rnnt_type):
    rng = np.random.default_rng(5)
    lm, am, symbols, boundary = _inputs(rng, 2, 33, 4, 10)
    want = lattice_smoothed(lm, am, symbols, 0, 0.15, 0.1, rnnt_type, boundary)
    got = lattice.get_rnnt_logprobs_smoothed_rows(
        jnp.asarray(lm), jnp.asarray(am), jnp.asarray(symbols), 0, 0.15, 0.1,
        jnp.asarray(boundary), rnnt_type,
    )
    for g, w in zip(_bmajor(got), want):
        _close(g, w)


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_smoothed_build_vjp_matches_oracle(rnnt_type):
    rng = np.random.default_rng(6)
    lm, am, symbols, boundary = _inputs(rng, 2, 6, 3, 5)
    _check_vjp(
        lambda l, a: _bmajor(lattice.get_rnnt_logprobs_smoothed_rows(
            l, a, jnp.asarray(symbols), 0, 0.2, 0.1, jnp.asarray(boundary),
            rnnt_type)),
        lambda l, a: lattice_smoothed(
            l, a, symbols, 0, 0.2, 0.1, rnnt_type, boundary),
        lm, am, seed=7,
    )


def test_rows_build_out_dtype_bf16():
    """out_dtype stores the lattice in bf16: the oracle rounded once."""
    rng = np.random.default_rng(8)
    lm, am, symbols, boundary = _inputs(rng, 2, 40, 5, 12)
    want = lattice_simple(lm, am, symbols, 0, "regular", boundary)
    px, py = lattice.get_rnnt_logprobs_rows(
        jnp.asarray(lm), jnp.asarray(am), jnp.asarray(symbols), 0, "regular",
        jnp.asarray(boundary), out_dtype=jnp.bfloat16,
    )
    assert px.dtype == py.dtype == jnp.bfloat16
    for g, w in zip(_bmajor((px, py)), want):
        _close(g, w, rtol=8e-3, atol=1e-2)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_nonzero_blank_build_matches_oracle(rnnt_type):
    """termination_symbol != 0: the blank reads follow the id."""
    rng = np.random.default_rng(11)
    B, T, S, C, blank = 3, 24, 5, 33, 7
    lm, am, _, boundary = _inputs(rng, B, T, S, C)
    symbols = rng.integers(0, C - 1, size=(B, S)).astype(np.int32)
    symbols = np.where(symbols >= blank, symbols + 1, symbols).astype(np.int32)
    want = lattice_simple(lm, am, symbols, blank, rnnt_type, boundary)
    got = lattice.get_rnnt_logprobs_rows(
        jnp.asarray(lm), jnp.asarray(am), jnp.asarray(symbols), blank,
        rnnt_type, jnp.asarray(boundary),
    )
    for g, w in zip(_bmajor(got), want):
        _close(g, w)


def test_nonzero_blank_relabel_invariance():
    """Relabeling the vocabulary (swap ids 0 <-> k in the logits, symbols
    and blank id) leaves loss and gradients unchanged up to the same
    permutation."""
    rng = np.random.default_rng(12)
    B, T, S, C, k = 2, 72, 5, 21, 9
    lm, am, _, boundary = (jnp.asarray(x) for x in _inputs(rng, B, T, S, C))
    symbols_np = rng.integers(1, C, size=(B, S)).astype(np.int32)
    swap = np.arange(C)
    swap[0], swap[k] = k, 0

    def loss(lm_, am_, sym, blank):
        return rnnt_loss_simple(lm_, am_, sym, blank, boundary, reduction="sum")

    ref, (glm, gam) = jax.value_and_grad(loss, argnums=(0, 1))(
        lm, am, jnp.asarray(symbols_np), 0
    )
    out, (glm2, gam2) = jax.value_and_grad(loss, argnums=(0, 1))(
        lm[:, :, swap], am[:, :, swap], jnp.asarray(swap[symbols_np]), k
    )
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(glm2, glm[:, :, swap], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gam2, gam[:, :, swap], rtol=1e-4, atol=1e-6)


def test_build_degenerate_shapes():
    """S = 0 (empty transcript) and T = 1 build without error and match
    the oracle."""
    rng = np.random.default_rng(13)
    for B, T, S, C in [(2, 6, 0, 5), (2, 1, 3, 5)]:
        lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
        am = rng.normal(size=(B, T, C)).astype(np.float32)
        symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
        for rnnt_type in ("regular", "modified"):
            want = lattice_simple(lm, am, symbols, 0, rnnt_type)
            got = lattice.get_rnnt_logprobs(
                jnp.asarray(lm), jnp.asarray(am), jnp.asarray(symbols), 0,
                rnnt_type,
            )
            for g, w in zip(got, want):
                assert g.shape == w.shape
                _close(g, w)
