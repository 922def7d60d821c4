"""The XLA scan core of the recursion (the reference the GPU kernels are
judged against) checked against two independent implementations: the
float64 loop oracle (tests/oracle.py) and the C++ recursion
(csrc.mi_forward_cpu / mi_backward_cpu).  Covers the full and banded
lattices, regular and modified topologies, ragged and nonzero-begin
boundaries and bf16 storage, through the s-major rows entry point the
pipelines use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_rnnt_tpu import mutual_information_recursion, mutual_information_rows
from fast_rnnt_tpu.csrc import mi_backward_cpu, mi_forward_cpu
from fast_rnnt_tpu.ops.lattice import band_mask_rows_smajor

from .oracle import mi_loop
from .test_recursion import _random_boundary, _random_pxpy


def _rows(x):
    return jnp.moveaxis(jnp.asarray(x), 1, 0)


def _bmajor(x):
    return np.asarray(jnp.moveaxis(x, 0, 1).astype(jnp.float32))


def _core(px, py, boundary, lo=None, K=0, dtype=jnp.float32):
    """scores + occupancies through the rows API on the XLA core."""
    scores, (gx, gy) = mutual_information_rows(
        _rows(px).astype(dtype), _rows(py).astype(dtype),
        jnp.asarray(boundary), lo=lo, s_range=K, calc_gradients=True,
        impl="xla",
    )
    return np.asarray(scores), _bmajor(gx), _bmajor(gy)


def _valid_band(rng, B, S, T, K):
    """A monotone band that starts at 0 and steps by < K per frame."""
    steps = rng.integers(0, K, size=(B, T))
    steps[:, 0] = 0
    return np.minimum(np.cumsum(steps, axis=1), max(S - K + 1, 0)).astype(
        np.int32
    )


def _masked(x, lo, K):
    """(B, S', T') lattice with -inf outside lo[b, t] <= s < lo[b, t] + K."""
    x = np.array(x)
    T1 = x.shape[2]
    lo_p = np.pad(lo, ((0, 0), (0, T1 - lo.shape[1])), mode="edge")
    s = np.arange(x.shape[1])[None, :, None]
    ok = (s >= lo_p[:, None, :]) & (s < lo_p[:, None, :] + K)
    return np.where(ok, x, -np.inf).astype(x.dtype)


@pytest.mark.parametrize("modified", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_rows_core_matches_oracle(modified, ragged):
    rng = np.random.default_rng(42)
    B, S, T = 3, 4, 9
    px, py = _random_pxpy(rng, B, S, T, modified=modified)
    boundary = _random_boundary(rng, B, S, T, ragged=ragged)
    ref_s, ref_gx, ref_gy, _ = mi_loop(px, py, boundary)
    s, gx, gy = _core(px, py, boundary)
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gx, ref_gx, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gy, ref_gy, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("modified", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_rows_core_matches_cpp(modified, ragged):
    rng = np.random.default_rng(7)
    B, S, T = 5, 6, 12
    px, py = _random_pxpy(rng, B, S, T, modified=modified, neg_inf_frac=0.2)
    boundary = _random_boundary(rng, B, S, T, ragged=ragged)
    p_cpp, s_cpp = mi_forward_cpu(px, py, boundary)
    gx_cpp, gy_cpp = mi_backward_cpu(px, py, p_cpp, boundary, np.ones(B))
    s, gx, gy = _core(px, py, boundary)
    np.testing.assert_allclose(s, s_cpp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx, gx_cpp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gy, gy_cpp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("modified", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_banded_core_matches_masked_oracle(modified, ragged):
    """Inline band masking (the pruned stage-2 path) equals the oracle run
    on an explicitly band-masked lattice — scores and occupancies."""
    rng = np.random.default_rng(99)
    B, S, T, K = 3, 7, 12, 3
    px, py = _random_pxpy(rng, B, S, T, modified=modified)
    boundary = _random_boundary(rng, B, S, T, ragged=ragged)
    lo = _valid_band(rng, B, S, T, K)
    ref_s, ref_gx, ref_gy, _ = mi_loop(
        _masked(px, lo, K), _masked(py, lo, K), boundary
    )
    s, gx, gy = _core(px, py, boundary, lo=jnp.asarray(lo), K=K)
    fin = np.isfinite(ref_s)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], ref_s[fin], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gx, ref_gx, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gy, ref_gy, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("modified", [False, True])
def test_banded_core_matches_cpp(modified):
    rng = np.random.default_rng(31)
    B, S, T, K = 4, 8, 15, 4
    px, py = _random_pxpy(rng, B, S, T, modified=modified)
    boundary = np.tile(np.array([0, 0, S, T], np.int32), (B, 1))
    # a ramp band that provably admits a path to (S, T)
    lo = np.broadcast_to(
        np.minimum(np.arange(T) * S // T, S - K + 1), (B, T)
    ).astype(np.int32)
    pxm, pym = _masked(px, lo, K), _masked(py, lo, K)
    p_cpp, s_cpp = mi_forward_cpu(pxm, pym, boundary)
    gx_cpp, gy_cpp = mi_backward_cpu(pxm, pym, p_cpp, boundary, np.ones(B))
    s, gx, gy = _core(px, py, boundary, lo=jnp.asarray(lo), K=K)
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s, s_cpp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx, gx_cpp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gy, gy_cpp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("modified", [False, True])
def test_bf16_storage_core_matches_oracle(modified):
    """bf16 storage is widened to float32: the recursion on bf16-rounded
    inputs equals the float64 oracle on the same rounded values (f32
    accuracy), and the occupancies come back in bf16."""
    rng = np.random.default_rng(123)
    B, S, T = 2, 6, 40
    px, py = _random_pxpy(rng, B, S, T, modified=modified)
    px_b = np.asarray(jnp.asarray(px).astype(jnp.bfloat16).astype(jnp.float32))
    py_b = np.asarray(jnp.asarray(py).astype(jnp.bfloat16).astype(jnp.float32))
    boundary = _random_boundary(rng, B, S, T)
    ref_s, ref_gx, ref_gy, _ = mi_loop(px_b, py_b, boundary)
    scores, (gx, gy) = mutual_information_rows(
        _rows(px).astype(jnp.bfloat16), _rows(py).astype(jnp.bfloat16),
        jnp.asarray(boundary), calc_gradients=True, impl="xla",
    )
    assert scores.dtype == jnp.float32
    assert gx.dtype == gy.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(scores), ref_s, rtol=1e-5, atol=1e-5)
    # occupancies are rounded once to bf16 on the way out (2^-8 relative)
    np.testing.assert_allclose(_bmajor(gx), ref_gx, rtol=8e-3, atol=1e-5)
    np.testing.assert_allclose(_bmajor(gy), ref_gy, rtol=8e-3, atol=1e-5)


@pytest.mark.parametrize("B", [33, 40, 56])
def test_large_batch_matches_cpp(B):
    """Batch sizes that do not divide the 8-device test mesh or any block
    size: every row is computed."""
    rng = np.random.default_rng(B)
    S, T = 6, 20
    px = (rng.normal(size=(B, S, T + 1)) - 2.0).astype(np.float32)
    py = (rng.normal(size=(B, S + 1, T)) - 2.0).astype(np.float32)
    boundary = np.tile(np.array([0, 0, S, T], np.int32), (B, 1))
    p_cpp, s_cpp = mi_forward_cpu(px, py, boundary)
    gx_cpp, gy_cpp = mi_backward_cpu(px, py, p_cpp, boundary, np.ones(B))
    s, gx, gy = _core(px, py, boundary)
    np.testing.assert_allclose(s, s_cpp, rtol=2e-5)
    np.testing.assert_allclose(gx, gx_cpp, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(gy, gy_cpp, rtol=1e-3, atol=1e-5)


def test_empty_transcript_s0():
    """S = 0: a single-row lattice; all occupancy is on the blank arcs."""
    rng = np.random.default_rng(5)
    B, T = 3, 9
    px = np.zeros((B, 0, T + 1), np.float32)
    py = rng.normal(size=(B, 1, T)).astype(np.float32)
    ref_s, _, ref_gy, _ = mi_loop(px, py, None)
    s, gx, gy = _core(px, py, np.tile(np.array([0, 0, 0, T], np.int32), (B, 1)))
    assert gx.shape == (B, 0, T + 1)
    np.testing.assert_allclose(s, ref_s, rtol=1e-5)
    np.testing.assert_allclose(gy, ref_gy, rtol=1e-5)
    np.testing.assert_allclose(gy.sum((1, 2)), T, rtol=1e-5)


def test_out_of_range_boundary_clamped():
    """Out-of-range boundary values (e.g. t_end = T + 1) are clamped to the
    lattice, the same rule the GPU kernels rely on."""
    rng = np.random.default_rng(6)
    B, S, T = 2, 4, 7
    px = jnp.asarray(rng.normal(size=(B, S, T + 1)).astype(np.float32))
    py = jnp.asarray(rng.normal(size=(B, S + 1, T)).astype(np.float32))
    bad = jnp.asarray(np.array([[0, 0, S, T + 1], [-1, 0, S + 3, T]], np.int32))
    good = jnp.asarray(np.array([[0, 0, S, T], [0, 0, S, T]], np.int32))
    s_bad = mutual_information_recursion(px, py, bad)
    s_good = mutual_information_recursion(px, py, good)
    ref_s, _, _, _ = mi_loop(np.asarray(px), np.asarray(py), np.asarray(good))
    np.testing.assert_allclose(np.asarray(s_bad), np.asarray(s_good), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s_good), ref_s, rtol=1e-5)


def test_nonzero_begin_matches_oracle_and_cpp():
    rng = np.random.default_rng(11)
    B, S, T = 2, 6, 10
    px, py = _random_pxpy(rng, B, S, T)
    boundary = np.array([[1, 2, 5, 9], [0, 0, 6, 10]], dtype=np.int32)
    ref_s, ref_gx, ref_gy, _ = mi_loop(px, py, boundary)
    p_cpp, s_cpp = mi_forward_cpu(px, py, boundary)
    s, gx, gy = _core(px, py, boundary)
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s, s_cpp, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gx, ref_gx, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gy, ref_gy, rtol=2e-4, atol=2e-5)


def test_banded_grad_equals_masked_grad():
    """jax.grad through the banded custom VJP equals jax.grad of the plain
    recursion on an XLA band-masked lattice."""
    rng = np.random.default_rng(17)
    B, S, T, K = 3, 7, 12, 3
    px, py = _random_pxpy(rng, B, S, T)
    bnd = jnp.asarray(_random_boundary(rng, B, S, T))
    lo = jnp.asarray(_valid_band(rng, B, S, T, K))

    def banded(a, b):
        s = mutual_information_rows(a, b, bnd, lo=lo, s_range=K, impl="xla")
        return jnp.sum(jnp.where(jnp.isfinite(s), s, 0.0))

    def masked(a, b):
        s = mutual_information_rows(
            band_mask_rows_smajor(a, lo, K), band_mask_rows_smajor(b, lo, K),
            bnd, impl="xla",
        )
        return jnp.sum(jnp.where(jnp.isfinite(s), s, 0.0))

    vb, gb = jax.value_and_grad(banded, argnums=(0, 1))(_rows(px), _rows(py))
    vm, gm = jax.value_and_grad(masked, argnums=(0, 1))(_rows(px), _rows(py))
    np.testing.assert_allclose(float(vb), float(vm), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gb[0]), np.asarray(gm[0]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(gb[1]), np.asarray(gm[1]), atol=1e-6)


def test_calc_gradients_matches_vjp_under_cotangent():
    """The occupancies returned with calc_gradients=True, rescaled by a
    per-utterance cotangent, equal the VJP of the scores-only op (the
    backward is linear in its seed)."""
    rng = np.random.default_rng(23)
    B, S, T = 3, 5, 11
    px, py = _random_pxpy(rng, B, S, T, modified=True)
    bnd = jnp.asarray(_random_boundary(rng, B, S, T))
    ct = jnp.asarray(rng.uniform(0.5, 2.0, size=B).astype(np.float32))
    _, vjp = jax.vjp(
        lambda a, b: mutual_information_rows(a, b, bnd, impl="xla"),
        _rows(px), _rows(py),
    )
    gx_v, gy_v = vjp(ct)
    _, (gx, gy) = mutual_information_rows(
        _rows(px), _rows(py), bnd, calc_gradients=True, impl="xla"
    )
    scale = ct[None, :, None]
    np.testing.assert_allclose(np.asarray(gx_v), np.asarray(gx * scale), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(gy_v), np.asarray(gy * scale), rtol=1e-5, atol=1e-7)
