"""The CUDA recursion kernels on the card, against the XLA scan core and
the float64 loop oracle.  They have no interpret mode, so every test here
needs a Hopper GPU and skips elsewhere; on a card run them with

    FRT_TEST_PLATFORM=cuda python -m pytest -m gpu tests/test_gpu_kernels.py

(``chip_smoke.py`` runs them in its own process)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fast_rnnt_tpu as frt
from fast_rnnt_tpu.ops import recursion
from fast_rnnt_tpu.ops.kernels import mutual_information as gpu

from .oracle import mi_loop
from .test_pruning import check_ranges_at_bench_shape
from .test_recursion import _random_boundary, _random_pxpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not gpu.cuda_available():
        pytest.skip("needs a Hopper GPU: the FFI kernels have no interpret mode")


def _band(rng, B, S, T, K):
    steps = rng.integers(0, K, size=(B, T))
    steps[:, 0] = 0
    return jnp.asarray(
        np.minimum(np.cumsum(steps, axis=1), max(S - K + 1, 0)).astype(np.int32)
    )


def _both(px, py, bnd, lo=None, K=0):
    out = {}
    for impl in ("cuda", "xla"):
        s, (gx, gy) = frt.mutual_information_rows(
            px, py, bnd, lo=lo, s_range=K, calc_gradients=True, impl=impl
        )
        out[impl] = (np.asarray(s), np.asarray(gx.astype(jnp.float32)),
                     np.asarray(gy.astype(jnp.float32)))
    return out["cuda"], out["xla"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("modified", [False, True])
def test_kernel_matches_xla_core(cuda, modified, banded, dtype):
    """Same inputs, two evaluation orders: scores within 1e-5 relative,
    occupancies within 1e-4 absolute at this width.  "mixed" is a float32
    px beside a bfloat16 py (the lattice-dtype mode under a delay
    penalty)."""
    rng = np.random.default_rng(1)
    B, S, T, K = 4, 9, 41, 3
    px, py = _random_pxpy(rng, B, S, T, modified=modified, neg_inf_frac=0.1)
    bnd = jnp.asarray(_random_boundary(rng, B, S, T))
    px_dt = "float32" if dtype == "mixed" else dtype
    py_dt = "bfloat16" if dtype == "mixed" else dtype
    px_r = jnp.moveaxis(jnp.asarray(px), 1, 0).astype(px_dt)
    py_r = jnp.moveaxis(jnp.asarray(py), 1, 0).astype(py_dt)
    lo = _band(rng, B, S, T, K) if banded else None
    (s_c, gx_c, gy_c), (s_x, gx_x, gy_x) = _both(px_r, py_r, bnd, lo, K if banded else 0)
    np.testing.assert_array_equal(np.isfinite(s_c), np.isfinite(s_x))
    fin = np.isfinite(s_x)
    np.testing.assert_allclose(s_c[fin], s_x[fin], rtol=1e-5)
    # bf16 occupancies are rounded once on the way out
    tol = {"float32": 1e-4, "bfloat16": 8e-3}
    np.testing.assert_allclose(gx_c, gx_x, atol=tol[px_dt])
    np.testing.assert_allclose(gy_c, gy_x, atol=tol[py_dt])


def test_kernel_matches_oracle_nonzero_begin(cuda):
    rng = np.random.default_rng(11)
    B, S, T = 2, 6, 10
    px, py = _random_pxpy(rng, B, S, T)
    boundary = np.array([[1, 2, 5, 9], [0, 0, 6, 10]], dtype=np.int32)
    ref_s, ref_gx, ref_gy, _ = mi_loop(px, py, boundary)
    s, (gx, gy) = frt.mutual_information_recursion(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(boundary),
        calc_gradients=True, impl="cuda",
    )
    np.testing.assert_allclose(np.asarray(s), ref_s, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gx), ref_gx, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gy), ref_gy, rtol=2e-4, atol=2e-5)


def test_kernel_degenerate_shapes(cuda):
    """S = 0, a single utterance, and a lattice wider than one warp."""
    rng = np.random.default_rng(5)
    for B, S, T in [(3, 0, 9), (1, 4, 1), (2, 70, 90)]:
        px = jnp.asarray(rng.normal(size=(S, B, T + 1)).astype(np.float32))
        py = jnp.asarray(rng.normal(size=(S + 1, B, T)).astype(np.float32))
        bnd = jnp.asarray(np.tile(np.array([0, 0, S, T], np.int32), (B, 1)))
        (s_c, gx_c, gy_c), (s_x, gx_x, gy_x) = _both(px, py, bnd)
        np.testing.assert_allclose(s_c, s_x, rtol=1e-5)
        np.testing.assert_allclose(gx_c, gx_x, atol=1e-4)
        np.testing.assert_allclose(gy_c, gy_x, atol=1e-4)


def test_default_is_kernel_and_pipeline_matches_xla(cuda):
    """On a GPU the default path runs the kernels; the full pruned
    pipeline's losses and gradients match the XLA core's."""
    rng = np.random.default_rng(7)
    B, T, S, C, K = 4, 60, 8, 30, 3
    px, py = jnp.zeros((S, B, T + 1)), jnp.zeros((S + 1, B, T))
    assert recursion._use_cuda(None, px, py)
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))

    def step(impl):
        def loss(lm_, am_):
            a, b, _ = frt.rnnt_loss_simple_pruned(
                lm_, am_, symbols, 0, K, reduction="sum", impl=impl
            )
            return 0.5 * a + b

        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(lm, am)

    (v_d, g_d), (v_x, g_x) = step(None), step("xla")
    assert np.isfinite(float(v_d))
    np.testing.assert_allclose(float(v_d), float(v_x), rtol=1e-5)
    # gradients reach ~50 here: two float32 evaluation orders
    for a, b in zip(g_d, g_x):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("regular", [True, False])
def test_ranges_match_host_on_card(cuda, regular):
    """Regression: XLA for CUDA once compiled the range repair (two chained
    reverse associative-scan minimums, S=100, step 5) to windows near
    4,000, making every regular pruned loss inf on the card."""
    check_ranges_at_bench_shape(regular)
