"""GSPMD/pjit composition: the default path under plain ``jit`` with
batch-sharded inputs, in both of JAX's sharding worlds —

  * explicit-axes meshes (``jax.make_mesh`` default);
  * auto-axes meshes (classic ``jax.sharding.Mesh``).

Each test asserts numerical parity with the single-device run, and the
collective census asserts that no lattice-sized array crosses devices.
On a GPU the recursion runs as an opaque FFI call, which
``ops/kernels/partition.py`` runs per batch shard; test_kernel_choice.py
checks that wrapper here with the XLA core standing in for the kernel.

No reference equivalent: the reference is single-GPU (SURVEY.md §2.4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import fast_rnnt_tpu as frt
from fast_rnnt_tpu.utils import collective_census


def _explicit_mesh():
    return jax.make_mesh((8,), ("dp",))


def _auto_mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(8), ("dp",))


def _inputs(B, T, S, C, seed=0):
    rng = np.random.default_rng(seed)
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    t_end = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    s_end = rng.integers(S // 2, S + 1, size=B).astype(np.int32)
    boundary = jnp.asarray(
        np.stack(
            [np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end],
            axis=1,
        )
    )
    return lm, am, symbols, boundary


def _pruned_step(s_range, rnnt_type="regular"):
    def step(lm, am, symbols, boundary):
        def loss_fn(lm_, am_):
            simple, pruned, _ = frt.rnnt_loss_simple_pruned(
                lm_, am_, symbols, 0, s_range, boundary, reduction="sum",
                rnnt_type=rnnt_type,
            )
            return 0.5 * simple + pruned

        return jax.value_and_grad(loss_fn, argnums=(0, 1))(lm, am)

    return step


def _shard(mesh, lm, am, symbols, boundary):
    return (
        jax.device_put(lm, NamedSharding(mesh, P("dp", None, None))),
        jax.device_put(am, NamedSharding(mesh, P("dp", None, None))),
        jax.device_put(symbols, NamedSharding(mesh, P("dp", None))),
        jax.device_put(boundary, NamedSharding(mesh, P("dp", None))),
    )


def _assert_parity(got, want, rtol=2e-5, atol=2e-5):
    loss_g, (dlm_g, dam_g) = got
    loss_w, (dlm_w, dam_w) = want
    np.testing.assert_allclose(
        np.asarray(loss_g), np.asarray(loss_w), rtol=rtol, atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(dlm_g), np.asarray(dlm_w), rtol=rtol, atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(dam_g), np.asarray(dam_w), rtol=rtol, atol=atol
    )


def _census(fn, *args, T):
    txt = jax.jit(fn).lower(*args).compile().as_text()
    census = collective_census(txt, lattice_dims=(T, T + 1))
    assert not census["lattice_moves"], census["lattice_moves"]
    return census


@pytest.mark.parametrize("world", ["explicit", "auto"])
def test_pruned_pipeline_batch_sharded(world):
    """rnnt_loss_simple_pruned under plain jit with batch-sharded inputs
    matches the single-device result, with no lattice-sized collective."""
    B, T, S, C, K = 16, 50, 6, 24, 3
    lm, am, symbols, boundary = _inputs(B, T, S, C)
    step = _pruned_step(K)
    want = jax.jit(step)(lm, am, symbols, boundary)
    mesh = _explicit_mesh() if world == "explicit" else _auto_mesh()
    args = _shard(mesh, lm, am, symbols, boundary)
    _assert_parity(jax.jit(step)(*args), want)
    _census(step, *args, T=T)


@pytest.mark.parametrize("world", ["explicit", "auto"])
def test_modified_pipeline_batch_sharded(world):
    """The modified topology (t advances with every symbol) sharded the
    same way."""
    B, T, S, C, K = 16, 40, 5, 20, 2
    lm, am, symbols, boundary = _inputs(B, T, S, C, seed=5)
    step = _pruned_step(K, rnnt_type="modified")
    want = jax.jit(step)(lm, am, symbols, boundary)
    mesh = _explicit_mesh() if world == "explicit" else _auto_mesh()
    args = _shard(mesh, lm, am, symbols, boundary)
    _assert_parity(jax.jit(step)(*args), want)
    _census(step, *args, T=T)


@pytest.mark.parametrize("world", ["explicit", "auto"])
def test_recursion_rows_batch_sharded(world):
    """The rows recursion alone (scores + occupancies) with its batch axis
    (axis 1 of the s-major rows) sharded."""
    B, T, S = 16, 50, 6
    rng = np.random.default_rng(7)
    px = jnp.asarray(rng.normal(size=(S, B, T + 1)).astype(np.float32))
    py = jnp.asarray(rng.normal(size=(S + 1, B, T)).astype(np.float32))
    boundary = jnp.asarray(
        np.stack([np.zeros(B), np.zeros(B), np.full(B, S), np.full(B, T)],
                 axis=1).astype(np.int32)
    )

    def pair(px_, py_, bnd_):
        sc, (gx, gy) = frt.mutual_information_rows(
            px_, py_, bnd_, calc_gradients=True
        )
        return sc, gx, gy

    want = jax.jit(pair)(px, py, boundary)
    mesh = _explicit_mesh() if world == "explicit" else _auto_mesh()
    args = (
        jax.device_put(px, NamedSharding(mesh, P(None, "dp", None))),
        jax.device_put(py, NamedSharding(mesh, P(None, "dp", None))),
        jax.device_put(boundary, NamedSharding(mesh, P("dp", None))),
    )
    for g, w in zip(jax.jit(pair)(*args), want):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=2e-5, atol=2e-5
        )
    _census(pair, *args, T=T)


@pytest.mark.parametrize("world", ["explicit", "auto"])
def test_smoothed_pipeline_batch_sharded(world):
    """Smoothed pipeline: its unigram LM is a mean over the whole batch,
    so a correct sharded run needs a cross-shard reduction."""
    B, T, S, C, K = 16, 40, 5, 20, 3
    lm, am, symbols, boundary = _inputs(B, T, S, C, seed=3)

    def step(lm, am, symbols, boundary):
        def loss_fn(lm_, am_):
            smoothed, pruned, _ = frt.rnnt_loss_smoothed_pruned(
                lm_, am_, symbols, 0, K, lm_only_scale=0.15,
                am_only_scale=0.1, boundary=boundary, reduction="sum",
            )
            return smoothed + 0.5 * pruned

        return jax.value_and_grad(loss_fn, argnums=(0, 1))(lm, am)

    want = jax.jit(step)(lm, am, symbols, boundary)
    mesh = _explicit_mesh() if world == "explicit" else _auto_mesh()
    args = _shard(mesh, lm, am, symbols, boundary)
    _assert_parity(jax.jit(step)(*args), want, rtol=5e-5, atol=5e-5)


def test_non_batch_axis_sharded_resharded():
    """An input sharded along a NON-batch axis (lm along C) gives the same
    loss and gradients, and each gradient keeps its input's sharding."""
    B, T, S, C, K = 16, 30, 4, 16, 2
    lm, am, symbols, boundary = _inputs(B, T, S, C, seed=7)
    step = _pruned_step(K)
    want = jax.jit(step)(lm, am, symbols, boundary)
    mesh = _explicit_mesh()
    args = (
        jax.device_put(lm, NamedSharding(mesh, P(None, None, "dp"))),
        jax.device_put(am, NamedSharding(mesh, P("dp", None, None))),
        jax.device_put(symbols, NamedSharding(mesh, P("dp", None))),
        jax.device_put(boundary, NamedSharding(mesh, P("dp", None))),
    )
    got = jax.jit(step)(*args)
    _assert_parity(got, want)
    assert got[1][0].sharding.spec == args[0].sharding.spec
    assert got[1][1].sharding.spec == args[1].sharding.spec


def test_no_collective_moves_lattice_in_compiled_hlo():
    """The compiled sharded pipeline moves no lattice-sized array (px/py/p
    rows) across devices with ANY collective — all-gather, all-to-all,
    collective-permute or reduce-scatter, any dtype.  The census
    (utils/profiling.py::collective_census) also matches operand shapes,
    so a reduce-scatter whose large operand shrinks in the result cannot
    slip through."""
    B, T, S, C, K = 16, 50, 6, 24, 3
    lm, am, symbols, boundary = _inputs(B, T, S, C)
    census = _census(
        _pruned_step(K), *_shard(_explicit_mesh(), lm, am, symbols, boundary),
        T=T,
    )
    # the summed loss is reduced across the batch shards
    assert census["all-reduce"] >= 1
