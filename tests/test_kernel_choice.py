"""The choice between the GPU recursion kernels and the XLA scan core,
and the parts of the kernel path that run without a card: the Python
wrapper's shapes and band handling, and the batch-partitioning wrapper
that runs the opaque kernel call per shard."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import fast_rnnt_tpu as frt
from fast_rnnt_tpu.ops import recursion
from fast_rnnt_tpu.ops.kernels import mutual_information as gpu
from fast_rnnt_tpu.ops.kernels import partition


def _rows(rng, B, S, T, modified=False, dtype=np.float32):
    T1 = T if modified else T + 1
    px = jnp.asarray(rng.normal(size=(S, B, T1)).astype(dtype))
    py = jnp.asarray(rng.normal(size=(S + 1, B, T)).astype(dtype))
    bnd = jnp.asarray(np.tile(np.array([0, 0, S, T], np.int32), (B, 1)))
    return px, py, bnd


def test_cpu_resolves_to_xla():
    """Without a GPU the default is the XLA core, bit for bit."""
    rng = np.random.default_rng(0)
    px, py, bnd = _rows(rng, 3, 4, 9)
    assert not gpu.cuda_available()
    assert not recursion._use_cuda(None, px, py)
    assert not recursion._use_cuda("auto", px, py)
    assert not recursion._use_cuda("xla", px, py)
    got = frt.mutual_information_rows(px, py, bnd, calc_gradients=True)
    want = frt.mutual_information_rows(px, py, bnd, calc_gradients=True, impl="xla")
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_cuda_without_gpu_raises():
    """Asking for the kernels on a host without a CUDA GPU is an error,
    never a silent fallback, from the recursion and from the losses."""
    rng = np.random.default_rng(1)
    px, py, bnd = _rows(rng, 2, 3, 7)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        frt.mutual_information_rows(px, py, bnd, impl="cuda")
    B, T, S, C = 2, 8, 3, 6
    lm = jnp.zeros((B, S + 1, C))
    am = jnp.zeros((B, T, C))
    symbols = jnp.ones((B, S), jnp.int32)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        frt.rnnt_loss_simple_pruned(lm, am, symbols, 0, 2, impl="cuda")


def test_uncovered_inputs_and_unknown_impl():
    """The kernels cover float32/bfloat16 storage (px and py each; a
    float32 px beside a bfloat16 py is the lattice-dtype mode under a
    delay penalty) and at most MAX_ROWS rows: auto picks the XLA core for
    anything else, an explicit "cuda" raises, and an unknown
    implementation name raises."""
    rng = np.random.default_rng(2)
    px, py, bnd = _rows(rng, 2, 3, 7)
    assert gpu.supports(px, py)
    assert gpu.supports(px.astype(jnp.bfloat16), py.astype(jnp.bfloat16))
    assert not gpu.supports(px.astype(jnp.float16), py.astype(jnp.float16))
    assert gpu.supports(px, py.astype(jnp.bfloat16))
    assert not gpu.supports(px, py.astype(jnp.float16))
    wide = jax.ShapeDtypeStruct((gpu.MAX_ROWS, 2, 7), jnp.float32)
    assert not gpu.supports(
        jax.ShapeDtypeStruct((gpu.MAX_ROWS, 2, 8), jnp.float32),
        jax.ShapeDtypeStruct((gpu.MAX_ROWS + 1, 2, 7), jnp.float32),
    )
    assert gpu.supports(
        jax.ShapeDtypeStruct((gpu.MAX_ROWS - 1, 2, 8), jnp.float32), wide
    )
    with pytest.raises(TypeError, match="float32/bfloat16"):
        frt.mutual_information_rows(
            px.astype(jnp.float16), py.astype(jnp.float16), bnd, impl="cuda"
        )
    with pytest.raises(ValueError, match="unknown"):
        frt.mutual_information_rows(px, py, bnd, impl="pallas")


@pytest.mark.parametrize("modified", [False, True])
def test_kernel_wrapper_shapes(modified, monkeypatch):
    """The kernel entry points' results (registration stubbed; shapes
    only): p lattice [S+1, B, T+1] and scores [B] in float32 whatever the
    storage; occupancies in the storage dtype and the shapes of px/py; the
    FFI calls themselves see float32 operands and a dummy band when none
    is given."""
    monkeypatch.setattr(gpu, "_register", lambda: None)
    rng = np.random.default_rng(3)
    B, S, T = 3, 5, 11
    for dtype in (jnp.float32, jnp.bfloat16):
        px, py, bnd = _rows(rng, B, S, T, modified=modified)
        px, py = px.astype(dtype), py.astype(dtype)
        lo = gpu._lo_or_dummy(None, py)
        assert lo.shape == (B, T) and lo.dtype == jnp.int32
        p, sc = jax.eval_shape(gpu.forward_rows_cuda, px, py, bnd)
        assert (p.shape, p.dtype) == ((S + 1, B, T + 1), jnp.float32)
        assert (sc.shape, sc.dtype) == ((B,), jnp.float32)
        gx, gy = jax.eval_shape(
            lambda a, b, q: gpu.backward_rows_cuda(
                a, b, q, bnd, jnp.ones((B,)), lo=lo, K=3),
            px, py, p,
        )
        assert (gx.shape, gx.dtype) == (px.shape, dtype)
        assert (gy.shape, gy.dtype) == (py.shape, dtype)
        jaxpr = str(jax.make_jaxpr(gpu.forward_rows_cuda)(px, py, bnd))
        assert "frt_mi_forward" in jaxpr
        assert f"f32[{S},{B},{px.shape[2]}]" in jaxpr


@pytest.mark.parametrize("world", ["explicit", "auto"])
def test_batch_partitioned_runs_per_shard(world, monkeypatch):
    """The wrapper the kernels run under (partition.batch_partitioned with
    the kernels' axes) traces its body once per shard at B/8 and matches
    the unsharded call — checked here with the XLA core as the body."""
    log = []
    monkeypatch.setattr(
        partition, "_TRACE_HOOK", lambda name, b: log.append((name, int(b)))
    )

    def body(px, py, bnd, lo):
        return recursion._forward_rows_xla(px, py, bnd, lo=lo, K=3)

    fwd = partition.batch_partitioned(
        body, in_axes=(1, 1, 0, 0), out_axes=(1, 0),
        in_ranks=(3, 3, 2, 2), out_ranks=(3, 1), name="mi_fwd",
    )
    rng = np.random.default_rng(4)
    B, S, T = 16, 6, 20
    px, py, bnd = _rows(rng, B, S, T)
    lo = jnp.asarray(
        np.broadcast_to(np.minimum(np.arange(T) * S // T, S - 2), (B, T))
        .astype(np.int32)
    )
    want = jax.jit(body)(px, py, bnd, lo)
    if world == "explicit":
        mesh = jax.make_mesh((8,), ("dp",))
    else:
        mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    args = (
        jax.device_put(px, NamedSharding(mesh, P(None, "dp", None))),
        jax.device_put(py, NamedSharding(mesh, P(None, "dp", None))),
        jax.device_put(bnd, NamedSharding(mesh, P("dp", None))),
        jax.device_put(lo, NamedSharding(mesh, P("dp", None))),
    )
    got = jax.jit(fwd)(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)
    assert {b for name, b in log if name == "mi_fwd"} == {B // 8}


def test_kernel_path_traces_under_shard_map(monkeypatch):
    """The kernel path typed as if on a GPU (registration stubbed; traced,
    not lowered): value_and_grad of the pruned pipeline inside a
    check_vma shard_map over 8 devices — the data_parallel path — gives
    gradients whose varying axes match their inputs'."""
    monkeypatch.setattr(gpu, "_register", lambda: None)
    monkeypatch.setattr(gpu, "cuda_available", lambda: True)
    B, T, S, C, K = 16, 20, 4, 10, 2
    rng = np.random.default_rng(5)
    lm = jnp.asarray(rng.normal(size=(B, S + 1, C)).astype(np.float32))
    am = jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32))
    symbols = jnp.asarray(rng.integers(1, C, size=(B, S)).astype(np.int32))
    mesh = jax.make_mesh((8,), ("data",))

    def local(lm_, am_, sym):
        assert recursion._use_cuda(
            None, jnp.zeros((S, 2, T + 1)), jnp.zeros((S + 1, 2, T))
        )

        def loss(l, a):
            s1, s2, _ = frt.rnnt_loss_simple_pruned(l, a, sym, 0, K, reduction="sum")
            return 0.5 * s1 + s2

        v, g = jax.value_and_grad(loss, argnums=(0, 1))(lm_, am_)
        assert jax.typeof(g[0]).vma == jax.typeof(lm_).vma == {"data"}
        return jax.lax.psum(v, "data"), g

    f = jax.shard_map(
        local, mesh=mesh, in_specs=P("data"), out_specs=(P(), P("data"))
    )
    traced = jax.jit(f).trace(lm, am, symbols)
    text = str(traced.jaxpr)
    assert "frt_mi_forward" in text and "frt_mi_backward" in text


@pytest.mark.parametrize(
    "platform, cc, want",
    [
        ("gpu", "9.0", True),
        ("gpu", "8.0", False),   # A100
        ("gpu", "8.9", False),   # L4
        ("gpu", "10.0", False),  # newer than the sm_90a build
        ("gpu", "gfx90a", False),  # ROCm reports platform "gpu" too
        ("gpu", None, False),
        ("cpu", None, False),
    ],
)
def test_kernel_default_only_on_hopper(platform, cc, want, monkeypatch):
    """The library is built for sm_90a only, so the kernels are the
    default on a compute-capability 9.x CUDA device and nowhere else; on
    any other GPU the default is the XLA core, and impl="cuda" raises."""
    dev = SimpleNamespace(platform=platform, device_kind="test device")
    if cc is not None:
        dev.compute_capability = cc
    assert gpu.is_hopper(dev) is want
    rng = np.random.default_rng(6)
    px, py, bnd = _rows(rng, 2, 3, 7)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])
    assert gpu.cuda_available() is want
    assert recursion._use_cuda(None, px, py) is want
    if not want:
        monkeypatch.setattr(gpu, "_registered", False)
        with pytest.raises(RuntimeError, match="compute capability 9"):
            gpu._register()
