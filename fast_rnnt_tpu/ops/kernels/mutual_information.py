"""GPU wavefront kernels for the lattice recursion (``impl="cuda"``).

``mutual_information.cu`` holds the forward (p lattice + scores) and the
occupancy backward, both over the s-major rows layout that
``ops/recursion.py`` uses, with the boundary and the optional pruning band
``(lo, K)`` masked inline.  This module builds the shared library with
``nvcc`` at first use (into ``_build/`` next to the source, listed in
``.gitignore``), registers the two XLA FFI targets and exposes them as
batch-partitioned JAX calls.  To build ahead of time::

    python -m fast_rnnt_tpu.ops.kernels.mutual_information

The kernels have no interpret mode: on a host without a Hopper GPU the
recursion uses the XLA scan core, and asking for ``impl="cuda"`` there is
an error.  Their arithmetic is the XLA core's, which stays beside them as
the reference (tests compare the two on the card).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .partition import batch_partitioned

__all__ = [
    "MAX_ROWS",
    "backward_rows_cuda",
    "build",
    "cuda_available",
    "forward_rows_cuda",
    "is_hopper",
    "supports",
]

# one thread per lattice row, one block per utterance
MAX_ROWS = 1024

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_SRC_DIR, "mutual_information.cu")
_BUILD_DIR = os.path.join(_SRC_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libfrt_mi_cuda.so")
_TARGETS = {"frt_mi_forward": "FrtMiForward", "frt_mi_backward": "FrtMiBackward"}

_lock = threading.Lock()
_registered = False


def is_hopper(device) -> bool:
    """True for a CUDA device of compute capability 9.x, the one target
    the library is built for (``sm_90a``).  Other CUDA GPUs and ROCm
    devices, whose platform is also "gpu", are not."""
    if getattr(device, "platform", None) != "gpu":
        return False
    return str(getattr(device, "compute_capability", "")).split(".")[0] == "9"


def cuda_available() -> bool:
    """True when JAX's default device is a Hopper GPU (:func:`is_hopper`)."""
    return is_hopper(jax.devices()[0])


def supports(px_rows: jax.Array, py_rows: jax.Array) -> bool:
    """Shapes and dtypes the kernels cover: float32 or bfloat16 storage
    (each of px and py, since both are read as float32) and at most
    MAX_ROWS lattice rows (S + 1)."""
    return (
        px_rows.dtype in (jnp.float32, jnp.bfloat16)
        and py_rows.dtype in (jnp.float32, jnp.bfloat16)
        and py_rows.shape[0] <= MAX_ROWS
    )


def _f32(x: jax.Array) -> jax.Array:
    # The kernels read float32: casting bf16 storage here, where XLA fuses
    # the cast into neighbouring ops, measured faster than loading bf16 in
    # the kernel (PERF.md, PR 1).
    return x.astype(jnp.float32)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the GPU recursion kernels")


def build(force: bool = False) -> str:
    """Compile ``mutual_information.cu`` for sm_90a unless an up-to-date
    library exists; returns its path."""
    if (
        not force
        and os.path.exists(_LIB_PATH)
        and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)
    ):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SOURCE,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        if not cuda_available():
            d = jax.devices()[0]
            raise RuntimeError(
                'impl="cuda" needs a CUDA GPU of compute capability 9.x '
                "(Hopper) as the default JAX device; this process has "
                f"{d.platform!r} ({d.device_kind})"
            )
        lib = ctypes.cdll.LoadLibrary(build())
        for name, symbol in _TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA"
            )
        _registered = True


def _lo_or_dummy(lo: Optional[jax.Array], py_rows: jax.Array) -> jax.Array:
    if lo is not None:
        return lo.astype(jnp.int32)
    _, B, T = py_rows.shape
    return jnp.zeros((B, T), jnp.int32)


def _pvary(x, vma):
    missing = tuple(sorted(vma - jax.typeof(x).vma))
    return jax.lax.pcast(x, missing, to="varying") if missing else x


def _ffi(name, results, *args, **attrs):
    """FFI call that keeps ``shard_map``'s varying-axes types: every
    operand is cast up to the union of the operands' varying axes, and so
    are the results (so custom_vjp cotangents match their primals)."""
    vma = frozenset().union(*(jax.typeof(a).vma for a in args))
    outs = jax.ffi.ffi_call(name, results, vmap_method="sequential")(
        *(_pvary(a, vma) for a in args), **attrs
    )
    return tuple(_pvary(o, vma) for o in outs)


@functools.lru_cache(maxsize=None)
def _forward_call(K: int):
    def call(px_rows, py_rows, boundary, lo):
        S1, B, T = py_rows.shape
        results = (
            jax.ShapeDtypeStruct((S1, B, T + 1), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
        )
        return _ffi("frt_mi_forward", results, px_rows, py_rows, boundary,
                    lo, K=K)

    return batch_partitioned(
        call, in_axes=(1, 1, 0, 0), out_axes=(1, 0),
        in_ranks=(3, 3, 2, 2), out_ranks=(3, 1), name="mi_fwd",
    )


@functools.lru_cache(maxsize=None)
def _backward_call(K: int):
    def call(px_rows, py_rows, p_rows, boundary, lo, ans_grad):
        results = (
            jax.ShapeDtypeStruct(px_rows.shape, px_rows.dtype),
            jax.ShapeDtypeStruct(py_rows.shape, py_rows.dtype),
        )
        return _ffi("frt_mi_backward", results, px_rows, py_rows, p_rows,
                    boundary, lo, ans_grad, K=K)

    return batch_partitioned(
        call, in_axes=(1, 1, 1, 0, 0, 0), out_axes=(1, 1),
        in_ranks=(3, 3, 3, 2, 2, 1), out_ranks=(3, 3), name="mi_bwd",
    )


def forward_rows_cuda(
    px_rows: jax.Array,
    py_rows: jax.Array,
    boundary: jax.Array,
    lo: Optional[jax.Array] = None,
    K: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (p_rows [S+1, B, T+1] float32, scores [B] float32)."""
    _register()
    return _forward_call(int(K) if lo is not None else 0)(
        _f32(px_rows), _f32(py_rows), boundary.astype(jnp.int32),
        _lo_or_dummy(lo, py_rows),
    )


def backward_rows_cuda(
    px_rows: jax.Array,
    py_rows: jax.Array,
    p_rows: jax.Array,
    boundary: jax.Array,
    ans_grad: jax.Array,
    lo: Optional[jax.Array] = None,
    K: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Returns the occupancies (px_grad, py_grad) in the storage dtype."""
    _register()
    gx, gy = _backward_call(int(K) if lo is not None else 0)(
        _f32(px_rows), _f32(py_rows), p_rows, boundary.astype(jnp.int32),
        _lo_or_dummy(lo, py_rows), ans_grad.astype(jnp.float32),
    )
    return gx.astype(px_rows.dtype), gy.astype(py_rows.dtype)


if __name__ == "__main__":
    print(build(force=True))
