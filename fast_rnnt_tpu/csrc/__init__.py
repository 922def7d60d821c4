"""Native (C++) host-side components, bound through ctypes.

Counterpart of the reference's native layer (tf_fast_rnnt/csrc + the TF
custom op).  The C++ here serves the host: a CPU oracle of the lattice
recursion, cummin, the ragged-batch planner used by the data pipeline and
the fbank features.

The shared library is built on demand with the ambient `g++` (no external
build deps); `cmake` users can instead build `libfrt_cpu.so` from
csrc/CMakeLists.txt and drop it next to this file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_SRC_DIR, "libfrt_cpu.so")
_SOURCES = ["mutual_information_cpu.cc", "batching.cc", "features.cc"]

_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", _LIB_PATH] + srcs
    subprocess.run(cmd, check=True, capture_output=True)


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    newest_src = max(
        os.path.getmtime(os.path.join(_SRC_DIR, s)) for s in _SOURCES
    )
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < newest_src:
        try:
            _build()
        except (OSError, subprocess.CalledProcessError):
            # no compiler available: fall through and try any existing .so —
            # but LOUDLY, since a stale binary can diverge from its source
            # and parity tests against it would mislead silently
            if not os.path.exists(_LIB_PATH):
                raise
            import warnings

            warnings.warn(
                "fast_rnnt_tpu.csrc: rebuild failed and the existing "
                f"{os.path.basename(_LIB_PATH)} is OLDER than the C++ "
                "sources — loading the stale binary; native-oracle results "
                "may not reflect the current source",
                RuntimeWarning,
            )
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        # stale/foreign-architecture binary: rebuild from source
        _build()
        lib = ctypes.CDLL(_LIB_PATH)
    i32 = ctypes.c_int32
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.frt_mi_forward.argtypes = [fp, fp, ip, fp, fp, i32, i32, i32, i32]
    lib.frt_mi_forward.restype = None
    lib.frt_mi_backward.argtypes = [fp, fp, fp, ip, fp, fp, fp, i32, i32, i32, i32]
    lib.frt_mi_backward.restype = None
    lib.frt_cummin.argtypes = [ip, ip, i32, i32]
    lib.frt_cummin.restype = None
    lib.frt_plan_batches.argtypes = [ip, ip, i32, i32, i32, i32, ip, ip, ip, ip]
    lib.frt_plan_batches.restype = i32
    f32 = ctypes.c_float
    lib.frt_fbank.argtypes = [fp, i32, i32, i32, i32, i32, i32, f32, f32, f32,
                              fp, i32]
    lib.frt_fbank.restype = i32
    lib.frt_fbank_ctx.argtypes = [fp, i32, i32, i32, i32, i32, i32, f32, f32,
                                  f32, fp, i32, i32, f32]
    lib.frt_fbank_ctx.restype = i32
    _lib = lib
    return lib


def mi_forward_cpu(
    px: np.ndarray, py: np.ndarray, boundary: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Native forward: returns (p [B,S+1,T+1], scores [B])."""
    lib = load_library()
    px = np.ascontiguousarray(px, np.float32)
    py = np.ascontiguousarray(py, np.float32)
    boundary = np.ascontiguousarray(boundary, np.int32)
    B, S, T1 = px.shape
    T = py.shape[2]
    p = np.empty((B, S + 1, T + 1), np.float32)
    scores = np.empty((B,), np.float32)
    lib.frt_mi_forward(px, py, boundary, p, scores, B, S, T1, T)
    return p, scores


def mi_backward_cpu(
    px: np.ndarray,
    py: np.ndarray,
    p: np.ndarray,
    boundary: np.ndarray,
    ans_grad: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native occupancy backward: returns (px_grad, py_grad)."""
    lib = load_library()
    px = np.ascontiguousarray(px, np.float32)
    py = np.ascontiguousarray(py, np.float32)
    p = np.ascontiguousarray(p, np.float32)
    boundary = np.ascontiguousarray(boundary, np.int32)
    ans_grad = np.ascontiguousarray(ans_grad, np.float32)
    B, S, T1 = px.shape
    T = py.shape[2]
    px_grad = np.empty_like(px)
    py_grad = np.empty_like(py)
    lib.frt_mi_backward(
        px, py, p, boundary, ans_grad, px_grad, py_grad, B, S, T1, T
    )
    return px_grad, py_grad


def cummin_cpu(x: np.ndarray) -> np.ndarray:
    lib = load_library()
    x = np.ascontiguousarray(x, np.int32)
    B, T = x.shape
    out = np.empty_like(x)
    lib.frt_cummin(x, out, B, T)
    return out


def plan_batches_cpu(
    frame_lens: np.ndarray,
    sym_lens: np.ndarray,
    max_frames: int,
    max_batch: int,
    quantum: int = 32,
):
    """Plan padded static-shape batches; see csrc/batching.cc.

    Returns a list of (indices, padded_T, padded_S) tuples."""
    lib = load_library()
    frame_lens = np.ascontiguousarray(frame_lens, np.int32)
    sym_lens = np.ascontiguousarray(sym_lens, np.int32)
    n = len(frame_lens)
    order = np.empty((n,), np.int32)
    starts = np.empty((n + 1,), np.int32)
    pad_t = np.empty((n,), np.int32)
    pad_s = np.empty((n,), np.int32)
    nb = lib.frt_plan_batches(
        frame_lens, sym_lens, n, max_frames, max_batch, quantum,
        order, starts, pad_t, pad_s,
    )
    return [
        (order[starts[i] : starts[i + 1]].copy(), int(pad_t[i]), int(pad_s[i]))
        for i in range(nb)
    ]


def fbank_cpu(
    wav: np.ndarray,
    sample_rate: int = 16000,
    win_len: int = 400,
    hop: int = 160,
    n_fft: int = 512,
    n_mels: int = 80,
    low_hz: float = 20.0,
    high_hz: float = 0.0,
    preemph: float = 0.97,
) -> np.ndarray:
    """Native log-mel filterbank features (csrc/features.cc).

    Args: wav (n,) float32 in [-1, 1]; defaults = 25 ms window / 10 ms hop
    at 16 kHz with 80 mel bands (the usual ASR fbank config).
    Returns (n_frames, n_mels) float32.
    """
    # the C++ FFT is radix-2 (features.cc): a non-power-of-two n_fft would
    # silently produce garbage from the bit-reversal/butterfly loops
    if n_fft <= 0 or (n_fft & (n_fft - 1)) != 0:
        raise ValueError(f"n_fft must be a power of two, got {n_fft}")
    if n_fft < win_len:
        raise ValueError(f"n_fft={n_fft} must be >= win_len={win_len}")
    lib = load_library()
    wav = np.ascontiguousarray(wav, np.float32)
    max_frames = max((len(wav) - win_len) // hop + 1, 0)
    out = np.empty((max(max_frames, 1), n_mels), np.float32)
    n = lib.frt_fbank(
        wav, len(wav), sample_rate, win_len, hop, n_fft, n_mels,
        np.float32(low_hz), np.float32(high_hz), np.float32(preemph),
        out, max_frames,
    )
    return out[:n]
