"""Tracing / profiling / benchmarking utilities.

The reference has no observability at all (SURVEY.md §5: prints in tests
only).  Here: jax.profiler trace annotations around the hot ops, a
collective census of compiled programs, the device's measured memory peak,
a step timer on the host clock, and the identity of the card a number was
taken on (name and power limit)."""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Any, Callable, Dict, Iterator, Optional

import jax

__all__ = [
    "annotate",
    "trace_to",
    "device_memory_stats",
    "benchmark_fn",
    "collective_census",
    "gpu_identity",
    "require_gpu",
    "setup_compile_cache",
]

_COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "collective-permute",
    "reduce-scatter",
)


def collective_census(compiled_text: str, lattice_dims=()) -> Dict[str, Any]:
    """Count collective ops in an optimized HLO module and flag any that
    move lattice-sized tensors.

    ``lattice_dims`` are dimension extents (e.g. T and T+1) that only
    occur in lattice-shaped arrays; a collective whose RESULT or any
    OPERAND shape contains one of them is recorded in
    ``census["lattice_moves"]``.  Covers reduce-scatter too — a
    reduce-scatter whose large operand shrinks in the result would evade
    a result-shape-only scan (ADVICE r4).  Counts op definitions
    (``<name> = <shape> <kind>(...)``) including ``-start`` forms, not
    ``-done`` bookkeeping."""
    import re

    census: Dict[str, Any] = {k: 0 for k in _COLLECTIVE_KINDS}
    census["lattice_moves"] = []
    dims = {str(int(d)) for d in lattice_dims}
    for line in compiled_text.splitlines():
        s = line.strip()
        for kind in _COLLECTIVE_KINDS:
            if f" {kind}(" in s or f" {kind}-start(" in s:
                census[kind] += 1
                if dims:
                    # every shape on the line: result (lhs) and operands
                    for shape in re.findall(r"\[([0-9,]+)\]", s):
                        if dims & set(shape.split(",")):
                            census["lattice_moves"].append(s[:160])
                            break
    return census


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the jax profiler timeline (no-op overhead otherwise)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[None]:
    """Capture a full device trace to ``log_dir`` (view with TensorBoard or
    xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device: Optional[jax.Device] = None) -> Dict[str, float]:
    """Measured device memory in MB: ``peak_mb_in_use`` is the allocator's
    peak since the process started (``memory_stats()["peak_bytes_in_use"]``),
    what the program's arrays took rather than what the process reserved.
    Raises if the backend reports none."""
    dev = device or jax.devices()[0]
    raw = dev.memory_stats()
    if not raw or "peak_bytes_in_use" not in raw:
        raise RuntimeError(f"{dev} reports no memory_stats()")
    return {
        key.replace("bytes", "mb"): raw[key] / (1024 * 1024)
        for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
        if key in raw
    }


def benchmark_fn(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 20,
    warmup: int = 3,
) -> float:
    """Average seconds per call of a jitted ``fn``: the host clock around
    ``iters`` back-to-back calls ending in ``block_until_ready`` (the
    device runs them in order, so the average is the step time)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def gpu_identity() -> str:
    """``name, power.limit`` of the card(s) as nvidia-smi reports them, one
    line per card — printed beside every number, since a card capped below
    its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu(count: int = 1):
    """The first ``count`` devices, which must be CUDA GPUs.  Anything else
    (a CPU, too few cards) raises: a measurement never falls back to
    another device."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs a CUDA GPU; JAX found {devices[0].platform!r} "
            f"({devices[0].device_kind})"
        )
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs; JAX found {len(devices)}")
    return devices[:count]


def setup_compile_cache(repo_root: str) -> str:
    """JAX's persistent compile cache: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names when it is set (JAX reads it
    itself), otherwise the fixed ``<repo_root>/.jax_cache``.  Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(repo_root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
