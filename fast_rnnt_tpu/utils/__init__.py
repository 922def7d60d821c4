from .profiling import (
    annotate,
    benchmark_fn,
    collective_census,
    device_memory_stats,
    gpu_identity,
    require_gpu,
    setup_compile_cache,
    trace_to,
)
from .validation import check_rnnt_inputs, checkify_rnnt_inputs

__all__ = [
    "annotate",
    "benchmark_fn",
    "collective_census",
    "device_memory_stats",
    "gpu_identity",
    "require_gpu",
    "setup_compile_cache",
    "trace_to",
    "check_rnnt_inputs",
    "checkify_rnnt_inputs",
]
