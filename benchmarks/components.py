"""Where the pruned training step spends its time on one GPU, for the
recursion kernels (impl="cuda") and the XLA scan core (impl="xla").

    python benchmarks/components.py [--out chiprun_out/components.json]

1. The full step (bench.py's workload: B=30, T=1000, S=100, C=500,
   s_range=5) timed in turns xla, cuda, cuda, xla, fp32 and bf16.
2. Each stage alone, jitted: lattice build (forward, forward+VJP),
   stage-1 recursion with occupancies, prune ranges, stage-2 banded
   recursion (forward, forward+VJP).
3. A profiler trace of one full step per impl (fp32, and bf16 with the
   kernels), reduced to device time per
   named scope of ``rnnt_loss_simple_pruned`` (lattice_build,
   stage1_recursion, prune_ranges, stage2_recursion; "other" is what lies
   outside them), with kernel counts and the busiest ops.

Times are the host clock around ``block_until_ready``; trace times are
the device durations of the kernels.  The card's name and power limit are
printed with the results.
"""

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fast_rnnt_tpu as frt  # noqa: E402
from bench import B, C, S, S_RANGE, T, make_inputs, step_fn  # noqa: E402
from fast_rnnt_tpu.ops import lattice  # noqa: E402
from fast_rnnt_tpu.utils.profiling import (  # noqa: E402
    benchmark_fn,
    gpu_identity,
    require_gpu,
    setup_compile_cache,
)

SCOPES = ("lattice_build", "stage1_recursion", "prune_ranges",
          "stage2_recursion")
IMPLS = ("xla", "cuda")


def _us(fn, *args, iters=20):
    return benchmark_fn(jax.jit(fn), *args, iters=iters) * 1e6


def full_step(inputs):
    out = {}
    for tag, (am, lm) in (
        ("fp32", inputs[:2]),
        ("bf16", (inputs[0].astype(jnp.bfloat16), inputs[1].astype(jnp.bfloat16))),
    ):
        fns = {impl: jax.jit(lambda a, l, impl=impl: step_fn(
            a, l, inputs[2], inputs[3], impl=impl)) for impl in IMPLS}
        for f in fns.values():
            jax.block_until_ready(f(am, lm))  # compile outside the turns
        out[tag] = [
            (impl, benchmark_fn(fns[impl], am, lm, iters=20) * 1e6)
            for impl in ("xla", "cuda", "cuda", "xla")
        ]
        print(json.dumps({"full_step_us": tag, "turns": out[tag]}), flush=True)
    return out


def stages(inputs):
    am, lm, symbols, boundary = inputs

    def build(a, l):
        return lattice.get_rnnt_logprobs_rows(l, a, symbols, 0, "regular", boundary)

    def build_vjp(a, l):
        def f(a_, l_):
            px, py = build(a_, l_)
            return (jnp.sum(jnp.where(jnp.isinf(px), 0.0, px))
                    + jnp.sum(jnp.where(jnp.isinf(py), 0.0, py)))
        return jax.value_and_grad(f, argnums=(0, 1))(a, l)

    px, py = jax.block_until_ready(jax.jit(build)(am, lm))
    _, (gx, gy) = frt.mutual_information_rows(px, py, boundary, calc_gradients=True)
    lo = frt.get_rnnt_prune_ranges_rows(gx, gy, boundary, S_RANGE)[:, :, 0]
    rows = {"lattice_build_fwd": _us(build, am, lm),
            "lattice_build_fwd_vjp": _us(build_vjp, am, lm),
            "prune_ranges": _us(lambda a, b: frt.get_rnnt_prune_ranges_rows(
                a, b, boundary, S_RANGE), gx, gy)}
    for impl in IMPLS:
        rows[f"stage1_recursion_with_occupancies[{impl}]"] = _us(
            lambda a, b: frt.mutual_information_rows(
                a, b, boundary, calc_gradients=True, impl=impl), px, py)
        rows[f"stage2_banded_fwd[{impl}]"] = _us(
            lambda a, b, l: frt.mutual_information_rows(
                a, b, boundary, lo=l, s_range=S_RANGE, impl=impl), px, py, lo)
        rows[f"stage2_banded_fwd_vjp[{impl}]"] = _us(
            lambda a, b, l: jax.value_and_grad(
                lambda a_, b_: jnp.sum(frt.mutual_information_rows(
                    a_, b_, boundary, lo=l, s_range=S_RANGE, impl=impl)),
                argnums=(0, 1))(a, b), px, py, lo)
    print(json.dumps({"stages_us": rows}), flush=True)
    return rows


def _op_scopes(hlo_text):
    """HLO instruction name -> the named scope its metadata places it in."""
    scopes = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"", hlo_text):
        name, op_name = m.group(1), m.group(2)
        scopes[name] = next((s for s in SCOPES if s in op_name), "other")
    return scopes


def traced(inputs):
    """One traced step per impl, reduced to device time per scope."""
    from jax.profiler import ProfileData

    am32, lm32, symbols, boundary = inputs
    out = {}
    runs = [(impl, "fp32") for impl in IMPLS] + [("cuda", "bf16")]
    for impl, tag in runs:
        am, lm = am32, lm32
        if tag == "bf16":
            am, lm = am.astype(jnp.bfloat16), lm.astype(jnp.bfloat16)
        f = jax.jit(lambda a, l: step_fn(a, l, symbols, boundary, impl=impl))
        compiled = f.lower(am, lm).compile()
        scopes = _op_scopes(compiled.as_text())
        for _ in range(3):
            jax.block_until_ready(compiled(am, lm))
        d = tempfile.mkdtemp(prefix="frt_trace_")
        jax.profiler.start_trace(d)
        jax.block_until_ready(compiled(am, lm))
        jax.profiler.stop_trace()
        path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                                recursive=True))[-1]
        pd = ProfileData.from_file(path)
        per_scope, per_op, count, spans, lines = {}, {}, 0, [], {}
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                evs = list(line.events)
                lines[line.name] = len(evs)
                # the kernels (and copies) the device ran, one line per
                # CUDA stream
                if not line.name.startswith("Stream"):
                    continue
                for e in evs:
                    stats = dict(e.stats)
                    op = str(stats.get("hlo_op", e.name))
                    scope = scopes.get(op, "other")
                    dur = e.duration_ns / 1e3
                    per_scope[scope] = per_scope.get(scope, 0.0) + dur
                    per_op[op] = per_op.get(op, 0.0) + dur
                    count += 1
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
        spans.sort()
        busy, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        window = (spans[-1][1] - spans[0][0]) if spans else 0
        out[f"{impl}_{tag}"] = {
            "device_us_by_scope": per_scope,
            "kernels": count,
            "busy_us": busy / 1e3,
            "first_to_last_kernel_us": window / 1e3,
            "top_ops_us": sorted(per_op.items(), key=lambda kv: -kv[1])[:12],
            "device_lines": lines,
        }
        print(json.dumps({"trace": f"{impl}_{tag}", **out[f"{impl}_{tag}"]}),
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args()
    setup_compile_cache(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dev = require_gpu()[0]
    card = gpu_identity()
    print(json.dumps({"device": dev.device_kind, "card": card}), flush=True)
    inputs = make_inputs()
    t0 = time.perf_counter()
    result = {"device": dev.device_kind, "card": card,
              "workload": {"B": B, "T": T, "S": S, "C": C, "s_range": S_RANGE},
              "full_step_us": full_step(inputs), "stages_us": stages(inputs),
              "trace": traced(inputs)}
    result["wall_s"] = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
