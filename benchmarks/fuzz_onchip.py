"""Fuzz sweep of the pruned loss on the device: random shapes and settings,
each case checked component by component and end to end.

    python benchmarks/fuzz_onchip.py [n_cases] [seed]

Cases draw (B, T, S, C, s_range), all three rnnt_types, ragged and full
boundaries, and fp32 or bf16 inputs.  A component case compares:

  stage1   scores + occupancies of the default recursion (the CUDA kernels
           on a Hopper GPU, the XLA scan core elsewhere) vs the XLA core
           over a float64 copy of the SAME rows
  ranges   the device's window argmax vs float64 window scores on the host,
           TIE-AWARE: positions may legitimately differ where two windows
           have near-equal occupancy scores, so a differing start is a
           failure only if its window scores more than TIE_EPS below the
           best; and the device's repair vs the host's repair of the
           device's own starts, exactly (integer math)
  stage2   banded loss + input gradients of ``rnnt_loss_pruned_simple`` on
           the default path vs the XLA core over a float64 lattice, with
           the SAME ranges

An end-to-end case runs the fused pipelines (``rnnt_loss_simple_pruned`` /
``rnnt_loss_smoothed_pruned``) with delay_penalty and smoothing scales
against the materialized recipe (stage-1 loss with occupancy gradients ->
``get_rnnt_prune_ranges`` -> ``do_rnnt_pruning`` -> ``rnnt_loss_pruned`` on
the [B, T, K, C] logits), loss and input gradients.

Exits nonzero on the first failure with the full config.  ``chip_smoke.py``
runs a few cases of each arm on the card.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fast_rnnt_tpu as frt  # noqa: E402
from fast_rnnt_tpu.ops import recursion  # noqa: E402
from fast_rnnt_tpu.ops.lattice import get_rnnt_logprobs_rows  # noqa: E402
from fast_rnnt_tpu.utils.parity import (  # noqa: E402
    ranges_vs_host,
    xla_float64_reference,
)

LOSS_RTOL = {False: 3e-4, True: 3e-3}
# bf16 occupancies are rounded to bf16 on the way out (~4e-3 relative), and
# bf16 gradients carry that times band-edge amplification; the f32 cases
# pin the tight bound.
GRAD_STOL = {False: 3e-3, True: 3e-2}
# The e2e arm compares TWO independently-quantized bf16 pipelines (the
# band-native fused stage 2 vs the materialized [B, T, K, C] logits path,
# which gathers and ADDS am_p + lm_p in bf16 before its own lattice), each
# rounding d_am at structurally different points, so their agreement is a
# multiple of the single-pipeline class.  f32 e2e keeps the tight bound
# and pins correctness.
E2E_GRAD_STOL = {False: 3e-3, True: 6e-2}


def scaled_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-20))


def rel_err(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-20)


def draw(rng):
    B = int(rng.integers(1, 17))
    T = int(rng.integers(8, 600))
    S = int(rng.integers(1, 80))
    C = int(rng.integers(8, 300))
    T = max(T, S + 3)
    rnnt_type = str(rng.choice(["regular", "modified", "constrained"]))
    # constrained needs s_range >= 2 (width-1 bands are provably
    # infeasible and raise; see lattice.get_rnnt_logprobs_pruned)
    min_sr = 1 if rnnt_type == "modified" else 2
    s_range = int(rng.integers(min_sr, min(S + 1, 8) + 1)) if S >= min_sr else min_sr
    s_range = max(min_sr, min(s_range, S))
    bf16 = bool(rng.integers(0, 2))
    ragged = bool(rng.integers(0, 2))
    blank = int(rng.integers(0, min(C, 3)))

    am = rng.normal(size=(B, T, C)).astype(np.float32)
    lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
    syms = rng.integers(0, C, size=(B, S)).astype(np.int32)
    syms[syms == blank] = (blank + 1) % C
    if ragged:
        t_end = np.clip(rng.integers(S + 2, T + 1, size=B), S + 2, T).astype(np.int32)
        s_end = np.clip(rng.integers(1, S + 1, size=B), 1, S).astype(np.int32)
    else:
        t_end = np.full(B, T, np.int32)
        s_end = np.full(B, S, np.int32)
    bnd = np.stack(
        [np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end], axis=1)
    return dict(B=B, T=T, S=S, C=C, rnnt_type=rnnt_type, s_range=s_range,
                bf16=bf16, ragged=ragged, blank=blank, am=am, lm=lm,
                syms=syms, bnd=bnd)


def draw_e2e(rng):
    case = draw(rng)
    case["delay_penalty"] = float(rng.choice([0.02, 0.1, 0.3]))
    case["smoothed"] = bool(rng.integers(0, 2))
    if case["smoothed"]:
        case["lm_scale"] = float(rng.choice([0.0, 0.1, 0.25]))
        case["am_scale"] = float(rng.choice([0.0, 0.1, 0.2]))
    else:
        case["lm_scale"] = case["am_scale"] = 0.0
    return case


def shrink(case, B, T, S, s_range_max):
    """Cut a drawn case down to at most (B, T, S) in place (for quick runs
    on the CPU), keeping its boundaries and s_range valid."""
    B = min(B, case["B"])
    T = min(T, case["T"])
    S = min(S, case["S"])
    case["am"] = case["am"][:B, :T]
    case["lm"] = case["lm"][:B, :S + 1]
    case["syms"] = case["syms"][:B, :S]
    bnd = case["bnd"][:B].copy()
    bnd[:, 2] = np.clip(bnd[:, 2], 2 if S >= 2 else 1, S)
    bnd[:, 3] = np.clip(bnd[:, 3], bnd[:, 2] + 2, T)
    case["bnd"] = bnd
    case["B"], case["T"], case["S"] = B, T, S
    min_sr = 1 if case["rnnt_type"] == "modified" else 2
    case["s_range"] = max(min_sr, min(case["s_range"], s_range_max, S))
    return case


def _inputs(case):
    am = jnp.asarray(case["am"])
    lm = jnp.asarray(case["lm"])
    if case["bf16"]:
        am, lm = am.astype(jnp.bfloat16), lm.astype(jnp.bfloat16)
    ldt = jnp.bfloat16 if case["bf16"] else None
    return am, lm, jnp.asarray(case["syms"]), jnp.asarray(case["bnd"]), ldt


def _cfg(case, idx, keys):
    cfg = {k: case[k] for k in keys}
    cfg["case"] = idx
    return cfg


def run_case(case, idx):
    """The component arm (module docstring).  Returns (cfg, errs, failure
    or None)."""
    am, lm, symbols, boundary, ldt = _inputs(case)
    blank, K, rnnt_type = case["blank"], case["s_range"], case["rnnt_type"]
    bf = case["bf16"]
    cfg = _cfg(case, idx, ("B", "T", "S", "C", "rnnt_type", "s_range", "bf16",
                           "ragged", "blank"))
    errs = {}

    # --- stage 1: the default recursion vs float64, same rows --------------
    base = "modified" if rnnt_type == "constrained" else rnnt_type
    px_rows, py_rows = jax.jit(
        lambda a, l: get_rnnt_logprobs_rows(
            l, a, symbols, blank, base, boundary, out_dtype=ldt)
    )(am, lm)
    if rnnt_type == "constrained":
        px_rows = px_rows + py_rows[1:]
    s_d, (gx_d, gy_d) = jax.jit(
        lambda a, b: recursion.mutual_information_rows(
            a, b, boundary, calc_gradients=True)
    )(px_rows, py_rows)
    with jax.enable_x64(True):
        s_x, (gx_x, gy_x) = jax.jit(
            lambda a, b: recursion.mutual_information_rows(
                a, b, boundary, calc_gradients=True, impl="xla")
        )(px_rows.astype(jnp.float64), py_rows.astype(jnp.float64))
        s_x, gx_x, gy_x = (np.asarray(v) for v in (s_x, gx_x, gy_x))
    errs["stage1_score"] = scaled_err(s_d, s_x)
    errs["stage1_gx"] = scaled_err(gx_d.astype(jnp.float32), gx_x)
    errs["stage1_gy"] = scaled_err(gy_d.astype(jnp.float32), gy_x)
    if (errs["stage1_score"] > LOSS_RTOL[bf] or errs["stage1_gx"] > GRAD_STOL[bf]
            or errs["stage1_gy"] > GRAD_STOL[bf]):
        return cfg, errs, "stage1 parity failure"

    # --- ranges: device vs host over the device's occupancies --------------
    gx_f = gx_d.astype(jnp.float32)
    gy_f = gy_d.astype(jnp.float32)
    non_tie, repair_diffs, ranges = ranges_vs_host(gx_f, gy_f, boundary, K)
    errs["ranges_non_tie_diffs"] = non_tie
    errs["ranges_repair_diffs"] = repair_diffs
    if non_tie:
        return cfg, errs, "window argmax failure beyond tie tolerance"
    if repair_diffs:
        return cfg, errs, "device repair != host repair of the same starts"

    # --- stage 2: default vs float64 XLA core, same ranges -----------------
    ranges = jnp.asarray(ranges)

    def stage2(a, l):
        return frt.rnnt_loss_pruned_simple(
            l, a, symbols, ranges, blank, boundary, rnnt_type,
            reduction="sum", lattice_dtype=ldt,
        )

    v_d, (ga_d, gl_d) = jax.jit(jax.value_and_grad(stage2, argnums=(0, 1)))(am, lm)
    _, p_x, ga_x, gl_x = xla_float64_reference(
        am, lm, symbols, boundary, ranges[:, :, 0], ranges.shape[2],
        rnnt_type, blank=blank, lattice_dtype=ldt, weights=(0.0, 1.0),
    )
    v_x = float(np.sum(p_x))
    if not (np.isfinite(float(v_d)) and np.isfinite(v_x)):
        return cfg, errs, f"non-finite stage2 loss {float(v_d)} {v_x}"
    errs["stage2_loss"] = rel_err(v_d, v_x)
    errs["stage2_dam"] = scaled_err(ga_d.astype(jnp.float32), ga_x)
    errs["stage2_dlm"] = scaled_err(gl_d.astype(jnp.float32), gl_x)
    if (errs["stage2_loss"] > LOSS_RTOL[bf] or errs["stage2_dam"] > GRAD_STOL[bf]
            or errs["stage2_dlm"] > GRAD_STOL[bf]):
        return cfg, errs, "stage2 parity failure"
    return cfg, errs, None


def run_case_e2e(case, idx):
    """The end-to-end arm (module docstring).  Near-tie flips between the
    two stage-1 graphs may legitimately pick different ranges, so the
    materialized stage 2 consumes the FUSED pipeline's ranges; how often
    the materialized stage 1's own ranges agree is recorded as info."""
    am, lm, symbols, boundary, ldt = _inputs(case)
    blank, K, rnnt_type = case["blank"], case["s_range"], case["rnnt_type"]
    bf = case["bf16"]
    dp = case["delay_penalty"]
    smoothed = case["smoothed"]
    lsc, asc = case["lm_scale"], case["am_scale"]
    cfg = _cfg(case, idx, ("B", "T", "S", "C", "rnnt_type", "s_range", "bf16",
                           "ragged", "blank", "delay_penalty", "smoothed",
                           "lm_scale", "am_scale"))
    cfg["arm"] = "e2e"
    errs = {}

    def fused(a, l):
        if smoothed:
            s, p, r = frt.rnnt_loss_smoothed_pruned(
                l, a, symbols, blank, K, lm_only_scale=lsc,
                am_only_scale=asc, boundary=boundary, rnnt_type=rnnt_type,
                delay_penalty=dp, reduction="sum", lattice_dtype=ldt,
            )
        else:
            s, p, r = frt.rnnt_loss_simple_pruned(
                l, a, symbols, blank, K, boundary, rnnt_type,
                delay_penalty=dp, reduction="sum", lattice_dtype=ldt,
            )
        return 0.5 * s + p, r

    (v_f, ranges_f), g_f = jax.jit(
        jax.value_and_grad(fused, argnums=(0, 1), has_aux=True)
    )(am, lm)
    ranges_f = jax.lax.stop_gradient(ranges_f)

    def stage1(a, l, reduction):
        if smoothed:
            return frt.rnnt_loss_smoothed(
                l, a, symbols, blank, lm_only_scale=lsc, am_only_scale=asc,
                boundary=boundary, rnnt_type=rnnt_type, delay_penalty=dp,
                reduction=reduction, calc_gradients=True,
            )
        return frt.rnnt_loss_simple(
            l, a, symbols, blank, boundary, rnnt_type,
            delay_penalty=dp, reduction=reduction, calc_gradients=True,
        )

    def materialized(a, l):
        s1, _ = stage1(a, l, "sum")
        am_p, lm_p = frt.do_rnnt_pruning(a, l, ranges_f)
        p2 = frt.rnnt_loss_pruned(
            am_p + lm_p, symbols, ranges_f, blank, boundary, rnnt_type,
            delay_penalty=dp, reduction="sum",
        )
        return 0.5 * s1 + p2

    v_m, g_m = jax.jit(jax.value_and_grad(materialized, argnums=(0, 1)))(am, lm)

    _, (gx, gy) = jax.jit(lambda a, l: stage1(a, l, "none"))(am, lm)
    ranges_m = frt.get_rnnt_prune_ranges(gx, gy, boundary, K)
    errs["ranges_diff_frac"] = float(
        np.mean(np.asarray(ranges_m) != np.asarray(ranges_f)))

    if not (np.isfinite(float(v_f)) and np.isfinite(float(v_m))):
        return cfg, errs, f"non-finite e2e loss {float(v_f)} {float(v_m)}"
    errs["e2e_loss"] = rel_err(v_f, v_m)
    errs["e2e_dam"] = scaled_err(g_f[0], g_m[0])
    errs["e2e_dlm"] = scaled_err(g_f[1], g_m[1])
    if (errs["e2e_loss"] > LOSS_RTOL[bf] or errs["e2e_dam"] > E2E_GRAD_STOL[bf]
            or errs["e2e_dlm"] > E2E_GRAD_STOL[bf]):
        return cfg, errs, "end-to-end fused-vs-materialized parity failure"
    return cfg, errs, None


def sweep(n_cases, n_e2e, seed, log=print):
    """Draw and run ``n_cases`` component cases, then ``n_e2e`` end-to-end
    cases; one JSON line per case through ``log``.  Raises AssertionError
    on the first failure."""
    rng = np.random.default_rng(seed)
    arms = [(draw, run_case)] * n_cases + [(draw_e2e, run_case_e2e)] * n_e2e
    for i, (draw_fn, run_fn) in enumerate(arms):
        cfg, errs, fail = run_fn(draw_fn(rng), i)
        row = {**cfg, **{k: (float(f"{v:.4g}") if isinstance(v, float) else v)
                         for k, v in errs.items()}}
        if fail:
            log(json.dumps({"FAIL": fail, **row}))
            raise AssertionError(f"{fail}: {row}")
        log(json.dumps(row))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_cases", type=int, nargs="?", default=24)
    ap.add_argument("seed", type=int, nargs="?", default=0)
    args = ap.parse_args()
    n_e2e = max(12, args.n_cases // 2)
    print(json.dumps({"device": str(jax.devices()[0]), "cases": args.n_cases,
                      "e2e_cases": n_e2e, "seed": args.seed}), flush=True)
    try:
        sweep(args.n_cases, n_e2e, args.seed,
              log=lambda line: print(line, flush=True))
    except AssertionError:
        raise SystemExit(1)
    print(json.dumps({"result": "ALL_PASS", "cases": args.n_cases + n_e2e}),
          flush=True)


if __name__ == "__main__":
    main()
