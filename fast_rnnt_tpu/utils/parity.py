"""On-device compiled parity gate.

The reference runs its backward round-trip self-check on EVERY production
call, on the real device (tf_fast_rnnt_op.cc:110 enabling
mutual_information_cuda.cu:510-514,756-758).  A host check per step would
stall the pipeline, so this module packages the equivalent evidence as a
gate that runs ON THE MEASURED DEVICE, compiled, before timing:

  1. ``default_vs_xla`` — the fused band-native pipeline on the default
     path (the GPU recursion kernels on a GPU) vs the XLA scan core run
     under ``jax.default_matmul_precision("highest")`` over a float64 copy
     of the lattice, on identical inputs and pruning band, losses AND
     input gradients; plus the default path's stage-1 occupancies vs a
     float64 recursion, and the prune ranges computed on the device from
     those occupancies vs the same ranges computed on the host in numpy
     (tie-aware window argmax, exact repair).
  2. ``roundtrip`` — the occupancy backward's conservation identity at the
     full bench shape (the reference's .cu:510-514 check).
  3. ``golden`` — the path-enumeration golden vectors (tests/golden/,
     f64 first-principles, no DP recursion in their derivation) through
     the compiled default path, including the banded (pruned) variant.
  4. ``bf16`` — the bf16-lattice mode vs fp32 (loss tracking + occupancy
     conservation; a bf16-stored p residual fails this at scale).

Every number is produced by jit-compiled code on the queried device, so a
kernel that compiles to wrong code fails here even when every CPU test
passes.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "describe",
    "enforce_parity",
    "host_prune_ranges",
    "invalid_ranges",
    "onchip_parity_gate",
    "ranges_vs_host",
    "xla_float64_reference",
]

# window-score gap (occupancy units) below which two window starts are a
# near-tie that two float evaluations may legitimately order either way
TIE_EPS = 1e-3


def _rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = np.maximum(np.abs(b), 1e-6)
    return float(np.max(np.abs(a - b) / denom))


def _abs_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _scaled_err(a, b) -> float:
    """max |a - b| normalized by the global magnitude of b — the right
    metric for gradient tensors, whose entries cross zero (pointwise
    relative error at a zero crossing is noise, not signal)."""
    b = np.asarray(b, np.float64)
    return _abs_err(a, b) / max(float(np.max(np.abs(b))), 1e-6)


def _host_monotonic_lower_bound(x: np.ndarray) -> np.ndarray:
    return np.minimum.accumulate(x[:, ::-1], axis=1)[:, ::-1]


def host_prune_ranges(gx_rows, gy_rows, boundary, s_range: int):
    """``get_rnnt_prune_ranges_rows`` restated in numpy: float64 window
    scores by brute-force window sums, their argmax, the end-of-utterance
    padding and the monotone / step-bounded repair.

    Returns ``(scores [S+2-K, B, T] float64, raw starts [B, T], ranges
    [B, T, K])``; :func:`host_repair` alone is the last two steps."""
    gx = np.asarray(gx_rows, np.float64)
    gy = np.asarray(gy_rows, np.float64)
    S, B, T1 = gx.shape
    S1, _, T = gy.shape
    K = s_range if s_range <= S else S + 1
    gx_pad = np.concatenate([np.zeros((1, B, T1)), gx])
    scores = np.stack(
        [gy[k:k + K].sum(0) - gx_pad[k, :, :T] for k in range(S1 - K + 1)]
    )
    raw = scores.argmax(0).astype(np.int32)
    return scores, raw, host_repair(raw, boundary, s_range, S, T1 == T)


def host_repair(raw, boundary, s_range: int, S: int, modified: bool):
    """The padding and repair of :func:`host_prune_ranges` applied to given
    raw window starts ``[B, T]``; returns ranges ``[B, T, K]``."""
    raw = np.asarray(raw, np.int64)
    bnd = np.asarray(boundary, np.int64)
    K = s_range if s_range <= S else S + 1
    T = raw.shape[1]
    mask = np.arange(T)[None, :] < bnd[:, 3:4] - 1
    s = np.where(mask, raw, np.maximum(bnd[:, 2:3] - K + 1, 0))
    ramp = ((2 if modified else K) - 1) * np.arange(T)
    s = -(_host_monotonic_lower_bound(s) - ramp)
    s = np.maximum(_host_monotonic_lower_bound(s), 0)
    s = -(s - ramp)
    return (s[:, :, None] + np.arange(K)).astype(np.int32)


def ranges_vs_host(gx_rows, gy_rows, boundary, s_range: int):
    """The device's window argmax and prune ranges from the occupancies
    ``(gx_rows, gy_rows)`` against :func:`host_prune_ranges` over the same
    occupancies.  Returns ``(non_tie_argmax_diffs, repair_diffs,
    device_ranges)``:

    * a device start that differs from the host's is a failure only where
      the host's float64 score of the device's window is more than
      ``TIE_EPS`` below the best (a near-tie may go either way);
    * the repair is integer math, so the device's ranges must equal the
      host's repair of the device's own raw starts exactly."""
    from fast_rnnt_tpu.ops.pruning import _window_argmax, get_rnnt_prune_ranges_rows

    S = gx_rows.shape[0]
    K = s_range if s_range <= S else S + 1
    raw_d, ranges_d = jax.jit(
        lambda a, b, bnd: (
            _window_argmax(a, b, K),
            get_rnnt_prune_ranges_rows(a, b, bnd, s_range),
        )
    )(gx_rows, gy_rows, boundary)
    raw_d, ranges_d = np.asarray(raw_d), np.asarray(ranges_d)
    scores, raw_h, _ = host_prune_ranges(gx_rows, gy_rows, boundary, s_range)
    best = np.take_along_axis(scores, raw_h[None], 0)[0]
    picked = np.take_along_axis(scores, raw_d[None].astype(np.int64), 0)[0]
    non_tie = int(np.sum((raw_d != raw_h) & (picked < best - TIE_EPS)))
    modified = gx_rows.shape[2] == gy_rows.shape[2]
    repaired = host_repair(raw_d, boundary, s_range, S, modified)
    return non_tie, int(np.sum(ranges_d != repaired)), ranges_d


def invalid_ranges(ranges, S: int, modified: bool) -> int:
    """Frames whose window start breaks the repair's guarantees: the first
    start is 0, starts never fall, step by less than the bound (2 for
    modified/constrained, K for regular) and stay within [0, S + 1 - K]."""
    starts = np.asarray(ranges)[:, :, 0].astype(np.int64)
    K = np.asarray(ranges).shape[2]
    step = np.diff(starts, axis=1)
    return int(
        np.sum(starts[:, 0] != 0)
        + np.sum(step < 0)
        + np.sum(step >= (2 if modified else K))
        + np.sum((starts < 0) | (starts > max(S + 1 - K, 0)))
    )


def xla_float64_reference(
    am, lm, symbols, boundary, lo, s_range: int, rnnt_type: str = "regular",
    blank: int = 0, lattice_dtype=None, weights=(1.0, 1.0),
):
    """The fused pipeline's two stages with the XLA scan core recursing
    over a float64 copy of the lattice (built in float32 at HIGHEST matmul
    precision, rounded through ``lattice_dtype`` first when given, as the
    pipeline stores it), pruned with the given band ``lo`` ``[B, T]`` of
    width ``s_range``.

    Returns numpy ``(simple [B], pruned [B], d_am, d_lm)``, the losses per
    utterance and the gradients of ``weights[0] * sum(simple) +
    weights[1] * sum(pruned)``.  float64 takes the core's own float32
    rounding out of a comparison (at |p| ~ 6000 it alone is ~5e-3 on the
    occupancies)."""
    from fast_rnnt_tpu.ops.lattice import (
        band_mask_rows_smajor,
        get_rnnt_logprobs_rows,
    )
    from fast_rnnt_tpu.ops.recursion import mutual_information_rows

    base = "modified" if rnnt_type == "constrained" else rnnt_type

    def as_f64(x):
        if lattice_dtype is not None:
            x = x.astype(lattice_dtype)
        return x.astype(jnp.float64)

    def loss_fn(a, l):
        px, py = get_rnnt_logprobs_rows(l, a, symbols, blank, base, boundary)
        px_s = px_b = px
        if rnnt_type == "constrained":
            px_s = px + py[1:]
            px_b = px + band_mask_rows_smajor(py, lo, s_range)[1:]
        px_s, px_b, py = as_f64(px_s), as_f64(px_b), as_f64(py)
        simple = -mutual_information_rows(px_s, py, boundary, impl="xla")
        pruned = -mutual_information_rows(
            px_b, py, boundary, lo=lo, s_range=s_range, impl="xla"
        )
        return simple, pruned

    def run(a, l):
        (simple, pruned), vjp = jax.vjp(loss_fn, a, l)
        g_am, g_lm = vjp((jnp.full_like(simple, weights[0]),
                          jnp.full_like(pruned, weights[1])))
        return simple, pruned, g_am, g_lm

    with jax.default_matmul_precision("highest"), jax.enable_x64(True):
        return tuple(np.asarray(v) for v in jax.jit(run)(am, lm))


def onchip_parity_gate(
    am: jax.Array,
    lm: jax.Array,
    symbols: jax.Array,
    boundary: jax.Array,
    s_range: int,
    golden_dir: Optional[str] = None,
    rnnt_type: str = "regular",
) -> Dict[str, float]:
    """Run the four compiled parity checks (module docstring) on the
    default device with the given bench-shape inputs.  Returns a flat
    dict of error metrics; see :func:`enforce_parity` for the pass/fail
    thresholds."""
    import fast_rnnt_tpu as frt
    from fast_rnnt_tpu.ops.lattice import get_rnnt_logprobs_rows
    from fast_rnnt_tpu.ops.recursion import (
        mutual_information_rows,
        occupancy_roundtrip_check,
    )

    out: Dict[str, float] = {}
    B = am.shape[0]

    # --- 1. fused pipeline: default impl vs the XLA scan core ------------
    def fused(impl, lattice_dtype, am_, lm_):
        def loss_fn(a, l):
            simple, pruned, ranges = frt.rnnt_loss_simple_pruned(
                l, a, symbols, 0, s_range, boundary, rnnt_type=rnnt_type,
                reduction="none", impl=impl, lattice_dtype=lattice_dtype,
            )
            return (simple, pruned), ranges

        (simple, pruned), vjp, ranges = jax.vjp(
            loss_fn, am_, lm_, has_aux=True
        )
        g_am, g_lm = vjp((jnp.ones_like(simple), jnp.ones_like(pruned)))
        return simple, pruned, g_am, g_lm, ranges

    run = jax.jit(fused, static_argnums=(0, 1))
    s_d, p_d, ga_d, gl_d, r_d = run(None, None, am, lm)
    # The reference side shares the default side's pruning band: the
    # ranges are an argmax over stage-1 occupancies, and where two windows
    # near-tie two float32 evaluations may pick different, equally valid
    # bands, after which whole-pipeline gradients legitimately differ.
    # The occupancies and the ranges themselves are checked in 1b and 1c.
    s_x, p_x, ga_x, gl_x = xla_float64_reference(
        am, lm, symbols, boundary, r_d[:, :, 0], r_d.shape[2], rnnt_type
    )
    out["default_vs_xla_loss_rel_err"] = max(
        _rel_err(s_d, s_x), _rel_err(p_d, p_x)
    )
    out["default_vs_xla_grad_rel_err"] = max(
        _scaled_err(ga_d, ga_x), _scaled_err(gl_d, gl_x)
    )

    # --- 1b. stage-1 occupancies (what the ranges are chosen from) against
    # a float64 evaluation of the same lattice ----------------------------
    px, py = jax.jit(
        lambda a, l: get_rnnt_logprobs_rows(
            l, a, symbols, 0, rnnt_type, boundary
        )
    )(am, lm)
    _, (gx, gy) = jax.jit(
        lambda a, b: mutual_information_rows(a, b, boundary, calc_gradients=True)
    )(px, py)
    with jax.enable_x64(True):
        _, (gx64, gy64) = jax.jit(
            lambda a, b: mutual_information_rows(
                a, b, boundary, calc_gradients=True, impl="xla"
            )
        )(px.astype(jnp.float64), py.astype(jnp.float64))
        gx64, gy64 = np.asarray(gx64), np.asarray(gy64)
    out["occupancy_vs_f64_max_abs_err"] = max(
        _abs_err(gx, gx64), _abs_err(gy, gy64)
    )

    # --- 1c. prune ranges: the device's from those occupancies vs the
    # host's; the fused pipeline's own ranges vs the device's -------------
    non_tie, repair_diffs, ranges_dev = ranges_vs_host(gx, gy, boundary, s_range)
    out["ranges_non_tie_argmax_diffs"] = non_tie
    out["ranges_repair_diffs"] = repair_diffs
    r_d = np.asarray(r_d)
    out["pipeline_ranges_invalid"] = invalid_ranges(
        r_d, symbols.shape[1], rnnt_type != "regular"
    )
    out["pipeline_vs_device_ranges_frac"] = float(
        np.mean(r_d[:, :, 0] != ranges_dev[:, :, 0])
    )

    # --- 2. occupancy round-trip at the bench shape -----------------------
    @jax.jit
    def roundtrip(am_, lm_):
        px, py = frt.get_rnnt_logprobs(lm_, am_, symbols, 0, rnnt_type, boundary)
        _, (gx, gy) = frt.mutual_information_recursion(
            px, py, boundary, calc_gradients=True
        )
        return occupancy_roundtrip_check(gx, gy, boundary, jnp.ones((B,)))

    out["roundtrip_max_abs_err"] = float(jnp.max(roundtrip(am, lm)))

    # --- 3. golden path-enumeration vectors ------------------------------
    if golden_dir is None:
        golden_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "tests", "golden",
        )
    golden_score_err = 0.0
    golden_grad_err = 0.0
    files = sorted(glob.glob(os.path.join(golden_dir, "*.npz")))

    @jax.jit
    def run_plain(px, py, bnd):
        return frt.mutual_information_recursion(px, py, bnd, calc_gradients=True)

    def run_banded(px, py, bnd, lo, K):
        f = jax.jit(
            lambda px, py, bnd, lo: mutual_information_rows(
                jnp.moveaxis(px, 1, 0), jnp.moveaxis(py, 1, 0), bnd,
                lo=lo, s_range=K, calc_gradients=True,
            )
        )
        s, (gx, gy) = f(px, py, bnd, lo)
        return s, (jnp.moveaxis(gx, 0, 1), jnp.moveaxis(gy, 0, 1))

    for path in files:
        z = np.load(path)
        px = jnp.asarray(z["px"], jnp.float32)
        py = jnp.asarray(z["py"], jnp.float32)
        bnd = jnp.asarray(z["boundary"])
        if "lo" in z.files:
            s, (gx, gy) = run_banded(px, py, bnd, jnp.asarray(z["lo"]), int(z["K"]))
        else:
            s, (gx, gy) = run_plain(px, py, bnd)
        golden_score_err = max(golden_score_err, _abs_err(s, z["scores"]))
        golden_grad_err = max(
            golden_grad_err,
            _abs_err(gx, z["px_grad"]),
            _abs_err(gy, z["py_grad"]),
        )
    out["golden_scores_max_abs_err"] = golden_score_err
    out["golden_grads_max_abs_err"] = golden_grad_err
    out["golden_cases"] = len(files)

    # --- 4. bf16-lattice mode ---------------------------------------------
    s_b, p_b, _, _, _ = run(None, jnp.bfloat16, am, lm)
    out["bf16_loss_rel_err"] = max(_rel_err(s_b, s_d), _rel_err(p_b, p_d))

    @jax.jit
    def conservation_bf16(am_, lm_):
        px, py = frt.get_rnnt_logprobs(lm_, am_, symbols, 0, rnnt_type, boundary)
        _, (gx, gy) = frt.mutual_information_recursion(
            px.astype(jnp.bfloat16), py.astype(jnp.bfloat16), boundary,
            calc_gradients=True,
        )
        tot = gx.astype(jnp.float32).sum((1, 2)) + gy.astype(jnp.float32).sum((1, 2))
        # every path crosses t_end frames, plus s_end symbol arcs that do
        # not advance t in the regular topology
        expect = boundary[:, 3].astype(jnp.float32)
        if rnnt_type == "regular":
            expect = expect + boundary[:, 2].astype(jnp.float32)
        return jnp.max(jnp.abs(tot - expect) / expect)

    out["bf16_occupancy_rel_err"] = float(conservation_bf16(am, lm))
    return out


# pass/fail thresholds, each with its reason.  Loss/grad comparisons are
# RELATIVE (per-utterance losses are O(1000) at the bench shape; two f32
# evaluation orders differ in the last few ulps of that magnitude).  The
# round-trip error is naturally scaled (seed = 1); golden shapes are tiny
# so absolute error is the sharp criterion there.
TOLERANCES = {
    "default_vs_xla_loss_rel_err": 1e-4,
    "default_vs_xla_grad_rel_err": 5e-3,
    "roundtrip_max_abs_err": 1e-2,
    "golden_scores_max_abs_err": 1e-4,
    "golden_grads_max_abs_err": 5e-4,
    "bf16_loss_rel_err": 2e-2,
    "bf16_occupancy_rel_err": 2e-2,
    "occupancy_vs_f64_max_abs_err": 1e-2,
    "ranges_non_tie_argmax_diffs": 0,
    "ranges_repair_diffs": 0,
    "pipeline_ranges_invalid": 0,
    "pipeline_vs_device_ranges_frac": 0.1,
}

REASONS = {
    "default_vs_xla_loss_rel_err":
        "f32 vs f64 evaluation of an O(1000) log-sum over ~1100 steps",
    "default_vs_xla_grad_rel_err":
        "max abs error over the largest gradient; grads cross zero",
    "roundtrip_max_abs_err":
        "f32 occupancy flow summed over T=1000 lattices, seed 1",
    "golden_scores_max_abs_err":
        "f32 recursion vs float64 path enumeration on tiny lattices",
    "golden_grads_max_abs_err":
        "occupancies chain f32 exp() of differences; float64 reference",
    "bf16_loss_rel_err": "bf16 storage rounds each arc (~0.4%)",
    "bf16_occupancy_rel_err": "bf16 storage rounds each occupancy cell",
    "occupancy_vs_f64_max_abs_err":
        "float32 occupancies where |p| reaches ~6000 (ulp ~5e-4): the XLA "
        "core sits ~5e-3 from float64 at the bench shape",
    "ranges_non_tie_argmax_diffs":
        f"window starts the host's float64 scores rank more than {TIE_EPS:g} "
        "below the best; near-ties may go either way",
    "ranges_repair_diffs":
        "integer repair of the device's own starts, restated in numpy",
    "pipeline_ranges_invalid":
        "frames of the fused pipeline's ranges that break the repair's "
        "guarantees (start 0, monotone, bounded step, in range)",
    "pipeline_vs_device_ranges_frac":
        "frames whose fused-pipeline window start differs from 1c's; "
        "exact ties (e.g. three windows holding the same mass) may flip "
        "between two compiled programs and carry through the repair",
}


def describe(parity: Dict[str, float]) -> Dict[str, str]:
    """One line per gate metric: value, limit and the limit's reason."""
    def fmt(k, v):
        tol = TOLERANCES[k]
        if isinstance(tol, int):  # a count
            return f"{v} <= {tol}"
        return f"{v:.3e} <= {tol:.0e}"

    return {
        k: f"{fmt(k, v)} ({REASONS[k]})"
        for k, v in parity.items() if k in TOLERANCES
    }


def enforce_parity(parity: Dict[str, float]) -> None:
    """Raise FloatingPointError if any gate metric exceeds its tolerance
    (NaN counts as failure)."""
    bad = {
        k: v
        for k, tol in TOLERANCES.items()
        if k in parity and not (float(v := parity[k]) <= tol)
    }
    if bad:
        lims = {k: TOLERANCES[k] for k in bad}
        raise FloatingPointError(
            f"on-device parity gate FAILED: {bad} (limits: {lims}) — "
            "the compiled path is producing wrong numbers; benchmark "
            "results are not certified"
        )
