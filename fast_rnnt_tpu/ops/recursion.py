"""Mutual-information lattice recursion — the differentiable core op.

This is the JAX replacement for the reference's CUDA kernel pair +
TF custom op (+ gradient registration):

  * forward wavefront kernel   /root/reference/tf_fast_rnnt/csrc/
                               mutual_information_cuda.cu:174-422
  * fused backward kernel      mutual_information_cuda.cu:490-760
  * op glue                    tf_fast_rnnt/python/csrc/tf_fast_rnnt_op.cc:43-133
  * autodiff registration      tf_fast_rnnt/python/tf_fast_rnnt/__init__.py:154-162

Recursion (docstring of ``mutual_information_recursion`` below; identical to
reference __init__.py:115-133):

    p[b, s_begin, t_begin] = 0
    regular:   p[b,s,t] = logadd(p[b,s-1,t]   + px[b,s-1,t],
                                 p[b,s,t-1]   + py[b,s,t-1])
    modified:  p[b,s,t] = logadd(p[b,s-1,t-1] + px[b,s-1,t-1],
                                 p[b,s,t-1]   + py[b,s,t-1])
    scores[b] = p[b, s_end, t_end]

Two implementations share one contract:

  * the XLA scan core (``impl="xla"``, every backend; see ops/numerics.py
    for the derivation): for each row ``s`` the recursion is a first-order
    linear recurrence along ``t`` in the log-semiring, solved with an
    associative scan — S+1 sequential steps, each vectorized over (B, T+1).
    The backward (occupancy) recursion is the same structure in ordinary
    algebra, run over rows in reverse.
  * the GPU wavefront kernels (``impl="cuda"``,
    ops/kernels/mutual_information.cu): one block per utterance walks the
    lattice diagonals with the carry on chip, one launch per direction —
    the reference's CUDA design.  The default on a Hopper GPU.

Differences from the reference (deliberate, documented):
  * ``boundary`` is OPTIONAL (defaults to [0, 0, S, T]); the reference op
    requires it (README.md:5-6 lists this as a limitation).
  * works on any backend XLA targets (reference is GPU-only).
  * ``px_grad`` for the modified/constrained variants has shape [B,S,T]
    matching ``px`` (the reference always allocates [B,S,T+1],
    tf_fast_rnnt_op.cc:84 — a latent shape bug; only `regular` is tested).
  * composable with ``jax.grad``/``jax.vmap``/``jax.jit``/sharding.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .numerics import NEG_INF, log_linear_scan, logaddexp, reverse_linear_scan, safe_exp

__all__ = [
    "mutual_information_recursion",
    "mutual_information_rows",
    "cummin",
    "monotonic_lower_bound",
]


def _normalize_boundary(
    boundary: Optional[jax.Array], B: int, S: int, T: int
) -> jax.Array:
    """Default boundary is [0, 0, S, T] per batch row (reference
    __init__.py:98-106 documents this; the reference op cannot actually take
    None — we lift that limitation)."""
    if boundary is None:
        row = jnp.array([0, 0, S, T], dtype=jnp.int32)
        return jnp.broadcast_to(row, (B, 4))
    b = boundary.astype(jnp.int32)
    # Clamp to the lattice so out-of-range values (e.g. an exclusive-vs-
    # inclusive t_end off-by-one) behave identically in the XLA and GPU
    # implementations instead of silently diverging (XLA's gather clamps,
    # the kernel reads the score only at an in-range cell).  Opt-in hard
    # validation is available via utils.validation.checkify_rnnt_inputs.
    se = jnp.clip(b[:, 2], 0, S)
    te = jnp.clip(b[:, 3], 0, T)
    sb = jnp.clip(b[:, 0], 0, se)
    tb = jnp.clip(b[:, 1], 0, te)
    return jnp.stack([sb, tb, se, te], axis=1)


def _apply_boundary_mask(
    px: jax.Array, py: jax.Array, boundary: jax.Array, modified: bool
) -> Tuple[jax.Array, jax.Array]:
    """Mask px/py to -inf outside each utterance's [s_begin..s_end] x
    [t_begin..t_end] sub-rectangle.

    This reproduces the reference kernel's behavior of only iterating the DP
    inside the boundary rectangle (and staging -inf for out-of-range entries,
    mutual_information_cuda.cu:282-304): transitions that would leave the
    rectangle get probability zero, and consequently zero occupancy gradient.
    """
    B, S, T1 = px.shape
    T = py.shape[2]
    sb = boundary[:, 0][:, None, None]
    tb = boundary[:, 1][:, None, None]
    se = boundary[:, 2][:, None, None]
    te = boundary[:, 3][:, None, None]

    s_px = jax.lax.broadcasted_iota(jnp.int32, (1, S, T1), 1)
    t_px = jax.lax.broadcasted_iota(jnp.int32, (1, S, T1), 2)
    # px[s, t] moves (s,t) -> (s+1, t) [regular] or (s+1, t+1) [modified].
    t_hi = te if not modified else te - 1
    px_ok = (s_px >= sb) & (s_px < se) & (t_px >= tb) & (t_px <= t_hi)
    px = jnp.where(px_ok, px, NEG_INF)

    s_py = jax.lax.broadcasted_iota(jnp.int32, (1, S + 1, T), 1)
    t_py = jax.lax.broadcasted_iota(jnp.int32, (1, S + 1, T), 2)
    # py[s, t] moves (s,t) -> (s, t+1).
    py_ok = (s_py >= sb) & (s_py <= se) & (t_py >= tb) & (t_py < te)
    py = jnp.where(py_ok, py, NEG_INF)
    return px, py


def _promote_subf32(x: jax.Array) -> jax.Array:
    """Recursion math runs at >= f32 (the bf16 mixed-precision mode only
    narrows the storage; the GPU kernels likewise see float32)."""
    if jnp.issubdtype(x.dtype, jnp.floating) and jnp.finfo(x.dtype).bits < 32:
        return x.astype(jnp.float32)
    return x


def _mask_rows(
    px_rows: jax.Array,
    py_rows: jax.Array,
    boundary: jax.Array,
    modified: bool,
    lo: Optional[jax.Array] = None,
    K: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """s-major boundary (+ optional pruning-band) mask; semantics identical
    to _apply_boundary_mask (+ lattice.band_mask_rows when ``lo`` given)."""
    S, B, T1 = px_rows.shape
    T = py_rows.shape[2]
    sb = boundary[:, 0][None, :, None]
    tb = boundary[:, 1][None, :, None]
    se = boundary[:, 2][None, :, None]
    te = boundary[:, 3][None, :, None]

    s_px = jax.lax.broadcasted_iota(jnp.int32, (S, 1, 1), 0)
    t_px = jax.lax.broadcasted_iota(jnp.int32, (1, 1, T1), 2)
    t_hi = te if not modified else te - 1
    px_ok = (s_px >= sb) & (s_px < se) & (t_px >= tb) & (t_px <= t_hi)

    s_py = jax.lax.broadcasted_iota(jnp.int32, (S + 1, 1, 1), 0)
    t_py = jax.lax.broadcasted_iota(jnp.int32, (1, 1, T), 2)
    py_ok = (s_py >= sb) & (s_py <= se) & (t_py >= tb) & (t_py < te)

    if lo is not None:
        lo = lo.astype(jnp.int32)[None, :, :]  # (1, B, T)
        # regular px's extra t = T column takes the last frame's band
        # (a concatenate, not an edge pad: that slices the sharded batch
        # axis too, which explicit meshes reject)
        lo_px = lo if T1 == T else jnp.concatenate([lo, lo[:, :, -1:]], axis=2)
        px_ok &= (s_px >= lo_px) & (s_px < lo_px + K)
        py_ok &= (s_py >= lo) & (s_py < lo + K)

    px_m = jnp.where(px_ok, px_rows, NEG_INF)
    py_m = jnp.where(py_ok, py_rows, NEG_INF)
    return px_m, py_m


def _forward_rows_xla(
    px_rows: jax.Array,
    py_rows: jax.Array,
    boundary: jax.Array,
    lo: Optional[jax.Array] = None,
    K: int = 0,
    keep_p: bool = True,
) -> Tuple[Optional[jax.Array], jax.Array]:
    """s-major forward: returns (p_rows [S+1, B, T+1], scores [B]), or
    (None, scores) with ``keep_p=False``, which never materializes the
    lattice (no autodiff residual is needed on the primal-only path).

    Row-scan over s; each row solved by a log-semiring associative scan
    (replaces the CUDA forward wavefront, mutual_information_cuda.cu:174-422).
    """
    S, B, T1 = px_rows.shape
    T = py_rows.shape[2]
    modified = T1 == T  # same inference as the kernel (.cu:190-192)

    px_t, py_t = _mask_rows(px_rows, py_rows, boundary, modified, lo, K)
    px_t, py_t = _promote_subf32(px_t), _promote_subf32(py_t)

    # px_pad[s] holds px[s-1] (row s's incoming symbol arcs); row 0 is
    # -inf (no arcs into row 0 from below).
    # full_like (not jnp.full): propagates device-varying type under shard_map
    pad_row = jax.lax.full_like(px_t, NEG_INF, shape=(1, B, T1))
    px_pad = jnp.concatenate([pad_row, px_t], axis=0)  # (S+1, B, T1)

    sb = boundary[:, 0]
    tb = boundary[:, 1]
    t_iota = jax.lax.broadcasted_iota(jnp.int32, (B, T + 1), 1)
    source_t = t_iota == tb[:, None]  # (B, T+1) one-hot column of t_begin

    se = boundary[:, 2]
    end_t = t_iota == boundary[:, 3][:, None]
    s_idx = jnp.arange(S + 1, dtype=jnp.int32)

    def step(carry, xs):
        prev_p, best = carry
        s, px_row, py_row = xs
        if modified:
            # a[t] = p[s-1, t-1] + px[s-1, t-1]
            a = prev_p[:, :T] + px_row  # (B, T)
            a = jnp.pad(a, ((0, 0), (1, 0)), constant_values=NEG_INF)
        else:
            # a[t] = p[s-1, t] + px[s-1, t]
            a = prev_p + px_row  # (B, T+1)
        # Inject the origin cell p[s_begin, t_begin] = 0 (.cu:340-352).
        src = jnp.where((s == sb)[:, None] & source_t, 0.0, NEG_INF).astype(a.dtype)
        b = logaddexp(a, src)
        # coeff[t] = py[s, t-1]; coeff[0] multiplies p[s,-1] = -inf (ignored).
        coeff = jnp.pad(py_row, ((0, 0), (1, 0)), constant_values=NEG_INF)
        p_row = log_linear_scan(coeff, b, axis=-1)
        # harvest the score in the carry (a gather from p_rows would need
        # an explicit out-sharding under batch-sharded explicit meshes)
        val = jnp.max(jnp.where(end_t, p_row, NEG_INF), axis=1)
        best = jnp.where(s == se, val, best)
        return (p_row, best), (p_row if keep_p else None)

    init = (
        jax.lax.full_like(py_t, NEG_INF, shape=(B, T + 1)),
        jax.lax.full_like(py_t, NEG_INF, shape=(B,)),
    )
    (_, scores), p_rows = jax.lax.scan(step, init, (s_idx, px_pad, py_t))
    return p_rows, scores


def _backward_rows_xla(
    px_rows: jax.Array,
    py_rows: jax.Array,
    p_rows: jax.Array,
    boundary: jax.Array,
    ans_grad: jax.Array,
    lo: Optional[jax.Array] = None,
    K: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """s-major occupancy/backward recursion (replaces the CUDA backward
    wavefront, mutual_information_cuda.cu:490-760).

    With the score gradient seeded at (s_end, t_end):

        term1[s,t]  = safe_exp(p[s,t] + px[s,t] - p[s+1, t + dt])   (dt = 0|1)
        term2[s,t]  = safe_exp(p[s,t] + py[s,t] - p[s, t+1])
        g[s,t]      = g[s+1, t+dt] * term1[s,t] + g[s,t+1] * term2[s,t]
        px_grad[s,t] = g[s+1, t+dt] * term1[s,t]
        py_grad[s,t] = g[s, t+1]   * term2[s,t]

    Per row, g is a first-order linear recurrence along decreasing t —
    solved with a reverse associative scan; rows sweep s from S down to 0.
    """
    S, B, T1 = px_rows.shape
    T = py_rows.shape[2]
    modified = T1 == T

    store_dt = px_rows.dtype
    px_t, py_t = _mask_rows(px_rows, py_rows, boundary, modified, lo, K)
    px_t, py_t = _promote_subf32(px_t), _promote_subf32(py_t)
    pad_row = jax.lax.full_like(px_t, NEG_INF, shape=(1, B, T1))
    # px_pad2[s] = px[s] for s < S; -inf for s = S (no arcs out of row S).
    px_pad2 = jnp.concatenate([px_t, pad_row], axis=0)  # (S+1, B, T1)

    p_t = _promote_subf32(p_rows)  # (S+1, B, T+1)
    zeros_row = jax.lax.full_like(p_t, 0.0, shape=(1, B, T + 1))
    p_next_t = jnp.concatenate([p_t[1:], zeros_row], axis=0)  # p[s+1] rows

    se = boundary[:, 2]
    te = boundary[:, 3]
    t_iota = jax.lax.broadcasted_iota(jnp.int32, (B, T + 1), 1)
    seed_t = t_iota == te[:, None]

    s_idx = jnp.arange(S + 1, dtype=jnp.int32)

    def step(g_next, xs):
        s, px_row, py_row, p_cur, p_next = xs
        if modified:
            term1 = safe_exp(p_cur[:, :T] + px_row - p_next[:, 1:])  # (B, T)
            h_px = term1 * g_next[:, 1:]  # px_grad row, width T
            h = jnp.pad(h_px, ((0, 0), (0, 1)))  # (B, T+1)
        else:
            term1 = safe_exp(p_cur + px_row - p_next)  # (B, T+1)
            h_px = term1 * g_next  # px_grad row, width T+1
            h = h_px
        seed = jnp.where((s == se)[:, None] & seed_t, ans_grad[:, None], 0.0)
        b = h + seed.astype(h.dtype)
        term2 = safe_exp(p_cur[:, :T] + py_row - p_cur[:, 1:])  # (B, T)
        coeff = jnp.pad(term2, ((0, 0), (0, 1)))  # (B, T+1); coeff[T] = 0
        g = reverse_linear_scan(coeff, b, axis=-1)
        py_grad_row = term2 * g[:, 1:]
        return g, (h_px, py_grad_row)

    init = jax.lax.full_like(p_t, 0.0, shape=(B, T + 1))
    # Rows sweep s = S down to 0 (reverse scan); ys stay aligned with xs.
    _, (pxg_rows, pyg_rows) = jax.lax.scan(
        step, init, (s_idx, px_pad2, py_t, p_t, p_next_t), reverse=True
    )
    # Trim the s = S px row (identically zero: px_pad2[S] = -inf).
    return pxg_rows[:S].astype(store_dt), pyg_rows.astype(py_rows.dtype)


# -----------------------------------------------------------------------------
# Implementation dispatch.  One rule: the GPU wavefront kernels
# (ops/kernels/mutual_information.cu, impl="cuda") when JAX's default
# device is a CUDA GPU of compute capability 9.x (the kernels are built
# for sm_90a) and the kernels cover the dtype and shape; the XLA
# scan core above otherwise.  impl="xla" forces the scan core; impl="cuda"
# forces the kernels and raises where they cannot run.
# -----------------------------------------------------------------------------

IMPLS = ("xla", "cuda")


def _check_impl(impl: Optional[str]) -> None:
    if impl not in (None, "auto") + IMPLS:
        raise ValueError(
            f"unknown mutual_information_recursion impl {impl!r}; "
            f"expected one of {IMPLS} or None"
        )


def _use_cuda(impl: Optional[str], px_rows: jax.Array, py_rows: jax.Array) -> bool:
    from .kernels import mutual_information as gpu

    if impl == "xla":
        return False
    if impl == "cuda":
        if not gpu.supports(px_rows, py_rows):
            raise TypeError(
                "impl='cuda' covers float32/bfloat16 storage and at most "
                f"{gpu.MAX_ROWS} lattice rows; got {px_rows.dtype} with "
                f"S+1={py_rows.shape[0]} (use impl='xla')"
            )
        return True  # forward/backward_rows_cuda raise without a GPU
    return gpu.cuda_available() and gpu.supports(px_rows, py_rows)


def _float0_like(x):
    return np.zeros(x.shape, dtype=jax.dtypes.float0)


def _f0_or_none(x):
    return None if x is None else _float0_like(x)


# --- s-major dispatch ---------------------------------------------------------
#
# The rows-level entry points below are the single compute path: the public
# (B, S, T)-major API transposes at its edges, and the fused pruned
# pipelines (ops/losses.py) call the rows ops directly with their s-major
# lattices + the pruning band (lo, K), which both implementations mask
# inline.


def _rows_forward(px_rows, py_rows, boundary, lo, K, impl):
    """Returns (p_rows [S+1, B, T+1] float32, scores [B])."""
    if _use_cuda(impl, px_rows, py_rows):
        from .kernels.mutual_information import forward_rows_cuda

        return forward_rows_cuda(px_rows, py_rows, boundary, lo=lo, K=K)
    return _forward_rows_xla(px_rows, py_rows, boundary, lo=lo, K=K)


def _rows_scores_only(px_rows, py_rows, boundary, lo, K, impl):
    if _use_cuda(impl, px_rows, py_rows):
        return _rows_forward(px_rows, py_rows, boundary, lo, K, impl)[1]
    return _forward_rows_xla(
        px_rows, py_rows, boundary, lo=lo, K=K, keep_p=False
    )[1]


def _rows_backward(px_rows, py_rows, p_rows, boundary, ans_grad, lo, K, impl):
    if _use_cuda(impl, px_rows, py_rows):
        from .kernels.mutual_information import backward_rows_cuda

        return backward_rows_cuda(
            px_rows, py_rows, p_rows, boundary, ans_grad, lo=lo, K=K
        )
    return _backward_rows_xla(
        px_rows, py_rows, p_rows, boundary, ans_grad, lo=lo, K=K
    )


# --- scores-only rows op (used when calc_gradients=False) ---------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _mi_rows_scores(px_rows, py_rows, boundary, lo, K, impl):
    return _rows_scores_only(px_rows, py_rows, boundary, lo, K, impl)


def _mi_rows_scores_fwd(px_rows, py_rows, boundary, lo, K, impl):
    # only runs under differentiation: keep the p lattice as the residual
    p_rows, scores = _rows_forward(px_rows, py_rows, boundary, lo, K, impl)
    return scores, (px_rows, py_rows, boundary, lo, p_rows)


def _mi_rows_scores_bwd(K, impl, residuals, ans_grad):
    px_rows, py_rows, boundary, lo, p_rows = residuals
    gx_rows, gy_rows = _rows_backward(
        px_rows, py_rows, p_rows, boundary, ans_grad, lo, K, impl
    )
    return gx_rows, gy_rows, _float0_like(boundary), _f0_or_none(lo)


_mi_rows_scores.defvjp(_mi_rows_scores_fwd, _mi_rows_scores_bwd)


# --- fused scores + occupancy rows op (calc_gradients=True) -------------------


def _rows_with_grads_impl(px_rows, py_rows, boundary, lo, K, impl):
    p_rows, scores = _rows_forward(px_rows, py_rows, boundary, lo, K, impl)
    ones = jnp.ones_like(scores)
    gx_rows, gy_rows = _rows_backward(
        px_rows, py_rows, p_rows, boundary, ones, lo, K, impl
    )
    return scores, gx_rows, gy_rows


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _mi_rows_with_grads(px_rows, py_rows, boundary, lo, K, impl):
    return _rows_with_grads_impl(px_rows, py_rows, boundary, lo, K, impl)


def _mi_rows_with_grads_fwd(px_rows, py_rows, boundary, lo, K, impl):
    out = _rows_with_grads_impl(px_rows, py_rows, boundary, lo, K, impl)
    scores, gx_rows, gy_rows = out
    return out, (gx_rows, gy_rows, boundary, lo)


def _mi_rows_with_grads_bwd(K, impl, res, cots):
    # The occupancy outputs are treated as non-differentiable, exactly like
    # the reference's registered gradient which only propagates the score
    # cotangent: ans_grad * px_grad / py_grad (__init__.py:154-162).  Since
    # the backward recursion is linear in the seed, occupancies computed with
    # a seed of 1 in the forward pass can simply be rescaled here — the same
    # "compute grads in the forward op" trick as tf_fast_rnnt_op.cc:89-111.
    gx_rows, gy_rows, boundary, lo = res
    scale = cots[0][None, :, None]
    return (
        (scale * gx_rows).astype(gx_rows.dtype),
        (scale * gy_rows).astype(gy_rows.dtype),
        _float0_like(boundary),
        _f0_or_none(lo),
    )


_mi_rows_with_grads.defvjp(_mi_rows_with_grads_fwd, _mi_rows_with_grads_bwd)


def mutual_information_rows(
    px_rows: jax.Array,
    py_rows: jax.Array,
    boundary: jax.Array,
    lo: Optional[jax.Array] = None,
    s_range: int = 0,
    calc_gradients: bool = False,
    impl: Optional[str] = None,
):
    """s-major, optionally BAND-MASKED recursion — the fused pipelines'
    internal workhorse (no reference equivalent; the reference materializes
    band effects through do_rnnt_pruning + get_rnnt_logprobs_pruned).

    Args are as :func:`mutual_information_recursion` but with (S, B, T)-
    major px/py rows, plus ``lo``: optional (B, T) int window starts
    (``ranges[:, :, 0]``) with static width ``s_range`` — the recursion
    then sees ``band_mask_rows(px/py)`` without a masked copy ever being
    materialized (both implementations mask inline).
    """
    if lo is not None and int(s_range) <= 0:
        raise ValueError("banded recursion needs a positive static s_range")
    K = int(s_range)
    _check_impl(impl)
    if calc_gradients:
        scores, gx, gy = _mi_rows_with_grads(
            px_rows, py_rows, boundary, lo, K, impl
        )
        return scores, (gx, gy)
    return _mi_rows_scores(px_rows, py_rows, boundary, lo, K, impl)


# --- legacy (B, S, T)-major custom_vjp wrappers -------------------------------


def _mi_scores(px, py, boundary, impl):
    return _mi_rows_scores(
        jnp.moveaxis(px, 1, 0), jnp.moveaxis(py, 1, 0), boundary, None, 0, impl
    )


def _mi_with_grads(px, py, boundary, impl):
    scores, gx_rows, gy_rows = _mi_rows_with_grads(
        jnp.moveaxis(px, 1, 0), jnp.moveaxis(py, 1, 0), boundary, None, 0, impl
    )
    return scores, jnp.moveaxis(gx_rows, 0, 1), jnp.moveaxis(gy_rows, 0, 1)


# --- public API ---------------------------------------------------------------


def occupancy_roundtrip_check(
    px_grad: jax.Array,
    py_grad: jax.Array,
    boundary: jax.Array,
    ans_grad: jax.Array,
) -> jax.Array:
    """Backward self-check: the total occupancy flowing out of the lattice
    origin must equal the seeded score cotangent.

    The backward recursion satisfies, for every cell,
    ``g[s, t] = px_grad[s, t] + py_grad[s, t] + seed[s, t]`` with the seed
    ``ans_grad`` at (s_end, t_end) — so at (s_begin, t_begin) the
    round-trip ``g == ans_grad`` holds exactly when the backward is
    consistent with the forward.  This is the reference kernel's
    always-on debug identity (mutual_information_cuda.cu:510-514,756-758,
    enabled by tf_fast_rnnt_op.cc:110), exposed here as an opt-in.

    Returns the per-utterance absolute error ``|g[sb, tb] - ans_grad|``.
    """
    B, S, _ = px_grad.shape
    T = py_grad.shape[2]
    bidx = jnp.arange(B)
    sb = boundary[:, 0]
    tb = boundary[:, 1]
    at_end = (sb == boundary[:, 2]) & (tb == boundary[:, 3])
    # safe gathers: rows/cols past the array edge contribute 0 (no such arc)
    px_part = jnp.where(
        sb < S, px_grad[bidx, jnp.minimum(sb, S - 1), tb], 0.0
    )
    py_part = jnp.where(
        tb < T, py_grad[bidx, sb, jnp.minimum(tb, T - 1)], 0.0
    )
    g0 = px_part + py_part + jnp.where(at_end, ans_grad, 0.0)
    return jnp.abs(g0 - ans_grad)


def _raise_on_roundtrip_error(err, tol):
    import numpy as _np

    err = _np.asarray(err)
    if _np.any(~(err <= tol)):  # catches NaN too
        raise FloatingPointError(
            "mutual_information_recursion debug_self_check failed: backward "
            f"round-trip error {err.max()} > tol {tol} for utterances "
            f"{_np.nonzero(~(err <= tol))[0].tolist()} — the occupancy "
            "backward is inconsistent with the forward (numerical overflow "
            "or an implementation bug)"
        )


def mutual_information_recursion(
    px: jax.Array,
    py: jax.Array,
    boundary: Optional[jax.Array] = None,
    calc_gradients: bool = False,
    impl: Optional[str] = None,
    debug_self_check: bool = False,
) -> Union[jax.Array, Tuple[jax.Array, Tuple[jax.Array, jax.Array]]]:
    """Mutual-information recursion between pairs of sequences.

    Drop-in equivalent of the reference ``mutual_information_recursion``
    (/root/reference/tf_fast_rnnt/python/tf_fast_rnnt/__init__.py:42-149).

    Args:
      px: [B, S, T+1] (regular) or [B, S, T] (modified/constrained) log-prob
        increments for extending the symbol sequence.
      py: [B, S+1, T] log-prob increments for extending the frame sequence.
      boundary: optional int32 [B, 4] rows of [s_begin, t_begin, s_end, t_end];
        defaults to [0, 0, S, T].  (Optional here — mandatory in the
        reference, whose README lists that as a known limitation.)
      calc_gradients: if True, additionally return the occupancy
        probabilities (px_grad, py_grad) — the gradients of ``scores.sum()``
        w.r.t. (px, py) — computed in the same fused pass and reused by
        autodiff, mirroring tf_fast_rnnt_op.cc:89-111.  NOTE: like the
        reference's registered gradient (__init__.py:154-162), the
        occupancy outputs are NOT differentiable — cotangents flowing into
        them are dropped; only the scores output propagates gradients.
      impl: lattice implementation: "xla" (associative-scan core),
        "cuda" (GPU wavefront kernels; an error without a Hopper GPU), or
        None/"auto" ("cuda" on a Hopper GPU for the dtypes and shapes it covers,
        "xla" otherwise).  f64 inputs run on "xla" (explicitly requesting
        "cuda" with f64 raises); bf16/f16 inputs are treated as narrow
        STORAGE over an f32 in-register recursion by every impl.
      debug_self_check: if True, verify in-graph that the occupancy
        backward round-trips the seeded cotangent through the lattice
        origin (the reference's always-on kernel debug check,
        mutual_information_cuda.cu:510-514) and raise FloatingPointError
        from a host callback on violation.  Costs one extra backward pass
        when calc_gradients=False; for production triage, not hot loops.

    Returns:
      scores [B], or (scores, (px_grad, py_grad)) if calc_gradients.
    """
    B, S, T1 = px.shape
    T = py.shape[2]
    if py.shape != (B, S + 1, T):
        raise ValueError(f"py shape {py.shape} != ({B}, {S + 1}, {T})")
    if T1 not in (T, T + 1):
        raise ValueError(f"px last dim {T1} must be T={T} or T+1={T + 1}")
    boundary = _normalize_boundary(boundary, B, S, T)
    if boundary.shape != (B, 4):
        raise ValueError(f"boundary shape {boundary.shape} != ({B}, 4)")
    _check_impl(impl)
    if calc_gradients or debug_self_check:
        scores, px_grad, py_grad = _mi_with_grads(px, py, boundary, impl)
        if debug_self_check:
            err = occupancy_roundtrip_check(
                px_grad, py_grad, boundary, jnp.ones_like(scores)
            )
            # Tolerance keyed on storage precision: f64+ is tight; fp32
            # occupancies on long lattices accumulate ~1e-3 round-off;
            # bf16/f16 STORAGE (f32 in-register) sees ~1e-3..1e-2 from the
            # narrow round-trips, so gets the loosest bound.
            bits = jnp.finfo(px.dtype).bits
            tol = 1e-8 if bits > 32 else (1e-2 if bits == 32 else 1e-1)
            if isinstance(err, jax.core.Tracer):
                # under jit: raise from a host callback
                jax.debug.callback(_raise_on_roundtrip_error, err, tol)
            else:
                _raise_on_roundtrip_error(np.asarray(err), tol)
        if calc_gradients:
            return scores, (px_grad, py_grad)
        return scores
    return _mi_scores(px, py, boundary, impl)


def cummin(x: jax.Array, axis: int = -1) -> jax.Array:
    """Inclusive running minimum along ``axis``.

    Replacement for the reference's Blelloch-scan CUDA kernel
    (mutual_information_cuda.cu:876-1012 + the ``Cummin`` op,
    tf_fast_rnnt_op.cc:135-165): ``lax.cummin``, one reduce-window op.
    """
    return jax.lax.cummin(x, axis=axis % x.ndim)


def monotonic_lower_bound(x: jax.Array, axis: int = -1) -> jax.Array:
    """Monotone non-decreasing lower bound along ``axis`` (reverse cummin).

    Equivalent to the reference ``_monotonic_lower_bound``
    (rnnt_loss.py:553-585): x_out[i] = min(x[i], x[i+1], ..., x[-1]).

    ``lax.cummin`` (a reduce-window op), not ``lax.associative_scan``: XLA
    for CUDA miscompiles a reverse associative min-scan whose input is
    computed from another one, which the prune-range repair
    (ops/pruning.py:adjust_pruning_lower_bound) chains.
    """
    return jax.lax.cummin(x, axis=axis % x.ndim, reverse=True)
