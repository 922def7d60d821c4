"""Independent numpy oracle for the mutual-information recursion.

Written directly from the recursion definition (the docstring contract of
``mutual_information_recursion``) as an O(B*S*T) explicit double loop —
deliberately sharing no code or structure with fast_rnnt_tpu, so it can act
as a cross-implementation correctness oracle (the role the upstream PyTorch
package plays for the reference, see /root/reference/tf_fast_rnnt/python/
tests/pytorch_simple_rnnt_loss_test.py).
"""

import numpy as np

NEG_INF = -np.inf


def _logadd(a, b):
    if a == NEG_INF and b == NEG_INF:
        return NEG_INF
    m = max(a, b)
    return m + np.log1p(np.exp(-abs(a - b)))


def mi_loop(px, py, boundary=None, ans_grad=None):
    """Forward + occupancy backward via explicit loops.

    Args:
      px: (B, S, T+1) regular or (B, S, T) modified.
      py: (B, S+1, T).
      boundary: (B, 4) ints or None.
      ans_grad: (B,) seed for the backward; defaults to ones.

    Returns:
      scores (B,), px_grad (same shape as px), py_grad (same shape as py),
      p (B, S+1, T+1) with unreachable cells at -inf.
    """
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    B, S, T1 = px.shape
    T = py.shape[2]
    modified = T1 == T
    if boundary is None:
        boundary = np.tile(np.array([0, 0, S, T]), (B, 1))
    boundary = np.asarray(boundary, dtype=np.int64)
    if ans_grad is None:
        ans_grad = np.ones((B,), dtype=np.float64)

    scores = np.zeros((B,))
    px_grad = np.zeros_like(px)
    py_grad = np.zeros_like(py)
    p_out = np.full((B, S + 1, T + 1), NEG_INF)

    for b in range(B):
        sb, tb, se, te = boundary[b]
        p = np.full((S + 2, T + 2), NEG_INF)  # 1-based padding of -inf
        p[sb + 1, tb + 1] = 0.0
        for s in range(sb, se + 1):
            for t in range(tb, te + 1):
                if s == sb and t == tb:
                    continue
                if modified:
                    term_x = (
                        p[s, t] + px[b, s - 1, t - 1]
                        if (s > sb and t > tb)
                        else NEG_INF
                    )
                else:
                    term_x = p[s, t + 1] + px[b, s - 1, t] if s > sb else NEG_INF
                term_y = p[s + 1, t] + py[b, s, t - 1] if t > tb else NEG_INF
                p[s + 1, t + 1] = _logadd(term_x, term_y)
        scores[b] = p[se + 1, te + 1]
        p_out[b] = p[1:, 1:]

        # Backward: occupancy gradients of scores[b] w.r.t. px/py.
        g = np.zeros((S + 1, T + 1))
        g[se, te] = ans_grad[b]
        for s in range(se, sb - 1, -1):
            for t in range(te, tb - 1, -1):
                here = p[s + 1, t + 1]
                if here == NEG_INF:
                    continue
                # contribution to (s+1, t[+1]) via px[s, t]
                if modified:
                    if s < se and t < te:
                        dest = p[s + 2, t + 2]
                        if dest != NEG_INF:
                            w = np.exp(here + px[b, s, t] - dest)
                            px_grad[b, s, t] = w * g[s + 1, t + 1]
                            g[s, t] += px_grad[b, s, t]
                else:
                    if s < se:
                        dest = p[s + 2, t + 1]
                        if dest != NEG_INF and px[b, s, t] != NEG_INF:
                            w = np.exp(here + px[b, s, t] - dest)
                            px_grad[b, s, t] = w * g[s + 1, t]
                            g[s, t] += px_grad[b, s, t]
                # contribution to (s, t+1) via py[s, t]
                if t < te:
                    dest = p[s + 1, t + 2]
                    if dest != NEG_INF and py[b, s, t] != NEG_INF:
                        w = np.exp(here + py[b, s, t] - dest)
                        py_grad[b, s, t] = w * g[s, t + 1]
                        g[s, t] += py_grad[b, s, t]

    return scores, px_grad, py_grad, p_out


# --- lattice construction (float64, explicit, no shared code) ------------------

_TINY32 = float(np.finfo(np.float32).tiny)


def _lse(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    return np.squeeze(m, axis) + np.log(np.sum(np.exp(x - m), axis=axis))


def _symbol_terms(lm, am, symbols):
    """px_am[b, s, t] = am[b, t, symbols[b, s]]; px_lm[b, s] = lm[b, s, sym]."""
    B, S = symbols.shape
    bi = np.arange(B)[:, None]
    px_am = am[bi, :, symbols]  # [B, S, T]: advanced indices come first
    px_lm = lm[bi, np.arange(S)[None, :], symbols]  # [B, S]
    return px_am, px_lm


def _finish(px, py, rnnt_type, boundary):
    B, S, T = px.shape
    if rnnt_type == "regular":
        px = np.concatenate([px, np.full((B, S, 1), -np.inf)], axis=2)
        if boundary is not None:
            for b in range(B):
                px[b, :, boundary[b, 3]] = -np.inf
    elif rnnt_type == "constrained":
        px = px + py[:, 1:, :]
    return px, py


def lattice_simple(lm, am, symbols, blank, rnnt_type="regular", boundary=None):
    """(px, py) of the simple (additive) joiner, straight from the
    definition: log-softmax over C of lm[b, s] + am[b, t], read at the
    symbol (px) and at the blank (py).  Returns float64 [B, S, T(+1)] and
    [B, S+1, T]."""
    lm = np.asarray(lm, np.float64)
    am = np.asarray(am, np.float64)
    symbols = np.asarray(symbols)
    N = _lse(lm[:, :, None, :] + am[:, None, :, :], axis=3)  # [B, S+1, T]
    px_am, px_lm = _symbol_terms(lm, am, symbols)
    S = symbols.shape[1]
    px = px_am + px_lm[:, :, None] - N[:, :S, :]
    py = am[:, None, :, blank] + lm[:, :, None, blank] - N
    bnd = None if boundary is None else np.asarray(boundary)
    return _finish(px, py, rnnt_type, bnd)


def lattice_smoothed(lm, am, symbols, blank, lm_only_scale, am_only_scale,
                     rnnt_type="regular", boundary=None):
    """Smoothed lattice (reference rnnt_loss.py:1132-1367): the joint
    lattice interpolated with an lm-only lattice and an am-only lattice
    whose language model is the unigram mean of the normalized lm."""
    lm = np.asarray(lm, np.float64)
    am = np.asarray(am, np.float64)
    symbols = np.asarray(symbols)
    S = symbols.shape[1]
    N = _lse(lm[:, :, None, :] + am[:, None, :, :], axis=3)  # [B, S+1, T]
    lm_norm = np.exp(lm - _lse(lm, axis=2)[:, :, None])
    unigram = lm_norm.mean(axis=(0, 1)) + _TINY32  # [C]
    amonly_N = np.log(np.exp(am) @ unigram)  # [B, T]
    lmonly_N = _lse(lm, axis=2)  # [B, S+1]
    log_uni = np.log(unigram)
    px_am, px_lm = _symbol_terms(lm, am, symbols)
    px_uni = log_uni[symbols]  # [B, S]

    px = px_am + px_lm[:, :, None] - N[:, :S, :]
    px_amonly = px_am + px_uni[:, :, None] - amonly_N[:, None, :]
    px_lmonly = np.broadcast_to((px_lm - lmonly_N[:, :S])[:, :, None], px.shape)
    py = am[:, None, :, blank] + lm[:, :, None, blank] - N
    py_amonly = np.broadcast_to(
        (am[:, :, blank] + log_uni[blank] - amonly_N)[:, None, :], py.shape
    )
    py_lmonly = np.broadcast_to(
        (lm[:, :, blank] - lmonly_N)[:, :, None], py.shape
    )

    comb = 1.0 - lm_only_scale - am_only_scale
    comb = comb if comb != 0.0 else 1e-20
    a = lm_only_scale if lm_only_scale != 0.0 else 1e-20
    c = am_only_scale if am_only_scale != 0.0 else 1e-20
    px_i = px * comb + px_lmonly * a + px_amonly * c
    py_i = py * comb + py_lmonly * a + py_amonly * c
    bnd = None if boundary is None else np.asarray(boundary)
    return _finish(px_i, py_i, rnnt_type, bnd)


def numeric_vjp(build, lm, am, gpx, gpy, eps=1e-6):
    """Central-difference gradient of sum(gpx * px) + sum(gpy * py) (finite
    entries only) w.r.t. lm and am, in float64."""
    lm = np.array(lm, np.float64)
    am = np.array(am, np.float64)

    def f(lm_, am_):
        px, py = build(lm_, am_)
        return (np.sum(np.where(np.isfinite(px), gpx * px, 0.0))
                + np.sum(np.where(np.isfinite(py), gpy * py, 0.0)))

    grads = []
    for x in (lm, am):
        g = np.zeros_like(x)
        for i in np.ndindex(x.shape):
            old = x[i]
            x[i] = old + eps
            hi = f(lm, am)
            x[i] = old - eps
            lo = f(lm, am)
            x[i] = old
            g[i] = (hi - lo) / (2 * eps)
        grads.append(g)
    return grads
