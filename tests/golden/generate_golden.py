"""Generate golden test vectors by BRUTE-FORCE PATH ENUMERATION (float64).

Independence argument
---------------------
Every other oracle in this repo (numpy loop, C++ csrc, XLA scan, GPU
kernels) evaluates the same dynamic-programming recursion

    p[s, t] = logaddexp(p[s-1, t] + px[s-1, t], p[s, t-1] + py[s, t-1])

so a shared misunderstanding of the recursion would pass all cross-checks.
This generator never runs that recursion.  It uses only the *definition*
the recursion is derived from (reference derivation:
/root/reference/tf_fast_rnnt/csrc/mutual_information_cuda.cu:441-487 and
the docstring of mutual_information_recursion, reference
__init__.py:115-133):

    score[b]  = log  SUM over monotone lattice paths  exp( SUM arc scores )

where a path walks from (s_begin, t_begin) to (s_end, t_end) taking
"up" steps (s, t) -> (s+1, t) with score px[b, s, t] and "right" steps
(s, t) -> (s, t+1) with score py[b, s, t] ("regular" topology), or
diagonal "up" steps (s, t) -> (s+1, t+1) with score px[b, s, t]
("modified" topology).  Each path is enumerated explicitly (the shapes
are chosen so there are only a few thousand), and

    px_grad[b, s, t] = posterior probability that a path uses that arc
                     = d score / d px[b, s, t]     (same for py_grad)

accumulated arc-by-arc from the enumerated path posteriors.

The (px, py) lattices themselves are likewise built from first principles
in float64: normalizer[b,s,t] = log sum_c exp(lm[b,s,c] + am[b,t,c]) by
direct summation — no max-shift trick, no matmul (exact at these scales
in f64).  Reference semantics: rnnt_loss.py:63-223 (get_rnnt_logprobs).

Inputs use the BASELINE config #1 shape (B=2, T=10, S=5, C=20) with a
fixed seed, one full and one ragged boundary set.

Run:  python tests/golden/generate_golden.py   (rewrites golden .npz files)
"""

import itertools
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NEG_INF = -np.inf


def build_lattice_f64(lm, am, symbols, blank, rnnt_type, boundary):
    """(px, py) from the definition, float64, no stability tricks."""
    B, T, C = am.shape
    S = lm.shape[1] - 1
    # normalizer[b, s, t] = log sum_c exp(lm[b,s,c] + am[b,t,c])
    joint = lm[:, :, None, :] + am[:, None, :, :]  # [B, S+1, T, C]
    normalizer = np.log(np.exp(joint).sum(axis=3))  # [B, S+1, T]

    px = np.empty((B, S, T + 1 if rnnt_type == "regular" else T))
    py = np.empty((B, S + 1, T))
    for b in range(B):
        for s in range(S):
            sym = symbols[b, s]
            for t in range(T):
                px[b, s, t] = lm[b, s, sym] + am[b, t, sym] - normalizer[b, s, t]
        if rnnt_type == "regular":
            px[b, :, T] = NEG_INF
            te = boundary[b, 3]
            px[b, :, te] = NEG_INF  # fix_for_boundary (rnnt_loss.py:29-61)
        for s in range(S + 1):
            for t in range(T):
                py[b, s, t] = (
                    lm[b, s, blank] + am[b, t, blank] - normalizer[b, s, t]
                )
    return px, py


def enumerate_paths(px, py, boundary, rnnt_type):
    """scores + occupancy grads by explicit path enumeration (log-domain
    via f64 exp of shifted scores; shapes keep path counts in the 1000s)."""
    B, S_rows, T1 = px.shape
    T = py.shape[2]
    scores = np.empty(B)
    px_grad = np.zeros_like(px)
    py_grad = np.zeros_like(py)
    for b in range(B):
        sb, tb, se, te = boundary[b]
        n_up, n_right = se - sb, te - tb
        path_scores = []
        path_arcs = []
        # a path = choice of which of the (n_up + n_right) steps are "up"
        # (modified: an "up" step also consumes a frame, so the walk has
        # n_right - n_up plain right steps plus n_up diagonal steps)
        if rnnt_type == "regular":
            steps_total = n_up + n_right
            for up_positions in itertools.combinations(range(steps_total), n_up):
                s, t = sb, tb
                tot, arcs = 0.0, []
                ups = set(up_positions)
                for i in range(steps_total):
                    if i in ups:
                        tot += px[b, s, t]
                        arcs.append(("x", s, t))
                        s += 1
                    else:
                        tot += py[b, s, t]
                        arcs.append(("y", s, t))
                        t += 1
                assert (s, t) == (se, te)
                path_scores.append(tot)
                path_arcs.append(arcs)
        else:  # modified/constrained topology: up = diagonal
            steps_total = n_right  # every step consumes a frame
            if n_up > n_right:
                path_scores = [NEG_INF]
                path_arcs = [[]]
            else:
                for up_positions in itertools.combinations(
                    range(steps_total), n_up
                ):
                    s, t = sb, tb
                    tot, arcs = 0.0, []
                    ups = set(up_positions)
                    for i in range(steps_total):
                        if i in ups:
                            tot += px[b, s, t]
                            arcs.append(("x", s, t))
                            s += 1
                            t += 1
                        else:
                            tot += py[b, s, t]
                            arcs.append(("y", s, t))
                            t += 1
                    assert (s, t) == (se, te)
                    path_scores.append(tot)
                    path_arcs.append(arcs)
        path_scores = np.array(path_scores)
        m = np.max(path_scores)
        if not np.isfinite(m):
            scores[b] = NEG_INF
            continue
        w = np.exp(path_scores - m)
        Z = w.sum()
        scores[b] = m + np.log(Z)
        post = w / Z
        for p_i, arcs in enumerate(path_arcs):
            for kind, s, t in arcs:
                if kind == "x":
                    px_grad[b, s, t] += post[p_i]
                else:
                    py_grad[b, s, t] += post[p_i]
    return scores, px_grad, py_grad


def enumerate_paths_banded(px, py, boundary, lo, K):
    """Path enumeration restricted to the pruning band: every arc at
    column t must satisfy lo[t] <= s < lo[t] + K (the band_mask_rows /
    in-kernel band semantics — px uses an edge-extended lo for its t = T
    column).  Regular topology only."""
    pxb = px.copy()
    pyb = py.copy()
    B, S_rows, T1 = px.shape
    T = py.shape[2]
    lo_ext = np.concatenate([lo, lo[:, -1:]], axis=1)  # edge pad to T+1
    for b in range(B):
        for s in range(S_rows):
            for t in range(T1):
                if not (lo_ext[b, t] <= s < lo_ext[b, t] + K):
                    pxb[b, s, t] = NEG_INF
        for s in range(S_rows + 1):
            for t in range(T):
                if not (lo[b, t] <= s < lo[b, t] + K):
                    pyb[b, s, t] = NEG_INF
    return enumerate_paths(pxb, pyb, boundary, "regular")


def main():
    rng = np.random.default_rng(20260817)
    B, T, S, C = 2, 10, 5, 20
    blank = 0
    lm = rng.normal(size=(B, S + 1, C))
    am = rng.normal(size=(B, T, C))
    symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
    boundaries = {
        "full": np.tile(np.array([0, 0, S, T], np.int32), (B, 1)),
        "ragged": np.array([[0, 0, S, T], [0, 0, S - 2, T - 3]], np.int32),
    }
    for rnnt_type in ("regular", "modified"):
        for bname, boundary in boundaries.items():
            px, py = build_lattice_f64(lm, am, symbols, blank, rnnt_type, boundary)
            scores, gx, gy = enumerate_paths(px, py, boundary, rnnt_type)
            out = os.path.join(HERE, f"config1_{rnnt_type}_{bname}.npz")
            np.savez(
                out,
                lm=lm, am=am, symbols=symbols, boundary=boundary,
                blank=np.int32(blank),
                px=px, py=py, scores=scores,
                px_grad=gx, py_grad=gy,
            )
            print(f"{out}: scores={scores}")

    # band-restricted case: the pruning-band semantics from first
    # principles (a valid monotone lo with steps < K)
    boundary = boundaries["ragged"]
    px, py = build_lattice_f64(lm, am, symbols, blank, "regular", boundary)
    K = 3
    lo = np.zeros((B, T), np.int32)
    steps = rng.integers(0, K, size=(B, T))
    steps[:, 0] = 0
    lo = np.minimum(np.cumsum(steps, axis=1), S - K + 1).astype(np.int32)
    scores, gx, gy = enumerate_paths_banded(px, py, boundary, lo, K)
    out = os.path.join(HERE, "config1_banded_K3.npz")
    np.savez(out, lm=lm, am=am, symbols=symbols, boundary=boundary,
             blank=np.int32(blank), px=px, py=py, lo=lo, K=np.int32(K),
             scores=scores, px_grad=gx, py_grad=gy)
    print(f"{out}: scores={scores}")


if __name__ == "__main__":
    main()
