"""Graph-pair dynamic program: wavefront fill.

Re-derivation of the reference's M/X/Y/W recurrence
(/root/reference/src/GraphAlign.h:201-280) as an anti-diagonal wavefront over
padded predecessor arrays.  All DP arithmetic is float32 (dp_score_t) with
the reference's exact per-candidate operation order, so scores are
bit-identical; cells on one anti-diagonal are independent, which is also the
parallelization axis of the device fills (align/dp_jax.py,
align/graph_dp_pallas.py).

NaN semantics: C++ ``std::max(acc, cand)`` keeps ``acc`` when ``cand`` is
NaN (comparison false).  Accumulators start at -inf, so NaN candidates are
dropped — ``np.fmax`` reproduces this.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG_INF = np.float32(-np.inf)


@dataclass
class DPMatrices:
    M: np.ndarray
    X: np.ndarray
    Y: np.ndarray
    W: np.ndarray
    S: np.ndarray
    Wend: np.float32


def _padded_with_repeat_costs(graph, scores):
    """Padded predecessor arrays with repeat-edge costs materialized
    (cost = repeat_init + repeat_ext*(units-1), float32; Graph.h:236)."""
    idx, cost, isrep, units = graph.padded()
    if not isrep.any():
        # repeat-free graph: the overlay is the identity
        return idx, cost, isrep
    rep_cost = (np.float32(scores.repeat_init)
                + np.float32(scores.repeat_ext)
                * (units - 1).astype(np.float32))
    cost = np.where(isrep, rep_cost, cost).astype(np.float32)
    # units==0 padding on repeat slots must stay inf
    cost = np.where(isrep & (units == 0), np.inf, cost).astype(np.float32)
    return idx, cost, isrep


def fill_dp(g1, g2, S: np.ndarray, scores) -> DPMatrices:
    n1, n2 = g1.size, g2.size
    f32 = np.float32

    idx1, cost1, _ = _padded_with_repeat_costs(g1, scores)
    idx2, cost2, _ = _padded_with_repeat_costs(g2, scores)
    safe1 = np.maximum(idx1, 0)
    safe2 = np.maximum(idx2, 0)

    M = np.full((n1, n2), NEG_INF, dtype=f32)
    X = np.full((n1, n2), NEG_INF, dtype=f32)
    Y = np.full((n1, n2), NEG_INF, dtype=f32)
    W = np.full((n1, n2), NEG_INF, dtype=f32)

    W[0, 0] = scores.start_init

    ge = f32(scores.gap_extend)
    gi = f32(scores.gap_init)
    sg = f32(scores.start_gap)

    # boundary column x = 0 (GraphAlign.h:214-223): sequential in y but we
    # fold it into the wavefront (cell (y,0) lies on diagonal y)
    # boundary row y = 0 (GraphAlign.h:225-234) likewise.

    max_d = (n1 - 2) + (n2 - 2)
    for d in range(1, max_d + 1):
        # -- boundary cells --
        if d <= n1 - 2:
            y = d
            yp = safe1[y]
            cy = cost1[y]
            cand = np.fmax(Y[yp, 0] + ge, W[yp, 0] + sg) - cy
            Y[y, 0] = np.fmax.reduce(cand, initial=NEG_INF)
            W[y, 0] = Y[y, 0]
        if d <= n2 - 2:
            x = d
            xp = safe2[x]
            cx = cost2[x]
            cand = np.fmax(X[0, xp] + ge, W[0, xp] + sg) - cx
            X[0, x] = np.fmax.reduce(cand, initial=NEG_INF)
            W[0, x] = X[0, x]

        # -- interior cells on this anti-diagonal --
        ylo = max(1, d - (n2 - 2))
        yhi = min(n1 - 2, d - 1)
        if ylo > yhi:
            continue
        ys = np.arange(ylo, yhi + 1)
        xs = d - ys

        yp = safe1[ys]            # [k, E1]
        cy = cost1[ys]
        xp = safe2[xs]            # [k, E2]
        cx = cost2[xs]

        Wp = W[yp[:, :, None], xp[:, None, :]]              # [k, E1, E2]
        Sm = ((Wp + S[ys, xs][:, None, None]) - cy[:, :, None]) - cx[:, None, :]

        Xc = X[ys[:, None], xp]                             # [k, E2]
        Wc = W[ys[:, None], xp]
        Sx = np.fmax(Xc + ge, Wc + gi) - cx

        Yc = Y[yp, xs[:, None]]                             # [k, E1]
        Wc2 = W[yp, xs[:, None]]
        Sy = np.fmax(Yc + ge, Wc2 + gi) - cy

        Mv = np.fmax.reduce(Sm.reshape(len(ys), -1), axis=1, initial=NEG_INF)
        Xv = np.fmax.reduce(Sx, axis=1, initial=NEG_INF)
        Yv = np.fmax.reduce(Sy, axis=1, initial=NEG_INF)

        M[ys, xs] = Mv
        X[ys, xs] = Xv
        Y[ys, xs] = Yv
        W[ys, xs] = np.fmax(Mv, np.fmax(Xv, Yv))

    # -- end-node match (GraphAlign.h:262-280) --
    Wend = NEG_INF
    em = f32(scores.end_match)
    eg = f32(scores.end_gap)
    es = f32(scores.end_skip)
    for yp_, cy_, _, _ in g1.pred_items(n1 - 1, scores.repeat_init,
                                        scores.repeat_ext):
        for xp_, cx_, _, _ in g2.pred_items(n2 - 1, scores.repeat_init,
                                            scores.repeat_ext):
            if xp_ == 0 and yp_ == 0:
                Wend = np.fmax(f32(es - cy_ - cx_), Wend)
            else:
                Wend = np.fmax(f32(X[yp_, xp_] + eg - cy_ - cx_), Wend)
                Wend = np.fmax(f32(Y[yp_, xp_] + eg - cy_ - cx_), Wend)
                Wend = np.fmax(f32(M[yp_, xp_] + em - cy_ - cx_), Wend)

    return DPMatrices(M=M, X=X, Y=Y, W=W, S=S, Wend=f32(Wend))
