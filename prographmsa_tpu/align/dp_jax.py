"""Device graph-pair DP fill, one pair per call (``--engine device``).

Device formulation of the M/X/Y/W recurrence (align/dp.py): one
``lax.scan`` over anti-diagonals where the sequence-graph predecessor
structure is re-expressed as *offset buckets*:

    C1[y, i] = min cost of an edge y -> y-o1[i]   (+inf if absent)

so the per-cell predecessor max becomes, per (offset_i, offset_j) pair, a
dynamic-slice of a previous diagonal plus a shift — no gathers inside the
scan body (offsets are traced scalars so one compilation serves every
graph pair in a shape bucket).

Matrices are carried in diagonal coordinates Buf[d, y] (value of cell
(y, x=d-y)); the S-matrix is one device GEMM.  Scores are float32 like the
reference's dp_score_t; candidate op order matches align/dp.py so results
agree except for device-vs-host GEMM rounding in S (the parity test suite uses
the host path; this path feeds the bench/scale pipeline).

Cross-reference: /root/reference/src/GraphAlign.h:201-280.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from .dp import DPMatrices, NEG_INF
from .scores import precompute_scores

F32_INF = np.float32(np.inf)


def _offset_costs(graph, scores, max_offsets: int):
    """Per-node offset-bucket cost matrix C[n, O] (float32, +inf pad).
    Returns (offsets int32 [O], C [n, O]) or None if too many offsets."""
    n = graph.size
    offsets = set()
    for i in range(n):
        for p, _ in graph.preds[i]:
            offsets.add(i - p)
        for p, _ in graph.reps[i]:
            offsets.add(i - p)
    offsets = sorted(offsets)
    if len(offsets) > max_offsets:
        return None
    omap = {o: k for k, o in enumerate(offsets)}
    C = np.full((n, max(1, len(offsets))), np.inf, dtype=np.float32)
    ri = np.float32(scores.repeat_init)
    re = np.float32(scores.repeat_ext)
    for i in range(n):
        for p, c in graph.preds[i]:
            k = omap[i - p]
            C[i, k] = min(C[i, k], np.float32(c))
        for p, u in graph.reps[i]:
            k = omap[i - p]
            rc = np.float32(ri + re * np.float32(u - 1))
            C[i, k] = min(C[i, k], rc)
    return np.array(offsets, dtype=np.int32), C


def _bucket(x: int, q: int = 64) -> int:
    return ((x + q - 1) // q) * q


@functools.lru_cache(maxsize=64)
def _make_fill(n1p: int, n2p: int, o1p: int, o2p: int):
    import jax
    import jax.numpy as jnp

    D = n1p + n2p
    NEG = jnp.float32(-jnp.inf)

    def fill(S, C1, C2diag, o1, o2, params, n1, n2):
        """S [n1p, n2p] f32; C1 [n1p, o1p]; C2diag [D, n1p, o2p];
        o1 [o1p] int32; o2 [o2p] int32; params: dict of f32 scalars;
        n1, n2: actual sizes (traced)."""
        ge, gi, sg, start_init = (params["gap_extend"], params["gap_init"],
                                  params["start_gap"], params["start_init"])

        ys = jnp.arange(n1p)
        # diag coords for S: computed as one gather outside the scan
        dgrid = jnp.arange(D)[:, None]
        xgrid = dgrid - ys[None, :]
        Sall = S[jnp.broadcast_to(ys[None, :], (D, n1p)),
                 jnp.clip(xgrid, 0, n2p - 1)]
        Sall = jnp.where((xgrid >= 0) & (xgrid < n2p), Sall, NEG)  # [D, n1p]

        pad = n1p  # max shift
        zpad = jnp.full((pad,), NEG)

        def shifted(v, o):
            """value at row y of v[y-o] (rows < o -> -inf)."""
            return jax.lax.dynamic_slice(jnp.concatenate([zpad, v]),
                                         (pad - o,), (n1p,))

        def step(carry, inp):
            d, Sd, C2d = inp
            BufM, BufX, BufY, BufW = carry

            def at(buf, dd):
                # diagonal dd (clamped; dd<0 only yields -inf rows anyway)
                return jax.lax.dynamic_slice(
                    buf, (jnp.clip(dd, 0, D), 0), (1, n1p))[0]

            xs = d - ys                                    # [n1p]

            Sm = jnp.full((n1p,), NEG)
            Sy = jnp.full((n1p,), NEG)
            SyB = jnp.full((n1p,), NEG)
            for i in range(o1p):
                wi_y = at(BufW, d - o1[i])
                yi_y = at(BufY, d - o1[i])
                w_sh = shifted(wi_y, o1[i])
                y_sh = shifted(yi_y, o1[i])
                ci = C1[:, i]
                Sy = jnp.fmax(Sy, jnp.fmax(y_sh + ge, w_sh + gi) - ci)
                SyB = jnp.fmax(SyB, jnp.fmax(y_sh + ge, w_sh + sg) - ci)
                for j in range(o2p):
                    wij = at(BufW, d - o1[i] - o2[j])
                    w2_sh = shifted(wij, o1[i])
                    cand = ((w2_sh + Sd) - ci) - C2d[:, j]
                    Sm = jnp.fmax(Sm, cand)

            Sx = jnp.full((n1p,), NEG)
            SxB = jnp.full((n1p,), NEG)
            for j in range(o2p):
                xj = at(BufX, d - o2[j])
                wj = at(BufW, d - o2[j])
                cj = C2d[:, j]
                Sx = jnp.fmax(Sx, jnp.fmax(xj + ge, wj + gi) - cj)
                SxB = jnp.fmax(SxB, jnp.fmax(xj + ge, wj + sg) - cj)

            interior = (ys >= 1) & (ys <= n1 - 2) & (xs >= 1) & (xs <= n2 - 2)
            b_x0 = (xs == 0) & (ys >= 1) & (ys <= n1 - 2)
            b_y0 = (ys == 0) & (xs >= 1) & (xs <= n2 - 2)

            Mrow = jnp.where(interior, Sm, NEG)
            Xrow = jnp.where(interior, Sx, jnp.where(b_y0, SxB, NEG))
            Yrow = jnp.where(interior, Sy, jnp.where(b_x0, SyB, NEG))
            Wrow = jnp.where(interior,
                             jnp.fmax(Mrow, jnp.fmax(Xrow, Yrow)),
                             jnp.where(b_x0, SyB, jnp.where(b_y0, SxB, NEG)))

            BufM = jax.lax.dynamic_update_slice(BufM, Mrow[None, :], (d, 0))
            BufX = jax.lax.dynamic_update_slice(BufX, Xrow[None, :], (d, 0))
            BufY = jax.lax.dynamic_update_slice(BufY, Yrow[None, :], (d, 0))
            BufW = jax.lax.dynamic_update_slice(BufW, Wrow[None, :], (d, 0))
            return (BufM, BufX, BufY, BufW), None

        buf0 = jnp.full((D + 1, n1p), NEG)
        BufW0 = buf0.at[0, 0].set(start_init)
        ds = jnp.arange(1, D)
        (BufM, BufX, BufY, BufW), _ = jax.lax.scan(
            step, (buf0, buf0, buf0, BufW0),
            (ds, Sall[1:D], C2diag[1:D]))
        return BufM, BufX, BufY, BufW

    return jax.jit(fill, static_argnames=())


def fill_dp_device(g1, g2, S_host, scores, max_offsets: int = 16):
    """Device DP fill; returns DPMatrices (same layout as fill_dp) or None
    if the graphs' offset structure exceeds the bucket limit."""
    import jax.numpy as jnp

    oc1 = _offset_costs(g1, scores, max_offsets)
    oc2 = _offset_costs(g2, scores, max_offsets)
    if oc1 is None or oc2 is None:
        return None
    o1, C1 = oc1
    o2, C2 = oc2
    n1, n2 = g1.size, g2.size
    n1p, n2p = _bucket(n1), _bucket(n2)
    o1p, o2p = _bucket(len(o1), 4), _bucket(len(o2), 4)
    D = n1p + n2p

    Sp = np.full((n1p, n2p), -np.inf, dtype=np.float32)
    Sp[:n1, :n2] = S_host
    C1p = np.full((n1p, o1p), np.inf, dtype=np.float32)
    C1p[:n1, :C1.shape[1]] = C1
    C2p = np.full((n2p, o2p), np.inf, dtype=np.float32)
    C2p[:n2, :C2.shape[1]] = C2
    o1pad = np.concatenate([o1, np.ones(o1p - len(o1), np.int32)])
    o2pad = np.concatenate([o2, np.ones(o2p - len(o2), np.int32)])

    # C2diag[d, y, j] = C2[d-y, j] (inf out of range)
    ys = np.arange(n1p)
    xg = np.arange(D)[:, None] - ys[None, :]
    C2diag = np.where(((xg >= 0) & (xg < n2p))[:, :, None],
                      C2p[np.clip(xg, 0, n2p - 1)], np.inf
                      ).astype(np.float32)

    params = {k: jnp.float32(getattr(scores, k))
              for k in ("gap_extend", "gap_init", "start_gap", "start_init")}

    fill = _make_fill(n1p, n2p, o1p, o2p)
    BufM, BufX, BufY, BufW = fill(jnp.asarray(Sp), jnp.asarray(C1p),
                                  jnp.asarray(C2diag), jnp.asarray(o1pad),
                                  jnp.asarray(o2pad), params, n1, n2)

    M = _diag_to_matrix(np.asarray(BufM), n1, n2)
    X = _diag_to_matrix(np.asarray(BufX), n1, n2)
    Y = _diag_to_matrix(np.asarray(BufY), n1, n2)
    W = _diag_to_matrix(np.asarray(BufW), n1, n2)
    W[0, 0] = np.float32(scores.start_init)

    # end-state Wend on host (GraphAlign.h:262-280)
    Wend = _end_state(g1, g2, M, X, Y, scores)
    return DPMatrices(M=M, X=X, Y=Y, W=W, S=np.asarray(S_host), Wend=Wend)


def _diag_to_matrix(buf: np.ndarray, n1: int, n2: int) -> np.ndarray:
    out = np.full((n1, n2), NEG_INF, dtype=np.float32)
    ys = np.arange(n1)
    for d in range(0, n1 + n2 - 1):
        xs = d - ys
        ok = (xs >= 0) & (xs < n2)
        out[ys[ok], xs[ok]] = buf[d][ys[ok]]
    return out


def _end_state(g1, g2, M, X, Y, scores):
    f32 = np.float32
    n1, n2 = g1.size, g2.size
    Wend = NEG_INF
    em, eg, es = (f32(scores.end_match), f32(scores.end_gap),
                  f32(scores.end_skip))
    for yp, cy, _, _ in g1.pred_items(n1 - 1, scores.repeat_init,
                                      scores.repeat_ext):
        for xp, cx, _, _ in g2.pred_items(n2 - 1, scores.repeat_init,
                                          scores.repeat_ext):
            if xp == 0 and yp == 0:
                Wend = np.fmax(f32(es - cy - cx), Wend)
            else:
                Wend = np.fmax(f32(X[yp, xp] + eg - cy - cx), Wend)
                Wend = np.fmax(f32(Y[yp, xp] + eg - cy - cx), Wend)
                Wend = np.fmax(f32(M[yp, xp] + em - cy - cx), Wend)
    return f32(Wend)
