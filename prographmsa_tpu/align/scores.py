"""DP score parameters and the match-score matrix.

Re-derivation of /root/reference/src/GraphAlign.h:46-163:

* ``DynProgScores``: PIP-style indel-model parameters derived from branch
  lengths; computed in float64, stored as float32 (dp_score_t), logs base 2
  (the reference's USE_LS_LOG default).
* ``precompute_scores``: the log-odds match matrix
  ``S = lslog( (g1ᵀ·(Mᵀ·g2)) / ((g1ᵀ·pi)(piᵀ·g2)) ) + match_init``
  — one GEMM per graph pair (GraphAlign.h:146-163).
* ``ls_log_add``: bitwise reproduction of the reference's SSE2 fast-log2
  (ls_log.h:22-59), including the different rounding order between the
  4-wide vector body and the scalar tail, so S matches the binary bitwise.
"""

from __future__ import annotations

import math

import numpy as np

# fast-log2 rational-approximation constants (ls_log.h:10-13)
_LS_A = np.float32(2.44247459618085927548717403238913328776812604856114)
_LS_B = np.float32(-4.2040783745848554315883301529007786406310628696383)
_LS_C = np.float32(-0.72123729809042963774358701619456664388406302428057)


def ls_log_add(data: np.ndarray, add: np.float32) -> np.ndarray:
    """Elementwise ``ls_log(x) + add`` on float32, bitwise-identical to the
    reference's SSE path for all 4-aligned elements and to the scalar
    ``ls_log`` tail for the remainder (ls_log.h:22-59).

    ``data`` is flattened in storage order (the caller passes column-major
    for Eigen parity)."""
    x = np.ascontiguousarray(data, dtype=np.float32).ravel()
    n = x.size
    alen = n & ~3

    bits = x.view(np.uint32)
    e = (bits >> np.uint32(23)).astype(np.int32) - np.int32(126)
    ef = e.astype(np.float32)
    mant_bits = ((bits << np.uint32(9)) >> np.uint32(9)) ^ np.uint32(0x3F000000)
    d = mant_bits.view(np.float32)

    out = np.empty_like(x)
    # SSE body: ((b/(d-c)) + add) + (e + a)
    vd = _LS_B / (d[:alen] - _LS_C)
    ve = ef[:alen] + _LS_A
    out[:alen] = (vd + np.float32(add)) + ve
    # scalar tail: ((a + b/(d-c)) + e) + add     (ls_log.h:8-19,56-58)
    if alen < n:
        t = (_LS_A + _LS_B / (d[alen:] - _LS_C)) + ef[alen:]
        out[alen:] = t + np.float32(add)
    return out.reshape(np.shape(data))


def lslog_scalar(x: float) -> float:
    """double-precision scalar ls_log (ls_log.h:7-19); used where the
    reference applies LOG() to doubles."""
    d, e = math.frexp(x)
    a = 2.44247459618085927548717403238913328776812604856114
    b = -4.2040783745848554315883301529007786406310628696383
    c = -0.72123729809042963774358701619456664388406302428057
    return a + b / (d - c) + e


def LOG(x: float) -> float:
    """The reference's LOG macro under USE_LS_LOG: log(x)/log(2) in double
    (GraphAlign.h:46-50).  (The fast approximation is only used for the
    S-matrix via ls_log_add.)"""
    return math.log(x) / math.log(2.0)


def average_alignment_length(graph, engine: str = "auto") -> float:
    """Average free-edge path length from start to each node, evaluated at
    the end node (GraphAlign.h:57-96)."""
    if engine in ("auto", "native", "pallas"):
        from .. import native
        res = native.average_alignment_length_native(graph)
        if res is not None:
            return res
    n = graph.size
    if n == 0:
        return 0.0
    cache = np.full(n, -1.0)
    cache[0] = 0.0

    import sys
    sys.setrecursionlimit(max(10000, 10 * n))

    def rec(cur: int) -> float:
        if cache[cur] == -1.0:
            total = 0.0
            paths = 0
            for p, c, is_rep, _ in graph.pred_items(cur, np.inf, np.inf):
                if c == np.float32(0.0):
                    res = rec(p)
                    if res >= 0.0:
                        total += res + 1.0
                        paths += 1
            cache[cur] = total / paths if paths > 0 else -2.0
        return cache[cur]

    return rec(n - 1)


class DynProgScores:
    """GraphAlign.h:99-143."""

    def __init__(self, g1, g2, model, options):
        engine = getattr(options, "engine", "auto")
        l1 = average_alignment_length(g1, engine)
        l2 = average_alignment_length(g2, engine)
        eps = model.epsilon
        exp_length = max(l1, l2) * math.exp(
            model.distance * options.indel_rate * (eps / (1.0 - eps) + 1.0))
        nu = 2.0 / (2.0 + l1 + l2)

        ttau = 1.0 / (1.0 + exp_length)
        if eps + ttau >= 1.0:
            ttau = (1.0 - eps) / 2.0
        tau = ttau

        f32 = np.float32
        self.gap_init = f32(LOG(model.delta * (1.0 - eps - tau) / (1.0 - nu)))
        self.gap_extend = f32(LOG(eps / (1.0 - nu)))
        self.match_init = f32(LOG((1.0 - 2.0 * model.delta) * (1.0 - tau)
                                  / (1.0 - nu) / (1.0 - nu)))
        self.end_skip = f32(LOG(tau))
        ei = options.end_indel_prob
        if 0 <= ei <= 1:
            self.end_match = f32(LOG(tau * (1.0 - ei) / (1.0 - 2.0 * model.delta)
                                     / (1.0 - tau)))
            self.end_gap = f32(LOG(tau * ei / 2.0 / (1.0 - eps - tau)
                                   / model.delta))
            self.start_gap = f32(LOG(ei / 2.0 * (1.0 - eps - tau)
                                     / (1.0 - ei) / (1.0 - nu)))
            self.start_init = f32(LOG((1.0 - tau) * (1.0 - ei)))
        else:
            self.end_match = f32(LOG(tau / (1.0 - tau)))
            self.end_gap = f32(LOG(tau / (1.0 - eps - tau)))
            self.start_gap = f32(LOG(model.delta * (1.0 - eps - tau)
                                     / (1.0 - nu)))
            self.start_init = f32(LOG(1.0 - tau))

        repeat_prob = 1.0 - math.exp(-model.distance * options.repeat_rate)
        self.repeat_init = f32(-LOG(min(
            1.0, repeat_prob / (1 - repeat_prob) * (1 - options.repeatext_prob))))
        self.repeat_ext = f32(-LOG(min(
            1.0, max(0.0, options.repeatext_prob))))


def _eigen_dot_f32(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Row-wise float32 dot products with Eigen/SSE rounding: one 4-lane
    packet accumulator over k, predux = (l0+l2)+(l1+l3), scalar tail."""
    n, dim = A.shape
    k4 = dim & ~3
    acc = np.zeros((n, 4), dtype=np.float32)
    for k in range(0, k4, 4):
        acc = (acc + A[:, k:k + 4] * y[k:k + 4][None, :]).astype(np.float32)
    res = ((acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])).astype(np.float32)
    for k in range(k4, dim):
        res = (res + A[:, k] * y[k]).astype(np.float32)
    return res


def precompute_scores(g1, g2, model, scores,
                      engine: str = "auto") -> np.ndarray:
    """Match-score matrix S [n1, n2] float32 (GraphAlign.h:146-163).

    Matmuls run in float32 like the reference's Eigen float GEMMs; the
    fast-log runs over the matrix in column-major order (Eigen storage) so
    the vector/tail split falls on the same elements.  The native C++
    kernel (graphcore.cpp gc_precompute_scores) replays the identical op
    order (tests/test_native.py)."""
    if engine in ("auto", "native", "pallas"):
        from .. import native
        S = native.precompute_scores_native(g1, g2, model, scores.match_init)
        if S is not None:
            return S
    g1s = g1.sites.astype(np.float32)          # [n1, DIM]
    g2s = g2.sites.astype(np.float32)          # [n2, DIM]
    M = model.M.astype(np.float32)
    pi = model.pi.astype(np.float32)

    # Eigen gebp accumulates each output element sequentially over k; the
    # d-loop below reproduces that rounding exactly (one fused elementwise
    # multiply-add per k step, float32).  DP tie-breaking depends on it.
    dim = M.shape[0]
    t2 = np.zeros((g2s.shape[0], dim), dtype=np.float32)   # (Mᵀ·g2)ᵀ
    for b in range(dim):
        t2 = (t2 + g2s[:, b][:, None] * M[b][None, :]).astype(np.float32)
    num = np.zeros((g1s.shape[0], g2s.shape[0]), dtype=np.float32)
    for d in range(dim):
        num = (num + g1s[:, d][:, None] * t2[:, d][None, :]).astype(np.float32)

    v1 = _eigen_dot_f32(g1s, pi)               # g1ᵀ·pi
    v2 = _eigen_dot_f32(g2s, pi)               # piᵀ·g2
    den = (v1[:, None] * v2[None, :]).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        # sentinel columns are all-zero -> 0/0, resolved by ls_log below
        S = (num / den).astype(np.float32)

    # apply ls_log in Eigen's column-major storage order
    S_cm = np.asfortranarray(S)
    flat = S_cm.ravel(order="F")
    flat = ls_log_add(flat, scores.match_init)
    return flat.reshape(S.shape, order="F")
