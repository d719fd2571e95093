"""All-pairs Needleman-Wunsch distances (--nwdist).

Re-derivation of /root/reference/src/DistanceFactoryAlign.{h,cpp}: global
affine-gap alignment with hardcoded BLOSUM64-style integer matrices, then ML
distance from the match counts.

Device design: the O(N²·L²) DP fill AND backtrack are *batched over all
pairs* and run as ``lax.scan``s over anti-diagonals on the device
(distances/nw_device.py) — integer arithmetic is exact, so device results
are bit-identical to the reference's per-pair loops.  The host-backtrack
path (W on the device path's layout, X and Y reconstructed exactly via
running-max prefix identities, per-pair backtrack) is kept as a
differential oracle.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .ml import compute_distances_batch

_DATA = os.path.join(os.path.dirname(__file__), "..", "models", "data",
                     "nw_scoring.npz")

MINFTY = -10000
GAP_PARAMS = {"aa": (-10, -2), "codon": (-10, -2), "dna": (-5, -2)}


def _load_scoring(name: str) -> np.ndarray:
    return np.load(_DATA)[name].astype(np.int32)


def _seq_codes(spec, seq: np.ndarray) -> np.ndarray:
    """value(); invalid -> 20 (reference quirk also for codon,
    DistanceFactoryAlign.h:71-79)."""
    v = spec.values(seq).astype(np.int32)
    v[v < 0] = 20
    return v


def _batched_W(s1b: np.ndarray, l1: np.ndarray, s2b: np.ndarray,
               l2: np.ndarray, scoring: np.ndarray, go: int, ge: int):
    """Device wavefront: returns W [B, L2+1, L1+1] int32 (junk beyond each
    pair's (l2, l1) region)."""
    import jax
    import jax.numpy as jnp

    B, L1 = s1b.shape
    _, L2 = s2b.shape

    # Precompute score diagonals on host (exact ints): the scan body stays
    # pure arithmetic, with no per-step 2D gather.
    ys_np = np.arange(L2 + 1)
    D = L1 + L2
    score_diags = np.zeros((D, B, L2 + 1), dtype=np.int32)
    full_scores = scoring[s2b[:, :, None], s1b[:, None, :]]  # [B, L2, L1]
    for d in range(1, D + 1):
        xs = d - ys_np
        ok = (xs >= 1) & (ys_np >= 1) & (xs <= L1) & (ys_np <= L2)
        score_diags[d - 1][:, ys_np[ok]] = full_scores[:, ys_np[ok] - 1,
                                                       xs[ok] - 1]

    scan_fn = _make_scan(L1, L2, go, ge)

    init = (jnp.full((B, L2 + 1), MINFTY, dtype=jnp.int32)
            .at[:, 0].set(0),                              # diag 0: W(0,0)=0
            jnp.full((B, L2 + 1), MINFTY, dtype=jnp.int32),
            jnp.full((B, L2 + 1), MINFTY, dtype=jnp.int32),
            jnp.full((B, L2 + 1), MINFTY, dtype=jnp.int32))

    ds = jnp.arange(1, L1 + L2 + 1)
    _, W_diags = scan_fn(init, (ds, jnp.asarray(score_diags)))
    W_diags = np.asarray(W_diags)                          # [L1+L2, B, L2+1]

    # reassemble diagonals into W [B, L2+1, L1+1]
    W = np.full((B, L2 + 1, L1 + 1), MINFTY, dtype=np.int32)
    W[:, 0, 0] = 0
    ys = np.arange(L2 + 1)
    for d in range(1, L1 + L2 + 1):
        xs = d - ys
        ok = (xs >= 0) & (xs <= L1)
        W[:, ys[ok], xs[ok]] = W_diags[d - 1][:, ys[ok]]
    return W


import functools


@functools.lru_cache(maxsize=32)
def _make_scan(L1: int, L2: int, go: int, ge: int):
    import jax
    import jax.numpy as jnp

    ys_idx = jnp.arange(L2 + 1)

    def boundary_w(x_or_y):
        return go + (x_or_y - 1) * ge

    def step(carry, inp):
        d, score = inp
        Wm1, Wm2, Xm1, Ym1 = carry
        # cell (y, x=d-y) for y in 0..L2
        xs = d - ys_idx                                   # [L2+1]

        Wm1_up = jnp.roll(Wm1, 1, axis=1)                 # (y-1) on diag d-1
        Wm2_up = jnp.roll(Wm2, 1, axis=1)                 # (y-1,x-1) on d-2
        Ym1_up = jnp.roll(Ym1, 1, axis=1)

        newX = jnp.maximum(Xm1 + ge, Wm1 + go)
        newY = jnp.maximum(Ym1_up + ge, Wm1_up + go)
        newW = jnp.maximum(Wm2_up + score,
                           jnp.maximum(newX, newY))

        # boundaries
        is_y0 = ys_idx[None, :] == 0
        is_x0 = xs[None, :] == 0
        bx = boundary_w(xs)[None, :]
        by = boundary_w(ys_idx)[None, :]
        newW = jnp.where(is_y0, bx, jnp.where(is_x0, by, newW))
        newX = jnp.where(is_y0, bx, jnp.where(is_x0, MINFTY, newX))
        newY = jnp.where(is_y0, MINFTY, jnp.where(is_x0, by, newY))
        # out-of-range junk: clamp to MINFTY to avoid drift
        oob = (xs[None, :] < 0) | (xs[None, :] > L1)
        newW = jnp.where(oob, MINFTY, newW)
        newX = jnp.where(oob, MINFTY, newX)
        newY = jnp.where(oob, MINFTY, newY)

        return (newW, Wm1, newX, newY), newW

    return jax.jit(lambda init, xs: jax.lax.scan(step, init, xs))


def _reconstruct_XY(W: np.ndarray, go: int, ge: int):
    """Exact reconstruction of X and Y from W via running maxima."""
    B, H, Wd = W.shape
    # X(y,x) = max(X(y,x-1)+ge, W(y,x-1)+go); X(y,0)=MINFTY (y>=1)
    X = np.full_like(W, MINFTY)
    xi = np.arange(Wd)
    # running max of (W(y,k)+go-ge*(k+1)) over k<x, plus ge*x
    run = np.maximum.accumulate(W[:, :, :-1] + go - ge * (xi[None, None, :-1] + 1),
                                axis=2)
    X[:, :, 1:] = run + ge * xi[None, None, 1:]
    X[:, 0, :] = go + (xi[None, :] - 1) * ge      # X(0,x) boundary
    X[:, 0, 0] = MINFTY
    # clamp against MINFTY floor semantics: X can never exceed formula but the
    # reference accumulates from MINFTY too (MINFTY+k*ge path) — include it
    floor = MINFTY + ge * xi[None, None, :]
    X[:, 1:, 1:] = np.maximum(X[:, 1:, 1:], floor[:, :, 1:])

    yi = np.arange(H)
    Y = np.full_like(W, MINFTY)
    runy = np.maximum.accumulate(
        W[:, :-1, :] + go - ge * (yi[None, :-1, None] + 1), axis=1)
    Y[:, 1:, :] = runy + ge * yi[None, 1:, None]
    Y[:, :, 0] = go + (yi[None, :] - 1) * ge
    Y[:, 0, 0] = MINFTY
    floory = MINFTY + ge * yi[None, :, None]
    Y[:, 1:, 1:] = np.maximum(Y[:, 1:, 1:], floory[:, 1:, :])
    return X, Y


def _backtrack_pair(W, X, Y, s1, s2, scoring, dim):
    """DistanceFactoryAlign.h:93-123 (exact int comparisons)."""
    counts = np.zeros((dim, dim), dtype=np.int64)
    gaps = 0
    gap_opened1 = gap_opened2 = False
    y, x = len(s2), len(s1)
    while y != 0 and x != 0:
        if W[y, x] == W[y - 1, x - 1] + scoring[s2[y - 1], s1[x - 1]]:
            if s1[x - 1] < dim and s2[y - 1] < dim:
                counts[s1[x - 1], s2[y - 1]] += 1
            gap_opened1 = gap_opened2 = False
            x -= 1
            y -= 1
        elif W[y, x] == X[y, x]:
            if not gap_opened1:
                gaps += 1
            gap_opened1, gap_opened2 = True, False
            x -= 1
        elif W[y, x] == Y[y, x]:
            if not gap_opened2:
                gaps += 1
            gap_opened1, gap_opened2 = False, True
            y -= 1
        else:
            raise RuntimeError("error while backtracking")
    return counts, gaps


def _device_nw_dispatch(s1b, s2b, l1, l2, scoring, go, ge, dim):
    """Launch one NW chunk on the device(s) WITHOUT synchronizing: returns
    the device arrays (counts, gaps).  JAX dispatch is async, so launching
    every chunk before fetching any overlaps device compute with the host
    ML Newton of earlier chunks.  With several devices visible the chunk
    shards over a mesh of all of them (padded to a multiple; callers read
    only their own rows)."""
    import jax
    import jax.numpy as jnp

    ndev = len(jax.devices())
    if ndev > 1:
        from .. import timings
        from ..parallel.mesh import make_mesh, pad_to_multiple
        from ..parallel.sharded import sharded_nw_counts
        timings.count("nw_sharded_chunks")
        s1b, s2b, l1, l2 = (pad_to_multiple(a, ndev)
                            for a in (s1b, s2b, l1, l2))
        counts, gaps, _ = sharded_nw_counts(
            make_mesh(ndev), s1b, s2b, l1, l2, scoring, go, ge, dim)
        return counts, gaps
    from .nw_device import _make_kernel
    kern = _make_kernel(s1b.shape[1], s2b.shape[1], go, ge, dim,
                        scoring.shape[0])
    counts, gaps, _ = kern(jnp.asarray(s1b), jnp.asarray(s2b),
                           jnp.asarray(l1), jnp.asarray(l2),
                           jnp.asarray(scoring))
    return counts, gaps


def compute_nw_distances(spec, seqs: Dict[str, np.ndarray], order: List[str],
                         factory, options, batch_pairs: int = 2048,
                         host_backtrack: bool = False):
    """All-pairs NW distances.  Default path: fused fill+backtrack on device
    (distances/nw_device.py) — only counts/gaps transfer.  The host-backtrack
    path is kept as a differential oracle (exact ints: identical results)."""
    n = len(order)
    scoring = _load_scoring(spec.name)
    go, ge = GAP_PARAMS[spec.name]
    codes = {name: _seq_codes(spec, seqs[name]) for name in order}
    lens = {name: len(codes[name]) for name in order}

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    distances = np.zeros((n, n))
    variances = np.zeros((n, n))

    # one padded shape for every chunk -> the scan compiles exactly once
    L1 = max(lens.values())
    L2 = L1
    chunks = []
    # smallest dtype that holds every code: a quarter of the upload
    code_dt = np.uint8 if scoring.shape[0] <= 256 else np.int32
    for start in range(0, len(pairs), batch_pairs):
        chunk = pairs[start:start + batch_pairs]
        B = batch_pairs if len(pairs) > batch_pairs else len(chunk)
        s1b = np.zeros((B, L1), dtype=code_dt)
        s2b = np.zeros((B, L2), dtype=code_dt)
        l1 = np.zeros(B, dtype=np.int32)
        l2 = np.zeros(B, dtype=np.int32)
        for b, (i, j) in enumerate(chunk):
            c1, c2 = codes[order[i]], codes[order[j]]
            s1b[b, :len(c1)] = c1
            s2b[b, :len(c2)] = c2
            l1[b], l2[b] = len(c1), len(c2)
        chunks.append((chunk, s1b, s2b, l1, l2))

    # device tier: dispatch every chunk before fetching any.  A device
    # failure raises: nothing is recomputed on the host behind its back.
    # (The numpy engine computes the exact int NW with the same XLA kernel.)
    from .. import timings
    from ..engine_policy import use_device_nw
    on_device = not host_backtrack and (use_device_nw(options)
                                        or options.engine == "numpy")
    dispatched = [None] * len(chunks)
    if on_device:
        timings.count("nw_device_pairs", len(pairs))
        for c, (chunk, s1b, s2b, l1, l2) in enumerate(chunks):
            dispatched[c] = _device_nw_dispatch(s1b, s2b, l1, l2, scoring,
                                                go, ge, spec.DIM)

    for c, (chunk, s1b, s2b, l1, l2) in enumerate(chunks):
        if dispatched[c] is not None:
            dc, dg = dispatched[c]
            counts_b, gaps_b = np.asarray(dc), np.asarray(dg)
        elif not host_backtrack:
            from .. import native
            res = native.nw_counts_native(s1b, s2b, l1, l2, scoring, go, ge,
                                          spec.DIM)
            if res is None:       # no C++ toolchain: the XLA kernel
                res = _device_nw_dispatch(s1b, s2b, l1, l2, scoring, go,
                                          ge, spec.DIM)
            counts_b, gaps_b = np.asarray(res[0]), np.asarray(res[1])
        else:
            W = _batched_W(s1b, l1, s2b, l2, scoring, go, ge)
            X, Y = _reconstruct_XY(W, go, ge)
            counts_b, gaps_b = [], []
            for b, (i, j) in enumerate(chunk):
                c1, c2 = codes[order[i]], codes[order[j]]
                counts, gaps = _backtrack_pair(
                    W[b, :len(c2) + 1, :len(c1) + 1],
                    X[b, :len(c2) + 1, :len(c1) + 1],
                    Y[b, :len(c2) + 1, :len(c1) + 1],
                    c1, c2, scoring, spec.DIM)
                counts_b.append(counts)
                gaps_b.append(gaps)

        nb = len(chunk)
        seqlens = np.array([(lens[order[i]] + lens[order[j]]) / 2.0
                            for (i, j) in chunk])
        with timings.phase("ml_newton"):
            db, vb = compute_distances_batch(
                np.asarray(counts_b[:nb], dtype=np.int64),
                np.asarray(gaps_b[:nb], dtype=np.int64), seqlens, factory,
                options, spec.name)
        for b, (i, j) in enumerate(chunk):
            distances[i, j] = distances[j, i] = db[b]
            variances[i, j] = variances[j, i] = vb[b]
    return distances, variances
