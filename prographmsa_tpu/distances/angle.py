"""Alignment-free k-mer ("angle") distances.

Re-derivation of /root/reference/src/DistanceFactoryAngle.h as one batched
count + GEMM:  count all DIM^K k-mers per sequence, cosine similarity of the
count vectors via a single matmul, then the distance transform
(DistanceFactoryAngle.h:115-128).

``compute_angle_distances`` is the float64 host/parity path (matches the
reference's double-precision Eigen GEMM, whose rounding decides NJ
tie-breaks); the device form of the Gram matrix — exact for integer counts
< 2^24 at "highest" precision — is ``compute_angle_distances_device``, and
``parallel.sharded.sharded_gram`` shards it over a mesh.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def kmer_counts(spec, seqs: Dict[str, np.ndarray], order: List[str],
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding k-mer index counting (DistanceFactoryAngle.h:61-96).

    Returns (counts[N, DIM**k] float64, seq_len[N]).
    A k-mer containing any invalid residue is skipped.
    """
    dim = spec.DIM
    n = len(order)
    counts = np.zeros((n, dim ** k), dtype=np.float64)
    seq_len = np.zeros(n, dtype=np.int64)
    weights = dim ** np.arange(k - 1, -1, -1)
    for i, name in enumerate(order):
        vals = spec.values(seqs[name]).astype(np.int64)
        seq_len[i] = len(vals)
        valid = (vals >= 0) & (vals < dim)
        vals = np.where(valid, vals, 0)
        if len(vals) < k:
            continue
        # windows[j] = index of k-mer ending at j+k-1
        idx = np.zeros(len(vals) - k + 1, dtype=np.int64)
        ok = np.ones(len(vals) - k + 1, dtype=bool)
        for t in range(k):
            idx += vals[t:len(vals) - k + 1 + t] * weights[t]
            ok &= valid[t:len(vals) - k + 1 + t]
        np.add.at(counts[i], idx[ok], 1.0)
    return counts, seq_len


def _distance_transform(cos: np.ndarray, seq_len: np.ndarray, options):
    """cosine-similarity matrix -> (distances, variances)
    (DistanceFactoryAngle.h:116-128)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        d = -np.log((np.square(cos) + 0.4) / 1.4)
        if not options.mldist_flag and not options.mldist_gap_flag:
            e = np.exp(d)
            d = -0.5 * (5.0 * e - np.sqrt(45.0 * e * e - 20.0 * e)) / e
        lens = np.broadcast_to(seq_len.astype(np.float64), (len(seq_len),
                                                            len(seq_len)))
        var = 2.0 / (lens + lens.T)
        var = var * d
    var = np.maximum(var, 1e-5)
    return d, var


def compute_angle_distances_device(spec, seqs: Dict[str, np.ndarray],
                                   order: List[str], options):
    """Device port of the angle distance: the k-mer count
    Gram matrix is one f32 matmul on the device; normalization and the
    distance transform stay float64 on the host.

    Rounding vs the f64 host path, measured on fam20/fam100: max cosine
    difference ~1e-15 (1 f64 ulp), max distance difference ~2e-15, NJ
    trees identical — but NOT guaranteed bit-identical for arbitrary
    inputs (the host path replays Eigen's scaled-GEMM accumulation order;
    this one divides by the norms after an exact integer Gram), so it is
    wired only under the explicit device/pallas engines
    (engine_policy.use_device_angle); ``auto`` keeps the parity path."""
    import jax
    import jax.numpy as jnp

    counts, seq_len = kmer_counts(spec, seqs, order, spec.kmer_k)
    C = jnp.asarray(counts.astype(np.float32))
    G = np.asarray(jax.jit(
        lambda c: jnp.dot(c, c.T, precision="highest",
                          preferred_element_type=jnp.float32))(C)
    ).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / np.sqrt(np.diag(G))
        cos = G * inv[:, None] * inv[None, :]
    return _distance_transform(cos, seq_len, options)


def compute_angle_distances(spec, seqs: Dict[str, np.ndarray],
                            order: List[str], options):
    """Host float64 parity path.

    Follows Eigen's evaluation order exactly (DistanceFactoryAngle.h:115 is
    ``((D⁻¹·Cᵀ)·C)·D⁻¹`` left-associated): rows are scaled by 1/norm
    *before* the GEMM, and the GEMM accumulates sequentially over k — the
    rounding determines NJ tie-breaks, so this makes guide trees
    bit-identical to the reference binary."""
    counts, seq_len = kmer_counts(spec, seqs, order, spec.kmer_k)
    C = counts.T                               # [DIM^K, N] like counts2
    sq = (C * C).sum(axis=0)                   # exact integers
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_norm = 1.0 / np.sqrt(sq)
        scaled = inv_norm[:, None] * C.T       # [N, DIM^K] row-scaled
        n = len(order)
        G = np.empty((n, n))
        for i in range(n):
            # sequential-k accumulation (cumsum rounds like a scalar loop)
            G[i, :] = np.cumsum(scaled[i][:, None] * C, axis=0)[-1]
        cos = G * inv_norm[None, :]
    return _distance_transform(cos, seq_len, options)
