"""Prealigned pair statistics on device: substitution counts as one GEMM,
gap openings as a column scan.

Device replacement for the per-pair host loop in
``distances/prealigned.py`` (reference: the O(N²·L) column scan of
/root/reference/src/DistanceFactoryPrealigned.h:53-80).  For every pair
(i, j) of rows of the induced MSA the reference counts

  * ``counts[a, b]`` — columns where seq i has residue value a and seq j
    has value b, both values < count_bound and neither side gapped; and
  * ``gaps`` — gap *openings*: among the non-both-gap columns, maximal runs
    of "gap on one side" (both-gap columns are transparent and preserved
    state, Prealigned.h:61-80).

Counts are an inner product of masked one-hot matrices:
``counts(i,j) = Oᵢᵀ·Oⱼ`` with ``O[l, a] = [val==a and not gap]`` — so the
whole all-pairs batch is one ``einsum``.  The 0/1 operands are
exact in bfloat16 and the f32 accumulator is exact for any alignment
shorter than 2²⁴ columns, so the integer results are bit-identical to the
host loop (asserted in tests/test_prealigned_device.py).

Gap openings use the equivalence: with t = gap_i∧gap_j ("transparent"),
an opening on side s at column l happens iff ¬t[l] ∧ gap_s[l] ∧ ¬gap_s[p]
where p is the previous non-transparent column (virtually non-gap before
the first one).  That is a single ``lax.scan`` over columns carrying the
(last_gap_i, last_gap_j) state of every pair at once.

Everything is dispatched asynchronously in chunks; the per-chunk fetch is
``count_bound² ≤ 400`` int32 per pair — a few MB for hundreds of
sequences, one round-trip per chunk.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def _make_kernel(L: int, cb: int):
    import jax
    import jax.numpy as jnp

    def kernel(vals_c, gap_c_i, gap_c_j):
        """vals_c: ([P,L] i32, [P,L] i32) one-hot sources for sides i/j,
        gap_c_*: [P,L] bool.  Returns (counts [P,cb,cb] i32, gaps [P] i32)."""
        v1, v2 = vals_c
        oh1 = (jax.nn.one_hot(v1, cb, dtype=jnp.bfloat16)
               * (~gap_c_i)[..., None].astype(jnp.bfloat16))
        oh2 = (jax.nn.one_hot(v2, cb, dtype=jnp.bfloat16)
               * (~gap_c_j)[..., None].astype(jnp.bfloat16))
        counts = jnp.einsum("pla,plb->pab", oh1, oh2,
                            preferred_element_type=jnp.float32)

        def step(carry, cols):
            last1, last2 = carry
            g1, g2 = cols
            t = g1 & g2
            open1 = (~t) & g1 & (~last1)
            open2 = (~t) & g2 & (~last2)
            last1 = jnp.where(t, last1, g1)
            last2 = jnp.where(t, last2, g2)
            inc = open1.astype(jnp.int32) + open2.astype(jnp.int32)
            return (last1, last2), inc

        P = v1.shape[0]
        init = (jnp.zeros(P, bool), jnp.zeros(P, bool))
        _, incs = jax.lax.scan(step, init, (gap_c_i.T, gap_c_j.T))
        gaps = incs.sum(axis=0)
        # uint16 is exact (counts <= L < 2^16) and halves the fetch
        return counts.astype(jnp.uint16), gaps.astype(jnp.int32)

    return jax.jit(kernel)


def pair_stats_device(vals: np.ndarray, gapm: np.ndarray,
                      pairs_i: np.ndarray, pairs_j: np.ndarray,
                      count_bound: int, dim: int,
                      chunk_pairs: int = 8192):
    """All-pairs (counts, gap openings) for an induced MSA.

    vals [N, L] int32 residue values (out-of-range ignored), gapm [N, L]
    bool, pairs_i/pairs_j [P] row indices.  Returns
    (counts [P, dim, dim] int64, gaps [P] int64) — exact integers.
    """
    import jax.numpy as jnp

    P = len(pairs_i)
    L = vals.shape[1]
    if L == 0 or P == 0:
        return (np.zeros((P, dim, dim), np.int64), np.zeros(P, np.int64))
    if L >= 2 ** 16:
        raise ValueError("alignment too long for uint16 counts: %d" % L)
    # bucket L so successive guide-tree iterations (slightly different MSA
    # lengths) and repeat runs reuse one compiled kernel: pad with all-gap
    # columns, which are transparent to both counts and gap openings
    Lb = -(-max(L, 128) // 128) * 128
    if Lb != L:
        vals = np.pad(vals, ((0, 0), (0, Lb - L)), constant_values=-1)
        gapm = np.pad(gapm, ((0, 0), (0, Lb - L)), constant_values=True)
    kern = _make_kernel(Lb, count_bound)
    vals_d = jnp.asarray(vals.astype(np.int32))
    gap_d = jnp.asarray(gapm)

    pending = []  # dispatch every chunk before fetching any (async pipeline)
    for s in range(0, P, chunk_pairs):
        ii = pairs_i[s:s + chunk_pairs]
        jj = pairs_j[s:s + chunk_pairs]
        if len(ii) < chunk_pairs and P > chunk_pairs:
            pad = chunk_pairs - len(ii)
            ii = np.concatenate([ii, np.zeros(pad, ii.dtype)])
            jj = np.concatenate([jj, np.zeros(pad, jj.dtype)])
        ii_d = jnp.asarray(np.asarray(ii, np.int32))
        jj_d = jnp.asarray(np.asarray(jj, np.int32))
        c, g = kern((jnp.take(vals_d, ii_d, axis=0),
                     jnp.take(vals_d, jj_d, axis=0)),
                    jnp.take(gap_d, ii_d, axis=0),
                    jnp.take(gap_d, jj_d, axis=0))
        pending.append((c, g))

    counts = np.concatenate([np.asarray(c) for c, _ in pending])[:P]
    gaps = np.concatenate([np.asarray(g) for _, g in pending])[:P]
    counts64 = np.zeros((P, dim, dim), np.int64)
    counts64[:, :count_bound, :count_bound] = counts
    return counts64, gaps.astype(np.int64)
