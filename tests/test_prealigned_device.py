"""Device prealigned pair statistics are bit-identical to the host loop.

The host loop (`distances/prealigned._pair_stats`) is itself golden-tested
against the reference binary through the iteration-2 e2e cases; here the
device kernel (one-hot GEMM + column scan) must match it exactly on
random gapped MSAs across alphabets, including the count_bound quirk
(reference Prealigned.h:65 counts only values < 20).
"""

import numpy as np
import pytest

from prographmsa_tpu.alphabet import AA_SPEC, DNA_SPEC
from prographmsa_tpu.distances.prealigned import _pair_stats
from prographmsa_tpu.distances.prealigned_device import pair_stats_device


def _random_msa(spec, n, L, seed):
    rng = np.random.default_rng(seed)
    chars = list("ACDEFGHIKLMNPQRSTVWY" if spec is AA_SPEC else "ACGT")
    chars += ["-", "-", "X"]  # plenty of gaps + unknowns
    rows = []
    for _ in range(n):
        s = "".join(rng.choice(chars) for _ in range(L))
        raw = np.frombuffer(s.encode(), np.uint8).astype(np.int16)
        rows.append(raw)
    return rows


@pytest.mark.parametrize("spec,cb", [(AA_SPEC, 20), (DNA_SPEC, 4)])
def test_pair_stats_device_matches_host(spec, cb):
    n, L = 7, 53
    rows = _random_msa(spec, n, L, seed=hash((spec.name, 1)) % 2**31)
    vals = np.stack([spec.values(r) for r in rows]).astype(np.int32)
    gapm = np.stack([spec.is_gap(r) for r in rows])
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pi = np.array([i for i, _ in pairs], np.int32)
    pj = np.array([j for _, j in pairs], np.int32)

    counts_d, gaps_d = pair_stats_device(vals, gapm, pi, pj, cb, spec.DIM)
    for k, (i, j) in enumerate(pairs):
        counts_h, gaps_h = _pair_stats(vals[i], gapm[i], vals[j], gapm[j],
                                       spec.DIM, cb)
        assert np.array_equal(counts_d[k], counts_h), (i, j)
        assert gaps_d[k] == gaps_h, (i, j)


def test_pair_stats_device_chunking():
    """Chunked dispatch (padded final chunk) returns the same as one shot."""
    spec = AA_SPEC
    n, L = 9, 31
    rows = _random_msa(spec, n, L, seed=7)
    vals = np.stack([spec.values(r) for r in rows]).astype(np.int32)
    gapm = np.stack([spec.is_gap(r) for r in rows])
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pi = np.array([i for i, _ in pairs], np.int32)
    pj = np.array([j for _, j in pairs], np.int32)
    c1, g1 = pair_stats_device(vals, gapm, pi, pj, 20, spec.DIM)
    c2, g2 = pair_stats_device(vals, gapm, pi, pj, 20, spec.DIM,
                               chunk_pairs=10)
    assert np.array_equal(c1, c2)
    assert np.array_equal(g1, g2)


def test_pair_stats_empty():
    c, g = pair_stats_device(np.zeros((2, 0), np.int32),
                             np.zeros((2, 0), bool),
                             np.array([0], np.int32), np.array([1], np.int32),
                             20, 20)
    assert c.shape == (1, 20, 20) and not c.any() and not g.any()
