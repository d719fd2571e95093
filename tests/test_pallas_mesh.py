"""Mesh-sharded level batch: the graph-pair DP spread over devices.

The whole fill+chase pipeline runs under one shard_map over the pairs
axis of the 8-device virtual mesh (the alignment stage itself — not just
NW distances — has a multi-device path).  Results must be byte-identical
to the host engines.
"""

import numpy as np

from prographmsa_tpu.config import Options
from prographmsa_tpu.alphabet import AA_SPEC
from prographmsa_tpu.graph.graph import sequence_graph, clean_graph
from prographmsa_tpu.models.factory import WagModelFactory
from prographmsa_tpu.align.scores import DynProgScores, precompute_scores
from prographmsa_tpu.align.dp import fill_dp
from prographmsa_tpu.align.backtrack import backtrack
from prographmsa_tpu.align.merge import merge_graphs
from prographmsa_tpu.align.graph_dp_pallas import align_pairs_device
from prographmsa_tpu.parallel.mesh import make_mesh

OPTS = Options()
FACT = WagModelFactory()


def _host_align(g1, g2, model):
    sc = DynProgScores(g1, g2, model, OPTS)
    S = precompute_scores(g1, g2, model, sc, engine="numpy")
    dp = fill_dp(g1, g2, S, sc)
    return backtrack(g1, g2, dp, sc), sc


def _chain(seq):
    return sequence_graph(AA_SPEC, AA_SPEC.encode(seq))


def test_mesh_sharded_level_batch():
    import jax

    mesh = make_mesh(len(jax.devices()))
    rng = np.random.RandomState(3)
    AAs = "ACDEFGHIKLMNPQRSTVWY"
    m = FACT.get_model(0.4, OPTS)

    # a mixed batch: chains and a merged graph (multiple offsets)
    g1 = _chain("ACDEFGHIKLMNPQRSTVWY")
    g2 = _chain("ACDEFGIKMNPQRSTVWY")
    aln, _ = _host_align(g1, g2, m)
    anc = merge_graphs(g1, g2, aln.mapping1, aln.mapping2, m, m, 0.5, 0.5,
                       OPTS)
    cg, _ = clean_graph(anc.graph, OPTS)

    items, expected = [], []
    for _ in range(10):
        s1 = "".join(rng.choice(list(AAs), rng.randint(10, 60)))
        s2 = "".join(rng.choice(list(AAs), rng.randint(10, 60)))
        ga, gb = _chain(s1), _chain(s2)
        a, sc = _host_align(ga, gb, m)
        items.append((ga, gb, m, sc))
        expected.append(a)
    a, sc = _host_align(cg, _chain("ACDEFGHIKLMNPQRSTVW"), m)
    items.append((cg, _chain("ACDEFGHIKLMNPQRSTVW"), m, sc))
    expected.append(a)

    res = align_pairs_device(items, interpret=True, mesh=mesh)
    assert all(r is not None for r in res)
    for r, aln in zip(res, expected):
        assert list(r[0]) == list(aln.mapping1)
        assert list(r[1]) == list(aln.mapping2)
        assert np.float32(r[2]) == np.float32(aln.score)
