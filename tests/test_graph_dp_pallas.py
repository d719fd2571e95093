"""Fused fill+backtrack (align/graph_dp_pallas.py) vs host parity.

On the CPU the Triton fill runs in the Pallas interpreter; S is the host's
exact S on every backend.  ``test_kernel_on_gpu`` compiles the kernel on
a GPU (``gpu`` marker).  The launch helpers — the S diagonal layout, the
launch shapes, the fallback counters and the memory budget — are covered
directly.
"""

import numpy as np
import pytest

from prographmsa_tpu.config import Options
from prographmsa_tpu.alphabet import AA_SPEC
from prographmsa_tpu.graph.graph import sequence_graph, clean_graph
from prographmsa_tpu.models.factory import WagModelFactory
from prographmsa_tpu.align.scores import DynProgScores, precompute_scores
from prographmsa_tpu.align.dp import fill_dp
from prographmsa_tpu.align.backtrack import backtrack
from prographmsa_tpu.align.merge import merge_graphs
from prographmsa_tpu.align.graph_dp_pallas import align_pair_device

OPTS = Options()
FACT = WagModelFactory()


def _host_align(g1, g2, model):
    sc = DynProgScores(g1, g2, model, OPTS)
    S = precompute_scores(g1, g2, model, sc, engine="numpy")
    dp = fill_dp(g1, g2, S, sc)
    return backtrack(g1, g2, dp, sc), sc


def _assert_same(g1, g2, model):
    aln, sc = _host_align(g1, g2, model)
    res = align_pair_device(g1, g2, model, sc, interpret=True)
    assert res is not None
    m1, m2, score, _ = res
    assert m1 == aln.mapping1
    assert m2 == aln.mapping2
    assert np.float32(score) == np.float32(aln.score)
    return aln


def _chain(seq):
    return sequence_graph(AA_SPEC, AA_SPEC.encode(seq))


def _merged(s1, s2, model, anc_of=None):
    g1, g2 = _chain(s1), _chain(s2)
    aln, _ = _host_align(g1, g2, model)
    anc = merge_graphs(g1, g2, aln.mapping1, aln.mapping2, model, model,
                       0.5, 0.5, OPTS)
    cg, _ = clean_graph(anc.graph, OPTS)
    return cg


def test_kernel_chains():
    m = FACT.get_model(0.3, OPTS)
    _assert_same(_chain("ACDEFGHIKLMNP"), _chain("ACDEFGIKLMNP"), m)


def test_kernel_merged_graphs():
    m = FACT.get_model(0.3, OPTS)
    cg = _merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    g3 = _chain("ACDEFGHIKLMNPQRSTVW")
    _assert_same(cg, g3, m)
    _assert_same(g3, cg, m)


def test_kernel_merged_vs_merged():
    m = FACT.get_model(0.3, OPTS)
    cg = _merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    g3 = _chain("ACDEFGHIKLMNPQRSTVW")
    aln, _ = _host_align(cg, g3, m)
    anc2 = merge_graphs(cg, g3, aln.mapping1, aln.mapping2, m, m, 0.5, 0.5,
                        OPTS)
    cg2, _ = clean_graph(anc2.graph, OPTS)
    _assert_same(cg2, cg, FACT.get_model(0.8, OPTS))


def test_kernel_random_pairs():
    rng = np.random.RandomState(5)
    AAs = "ACDEFGHIKLMNPQRSTVWY"
    m = FACT.get_model(0.6, OPTS)
    for _ in range(4):
        s1 = "".join(rng.choice(list(AAs), rng.randint(8, 80)))
        s2 = "".join(rng.choice(list(AAs), rng.randint(8, 80)))
        _assert_same(_chain(s1), _chain(s2), m)


def test_kernel_asymmetric_long_g2():
    """n2 >> n1 pairs: the traceback walks the y==0 boundary past
    x = n1p lanes, so the boundary-X stripe must be wider than n1p — an
    n1p-wide stripe would drop X[0, x] values for x >= n1p and the chase's
    flat gather would read the next pair's row."""
    AAs = "ACDEFGHIKLMNPQRSTVWY"
    m = FACT.get_model(0.3, OPTS)
    for seed in (0, 1, 2):
        rng = np.random.RandomState(seed)
        s_long = "".join(rng.choice(list(AAs), 190))
        # a mutated/deleted variant -> merged g2 with multi-offset edges
        chars = list(s_long)
        for k in sorted(rng.choice(len(chars), 12, replace=False),
                        reverse=True):
            del chars[k]
        s_var = "".join(rng.choice(list(AAs)) if rng.rand() < 0.1 else c
                        for c in chars)
        cg2 = _merged(s_long, s_var, m)
        assert cg2.size > 128 + 2, "fixture must exceed one lane tile"
        g1 = _chain("".join(rng.choice(list(AAs), 13)))
        _assert_same(g1, cg2, m)


def test_kernel_repeat_edges_splice():
    # graphs with repeat edges fill correctly; a backtrack that takes a
    # repeat edge records the event and the harvest splices the host
    # markAlternativePath columns in — same mappings AND same
    # n_tr_indels as the host walk (round-5 replacement for the old
    # whole-pair bail)
    m = FACT.get_model(0.3, OPTS)
    g1 = _chain("ACDEFACDEFACDEF")
    tr = np.full(g1.size, -1, dtype=np.int64)
    tr[1:16] = np.tile(np.arange(5), 3)
    g1.add_repeats([tr])
    g2 = _chain("ACDEFACDEF")
    opts = Options(repeat_rate=0.5, repeatext_prob=0.3)
    sc = DynProgScores(g1, g2, m, opts)
    S = precompute_scores(g1, g2, m, sc, engine="numpy")
    dp = fill_dp(g1, g2, S, sc)
    aln = backtrack(g1, g2, dp, sc)
    res = align_pair_device(g1, g2, m, sc, interpret=True)
    assert res is not None
    assert list(res[0]) == aln.mapping1 and list(res[1]) == aln.mapping2
    assert res[3] == aln.n_tr_indels
    assert aln.n_tr_indels > 0, "fixture must actually take a repeat edge"


def test_kernel_repeat_fuzz():
    """Random repeat-annotated pairs through the batch path: mappings,
    scores AND n_tr_indels must equal the host walk (exercises the
    kind-split slot order, the event splice, and the single-pair tiers)."""
    from prographmsa_tpu.align.graph_dp_pallas import align_pairs_device

    aas = "ACDEFGHIKLMNPQRSTVWY"
    items, expected = [], []
    for seed in range(4):
        rng = np.random.RandomState(100 + seed)
        unit = "".join(rng.choice(list(aas), rng.randint(3, 6)))
        reps = rng.randint(2, 5)
        pre = "".join(rng.choice(list(aas), rng.randint(0, 8)))
        post = "".join(rng.choice(list(aas), rng.randint(0, 8)))
        s1 = pre + unit * reps + post
        g1 = _chain(s1)
        tr = np.full(g1.size, -1, dtype=np.int64)
        lo = len(pre) + 1
        tr[lo:lo + len(unit) * reps] = np.tile(np.arange(len(unit)), reps)
        g1.add_repeats([tr])
        s2 = pre + unit * max(1, reps - rng.randint(1, reps)) + post
        g2 = _chain(s2)
        opts = Options(repeat_rate=0.5, repeatext_prob=0.3)
        m = FACT.get_model(0.3 + 0.1 * seed, opts)
        sc = DynProgScores(g1, g2, m, opts)
        S = precompute_scores(g1, g2, m, sc, engine="numpy")
        aln = backtrack(g1, g2, fill_dp(g1, g2, S, sc), sc)
        items.append((g1, g2, m, sc))
        expected.append(aln)
    res = align_pairs_device(items, interpret=True)
    n_ok = 0
    for r, aln in zip(res, expected):
        assert r is not None
        assert list(r[0]) == aln.mapping1
        assert list(r[1]) == aln.mapping2
        assert r[3] == aln.n_tr_indels
        n_ok += aln.n_tr_indels
    assert n_ok > 0, "fuzz never exercised a repeat step"


@pytest.mark.gpu
def test_kernel_on_gpu(gpu):
    m = FACT.get_model(0.3, OPTS)
    cg = _merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    g3 = _chain("ACDEFGHIKLMNPQRSTVW")
    aln, sc = _host_align(cg, g3, m)
    res = align_pair_device(cg, g3, m, sc)
    assert res is not None
    assert res[0] == aln.mapping1 and res[1] == aln.mapping2
    assert np.float32(res[2]) == np.float32(aln.score)


def test_kernel_batch_mixed_pairs():
    from prographmsa_tpu.align.graph_dp_pallas import (align_pairs_device,
                                                      fallback_stats)
    rng = np.random.RandomState(9)
    AAs = "ACDEFGHIKLMNPQRSTVWY"
    m = FACT.get_model(0.4, OPTS)
    cg = _merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    items, expected = [], []
    for spec_pair in [
        (_chain("ACDEFGHIKLMNP"), _chain("ACDEFGIKLMNP")),
        (cg, _chain("ACDEFGHIKLMNPQRSTVW")),
        (_chain("".join(rng.choice(list(AAs), 40))),
         _chain("".join(rng.choice(list(AAs), 33)))),
    ]:
        g1, g2 = spec_pair
        aln, sc = _host_align(g1, g2, m)
        items.append((g1, g2, m, sc))
        expected.append(aln)
    before = fallback_stats()
    res = align_pairs_device(items, interpret=True)
    after = fallback_stats()
    assert all(r is not None for r in res)
    for r, aln in zip(res, expected):
        assert r[0] == aln.mapping1
        assert r[1] == aln.mapping2
        assert np.float32(r[2]) == np.float32(aln.score)
    # silent-fallback regression guard: chain/merged pairs of this shape
    # must ALL stay on the device path, and the counters must record
    # exactly that
    assert after["pairs_device"] - before["pairs_device"] == len(items)
    for k, v in after.items():
        if k.startswith("fb_"):
            assert v == before.get(k, 0), "silent fallback: %s" % k


def test_kernel_many_offsets_tiers():
    # synthetic graphs with many distinct predecessor offsets exercise the
    # looped slot path (more than _UNROLL slots), which compiles
    # differently from the unrolled few-slot path
    from prographmsa_tpu.graph.graph import Graph

    rng = np.random.RandomState(17)
    AAs = "ACDEFGHIKLMNPQRSTVWY"
    m = FACT.get_model(0.5, OPTS)

    def heavy(n, offsets, seed):
        r = np.random.RandomState(seed)
        prof = np.zeros((n - 2, 20))
        prof[np.arange(n - 2), r.randint(0, 20, n - 2)] = 1.0
        g = sequence_graph(AA_SPEC,
                          AA_SPEC.encode("".join(r.choice(list(AAs), n - 2))))
        preds = [list(p) for p in g.preds]
        for i in range(2, n - 1):
            for o in offsets:
                if i - o >= 1 and r.rand() < 0.3:
                    preds[i].append((i - o, np.float32(0.25 * o)))
        for p in preds:
            p.sort(key=lambda t: t[0])
        return Graph(g.sites.copy(), preds, [list(x) for x in g.reps])

    # tier-2 shaped (6-8 offsets, reach < 62) and tier-3 shaped (12+)
    g1 = heavy(60, [2, 3, 5, 7, 11, 13, 17], 1)
    g2 = heavy(55, [2, 3, 4, 6, 9], 2)
    _assert_same(g1, g2, m)
    g3 = heavy(48, [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 19, 23], 3)
    g4 = heavy(52, [2, 3, 5, 8, 13, 21, 34, 55], 4)
    _assert_same(g3, g4, m)


def _infos(pairs, m):
    from prographmsa_tpu.align.graph_dp_pallas import _prep_pair
    out = []
    for k, (g1, g2) in enumerate(pairs):
        sc = DynProgScores(g1, g2, m, OPTS)
        out.append(_prep_pair(k, g1, g2, m, sc))
    return out


def test_sdiag_layout_matches_numpy_s():
    """Sdiag[b, y + x, y] is the numpy tier's S[y, x] bit for bit, and NEG
    off the pair (the fill reads S by anti-diagonal)."""
    from prographmsa_tpu.align.graph_dp_pallas import (NEG, _dims, _host_s,
                                                      _make_shear)
    m = FACT.get_model(0.4, OPTS)
    cg = _merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    pairs = [(_chain("ACDEFGHIKLMNP"), _chain("ACDEFGIKLMNPQRSTVWYAC")),
             (cg, _chain("MNPQRS"))]
    infos = _infos(pairs, m)
    B, n1p, n2s, DB, op, R = _dims(infos)
    flat = infos + [None] * (B - len(infos))
    Sd = np.asarray(_make_shear(DB)(_host_s(flat, n1p, n2s)))
    assert Sd.shape == (B, DB, n1p)
    for b, info in enumerate(infos):
        S = precompute_scores(info.g1, info.g2, m, info.scores,
                              engine="numpy").astype(np.float32)
        S = np.where(np.isnan(S) | (S < NEG), NEG, S)
        y, x = np.meshgrid(np.arange(info.n1), np.arange(info.n2),
                           indexing="ij")
        got = Sd[b, y + x, y]
        assert np.array_equal(got.view(np.uint32), S.view(np.uint32))
        off = np.ones((DB, n1p), bool)
        off[y + x, y] = False
        assert (Sd[b][off] == NEG).all()
    assert (Sd[len(infos):] == NEG).all()


def test_launch_dims_are_powers_of_two():
    from prographmsa_tpu.align.graph_dp_pallas import _dims
    m = FACT.get_model(0.4, OPTS)
    cg = _merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    infos = _infos([(_chain("ACDEFGHIKL" * 3), _chain("ACDEF")),
                    (cg, _chain("ACDEFGHIKLMNPQRSTVW")),
                    (_chain("AC"), _chain("ACDEFGHIKLMNPQRSTVWY" * 2))], m)
    B, n1p, n2s, DB, op, R = _dims(infos)
    assert B == 4 and n1p == 32 and n2s == 64 and DB == n1p + n2s
    assert op == 1 << (max(max(len(i.o1), len(i.o2))
                           for i in infos) - 1).bit_length()
    assert R >= max(i.reach for i in infos) + 2 and R & (R - 1) == 0
    # a mesh of 3 devices pads the batch to a multiple of 3
    assert _dims(infos, 3)[0] == 6


def test_fallback_counters_by_reason(monkeypatch):
    import prographmsa_tpu.align.graph_dp_pallas as G
    m = FACT.get_model(0.4, OPTS)
    cg = _merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    g_small = _chain("ACDEFGHIK")
    items = []
    for g1, g2 in ((g_small, _chain("ACDEF")), (cg, g_small),
                   (_chain("ACDEFGHIKLMNPQRSTVWY" * 2), g_small)):
        items.append((g1, g2, m, DynProgScores(g1, g2, m, OPTS)))
    monkeypatch.setattr(G, "MAX_N", 30)          # the 40-residue chain
    monkeypatch.setattr(G, "MAX_OFF", 1)         # the merged graph
    before = G.fallback_stats()
    res = G.align_pairs_device(items, interpret=True)
    after = G.fallback_stats()
    delta = {k: after[k] - before[k] for k in after}
    assert res[0] is not None and res[1] is None and res[2] is None
    assert delta == {"pairs_total": 3, "pairs_device": 1, "fb_offsets": 1,
                     "fb_size": 1, "fb_reach": 0, "fb_rep": 0,
                     "fb_chase": 0}
    monkeypatch.setattr(G, "MAX_OFF", 64)
    monkeypatch.setattr(G, "MAX_RING", 2)        # reach 2 needs 4 slots
    assert G._prep_pair(0, *items[0]) == "fb_reach"


def test_memory_budget_splits_the_batch(monkeypatch):
    """A batch over the device budget runs as several launches with the
    same results; a single pair over it falls back to the host."""
    import prographmsa_tpu.align.graph_dp_pallas as G
    rng = np.random.RandomState(4)
    AAs = "ACDEFGHIKLMNPQRSTVWY"
    m = FACT.get_model(0.5, OPTS)
    items, expected = [], []
    for _ in range(3):
        g1 = _chain("".join(rng.choice(list(AAs), rng.randint(10, 30))))
        g2 = _chain("".join(rng.choice(list(AAs), rng.randint(10, 30))))
        aln, sc = _host_align(g1, g2, m)
        items.append((g1, g2, m, sc))
        expected.append(aln)
    one = max(G._launch_bytes([G._prep_pair(0, *it)]) for it in items)
    monkeypatch.setattr(G, "_device_budget", lambda: one)
    launches = []
    orig = G._launch
    monkeypatch.setattr(G, "_launch", lambda infos, *a, **k: (
        launches.append(len(infos)) or orig(infos, *a, **k)))
    res = G.align_pairs_device(items, interpret=True)
    assert launches == [1, 1, 1]
    for r, aln in zip(res, expected):
        assert r[0] == aln.mapping1 and r[1] == aln.mapping2
    monkeypatch.setattr(G, "_device_budget", lambda: one / 100)
    before = G.fallback_stats()["fb_size"]
    assert G.align_pairs_device(items[:1], interpret=True) == [None]
    assert G.fallback_stats()["fb_size"] == before + 1
