"""Long sequences on the device DP path (SURVEY §5 long-context row).

The fill keeps only a ring of recent diagonals and writes the code plane
to device memory, so its working set per program is a few rows whatever
the sequence length: the only ceiling is device memory (MAX_N per side).
This test runs a 500-residue pair through ``align_pairs_device`` (the
fill in the Pallas interpreter on the CPU; chip_smoke.py runs the compiled
kernel on 8 x 2000-residue pairs) and checks mappings against the host
engine bit-for-bit.
"""

import numpy as np

from prographmsa_tpu.align.graph_dp_pallas import align_pairs_device
from prographmsa_tpu.align.scores import DynProgScores
from prographmsa_tpu.config import Options
from prographmsa_tpu.engine.progressive import align_graphs
from prographmsa_tpu.graph.graph import sequence_graph
from prographmsa_tpu.models.factory import get_default_model_factory
from prographmsa_tpu.alphabet import AA_SPEC


def test_long_pair_500():
    rng = np.random.default_rng(11)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    s1 = "".join(rng.choice(list(aas)) for _ in range(500))
    s2 = "".join(rng.choice(list(aas)) for _ in range(480))
    opts = Options(sequence_file="x", fasta_flag=True)
    enc1, enc2 = AA_SPEC.encode(s1), AA_SPEC.encode(s2)
    mf = get_default_model_factory(opts, AA_SPEC, [enc1, enc2])
    g1 = sequence_graph(AA_SPEC, enc1)
    g2 = sequence_graph(AA_SPEC, enc2)
    model = mf.get_model(0.7, opts, 0.7)
    scores = DynProgScores(g1, g2, model, opts)

    res = align_pairs_device([(g1, g2, model, scores)], interpret=True)[0]
    assert res is not None, "long pair left the device path"
    aln, _ = align_graphs(g1, g2, model, opts)
    assert list(res[0]) == list(aln.mapping1)
    assert list(res[1]) == list(aln.mapping2)
    assert np.float32(res[2]) == np.float32(aln.score)
