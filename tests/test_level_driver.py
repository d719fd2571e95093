"""Level-batched driver vs sequential driver byte-equality."""

import numpy as np

from prographmsa_tpu.config import Options
from prographmsa_tpu.io.fasta import read_fasta
from prographmsa_tpu.cli import do_align
from prographmsa_tpu.io.fasta import write_fasta
from prographmsa_tpu.tree.phytree import get_tree_order
import io


def _run(opts):
    seqs, _ = read_fasta("fixtures/fam6.fasta")
    aligned, all_trees = do_align(seqs, opts)
    buf = io.StringIO()
    write_fasta(aligned, get_tree_order(all_trees[-1], opts), buf)
    return buf.getvalue()

def test_level_driver_matches_sequential(interpret_fill):
    base = Options(sequence_file="x", fasta_flag=True)
    a = _run(base.replace(engine="native"))
    b = _run(base.replace(engine="pallas"))
    assert a == b
