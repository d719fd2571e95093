"""Device angle-distance port vs the f64 host parity path.

The device Gram is one f32 matmul over integer k-mer counts; the distance
transform stays f64 on host.  Measured divergence vs the Eigen-order f64
path is ~1e-15; these tests pin that bound and assert the
guide trees and distances stay equivalent on the golden corpus.  The
device path is gated behind the explicit device/pallas engines
(engine_policy.use_device_angle) — ``auto`` keeps bit parity.
"""

import numpy as np

from prographmsa_tpu.config import Options
from prographmsa_tpu.alphabet import AA_SPEC
from prographmsa_tpu.io.fasta import read_fasta
from prographmsa_tpu.distances.angle import (compute_angle_distances,
                                             compute_angle_distances_device)
from prographmsa_tpu.tree.nj import build_nj_tree
from prographmsa_tpu.engine_policy import use_device_angle

import os

FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "fixtures")


def _encoded(fixture):
    seqs, order = read_fasta(os.path.join(FIX, fixture))
    enc = {}
    for k, v in seqs.items():
        e = AA_SPEC.encode(v)
        if len(e) and chr(e[0]) == "M":
            e = e[1:]
        enc[k] = e
    return enc, order


def test_device_angle_matches_host_trees():
    opts = Options(sequence_file="x", fasta_flag=True)
    for fixture in ("fam20.fasta", "fam100.fasta"):
        enc, order = _encoded(fixture)
        d_h, v_h = compute_angle_distances(AA_SPEC, enc, order, opts)
        d_d, v_d = compute_angle_distances_device(AA_SPEC, enc, order, opts)
        iu = np.triu_indices(len(order), 1)
        assert np.abs(d_d - d_h)[iu].max() < 1e-9
        t_h = build_nj_tree(order, d_h, v_h, opts)
        t_d = build_nj_tree(order, d_d, v_d, opts)
        assert t_h.format_newick() == t_d.format_newick()


def test_device_angle_gating():
    auto = Options()
    assert not use_device_angle(auto)
    assert use_device_angle(auto.replace(engine="device"))
    assert use_device_angle(auto.replace(engine="pallas"))
    assert not use_device_angle(auto.replace(engine="native"))
