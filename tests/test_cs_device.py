"""Device CS-profile path vs the host f64 parity path.

The window-scoring + mixing GEMMs run in f32 on device under the explicit
engines; `auto` keeps the f64 host path whose rounding feeds reference
tie-breaks.  The divergence on the fixture stays below 1e-5, and the
c4-style output under --engine pallas equals the numpy tier's.
"""

import io
import os

import numpy as np

from prographmsa_tpu.alphabet import AA_SPEC
from prographmsa_tpu.config import Options
from prographmsa_tpu.cs_profile import CSProfileLibrary
from prographmsa_tpu.io.fasta import read_fasta
from prographmsa_tpu.models.factory import get_default_model_factory

FIX = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures")


def _items():
    seqs, _ = read_fasta(os.path.join(FIX, "fam6.fasta"))
    opts = Options(sequence_file=os.path.join(FIX, "fam6.fasta"),
                   cs_file=os.path.join(FIX, "cs16.lib"), fasta_flag=True)
    fact = get_default_model_factory(
        opts, AA_SPEC, [AA_SPEC.encode(s) for s in seqs.values()])
    return [(AA_SPEC.encode(s), fact.get_model(0.3, opts))
            for s in seqs.values()]


def test_device_cs_profiles_close_to_host():
    items = _items()
    libh = CSProfileLibrary(os.path.join(FIX, "cs16.lib"))
    libd = CSProfileLibrary(os.path.join(FIX, "cs16.lib"))
    libh.prime_profiles(items, engine="auto")
    libd.prime_profiles(items, engine="pallas")
    for it in items:
        ph = libh._cache[libh._key(*it)]
        pd = libd._cache[libd._key(*it)]
        assert np.max(np.abs(ph - pd)) < 1e-5, np.max(np.abs(ph - pd))


def test_auto_engine_keeps_host_path():
    # `auto` must never take the f32 device path (bit-parity guarantee)
    items = _items()
    lib = CSProfileLibrary(os.path.join(FIX, "cs16.lib"))

    called = []
    orig = lib._pk_mix_device
    lib._pk_mix_device = lambda *a, **k: called.append(1) or orig(*a, **k)
    lib.prime_profiles(items, engine="auto")
    assert not called


def _c4(engine):
    from prographmsa_tpu.cli import do_align
    from prographmsa_tpu.io.fasta import write_fasta
    from prographmsa_tpu.tree.phytree import get_tree_order

    o = Options(sequence_file=os.path.join(FIX, "fam6.fasta"),
                cs_file=os.path.join(FIX, "cs16.lib"), fasta_flag=True,
                aafreqs_flag=True, engine=engine)
    seqs, _ = read_fasta(os.path.join(FIX, "fam6.fasta"))
    aligned, trees = do_align(seqs, o)
    buf = io.StringIO()
    write_fasta(aligned, get_tree_order(trees[-1], o), buf)
    return buf.getvalue()


def test_c4_golden_identical_under_pallas(interpret_fill):
    """`-c cs16.lib -F` under --engine pallas (device CS mixing + device
    graph DP) writes the same MSA as the numpy parity tier."""
    assert _c4("pallas") == _c4("numpy")
