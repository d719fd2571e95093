"""A device failure is an error: it is never recomputed on the host behind
the user's back.  An injected failure of the sharded or the single-device
NW launch raises, and the CLI exits non-zero."""

import pytest

from prographmsa_tpu.config import Options
from prographmsa_tpu.alphabet import AA_SPEC
from prographmsa_tpu.io.fasta import read_fasta
import prographmsa_tpu.distances.align as A
import prographmsa_tpu.distances.nw_device as nwd
import prographmsa_tpu.parallel.sharded as sharded


def _seqs():
    raw, _ = read_fasta("fixtures/fam6.fasta")
    out = {}
    for n, s in raw.items():
        enc = AA_SPEC.encode(s)
        if len(enc) and chr(enc[0]) == "M":
            enc = enc[1:]
        out[n] = enc
    return out


def _boom(*a, **kw):
    raise RuntimeError("injected device failure")


def test_sharded_failure_raises(monkeypatch):
    opts = Options(mldist_flag=True, nwdist_flag=True, engine="device")
    from prographmsa_tpu.models.factory import WagModelFactory
    seqs = _seqs()
    monkeypatch.setattr(sharded, "sharded_nw_counts", _boom)
    with pytest.raises(RuntimeError, match="injected"):
        A.compute_nw_distances(AA_SPEC, seqs, sorted(seqs),
                               WagModelFactory(), opts)


def test_device_failure_exits_cli_nonzero(monkeypatch, capsys):
    from prographmsa_tpu import cli

    monkeypatch.setattr(sharded, "sharded_nw_counts", _boom)
    monkeypatch.setattr(nwd, "_make_kernel",
                        lambda *a, **k: _boom)
    rc = cli.main(["--fasta", "--mldist", "--nwdist", "--engine", "device",
                   "fixtures/fam6.fasta"])
    assert rc != 0
    assert "injected device failure" in capsys.readouterr().err
