"""Sharded (multi-device mesh) kernels vs their single-device equivalents,
on the 8-virtual-CPU-device mesh (SURVEY.md §4.3)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from prographmsa_tpu.parallel.mesh import make_mesh, pad_to_multiple
from prographmsa_tpu.parallel import sharded
from prographmsa_tpu.distances.align import _load_scoring, GAP_PARAMS
from prographmsa_tpu.distances.nw_device import nw_counts_device


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return make_mesh(8)


def test_sharded_nw_counts_matches_single(mesh):
    rng = np.random.default_rng(1)
    B, L = 16, 24
    s1 = rng.integers(0, 20, (B, L)).astype(np.int32)
    s2 = rng.integers(0, 20, (B, L)).astype(np.int32)
    l1 = np.full(B, L, np.int32)
    l2 = np.full(B, L, np.int32)
    scoring = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]

    c0, g0 = nw_counts_device(s1, s2, l1, l2, scoring, go, ge, 20)
    c1, g1, _ = sharded.sharded_nw_counts(mesh, s1, s2, l1, l2, scoring,
                                          go, ge, 20)
    assert np.array_equal(c0, np.asarray(c1))
    assert np.array_equal(g0, np.asarray(g1))


def test_sharded_gram_matches_single(mesh):
    rng = np.random.default_rng(2)
    c = rng.integers(0, 5, (16, 32)).astype(np.float32)
    g0 = c @ c.T
    g1 = np.asarray(sharded.sharded_gram(mesh, c))
    assert np.allclose(g0, g1)


def test_sharded_freq_hist_matches_numpy(mesh):
    rng = np.random.default_rng(3)
    v = rng.integers(-1, 20, (16, 40)).astype(np.int32)
    h0 = np.bincount(v[v >= 0], minlength=20).astype(np.float32)
    h1 = np.asarray(sharded.sharded_freq_hist(mesh, v, 20))
    assert np.array_equal(h0, h1)


def test_pad_to_multiple():
    a = np.arange(10).reshape(5, 2)
    p = pad_to_multiple(a, 8, axis=0)
    assert p.shape == (8, 2)
    assert np.array_equal(p[:5], a)
    assert pad_to_multiple(p, 8, axis=0) is p


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    ge.dryrun_multichip(min(8, len(jax.devices())), interpret=True)
