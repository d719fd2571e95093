"""A REAL 2-process jax.distributed cluster on localhost (CPU).

Two subprocesses, each with 4 virtual CPU devices, join one coordination
service (multi-controller JAX) and run the production sharded NW kernel
and the +F histogram psum over the 8-device GLOBAL mesh.  Each process
verifies its addressable output shards against a locally-computed
reference and that the psum result is identical everywhere — so
cross-process collectives and the global-array plumbing are actually
exercised, unlike the 1-process smoke test in test_distributed.py.
(SURVEY §2.5 comm-backend row.)
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
from prographmsa_tpu.parallel.distributed import maybe_initialize
assert maybe_initialize()
import jax
import jax.numpy as jnp
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4

from jax.sharding import NamedSharding, PartitionSpec as P
from prographmsa_tpu.parallel.mesh import make_mesh
from prographmsa_tpu.parallel.sharded import (sharded_nw_counts,
                                              sharded_freq_hist)
from prographmsa_tpu.distances.align import _load_scoring, GAP_PARAMS
from prographmsa_tpu.distances.nw_device import _make_kernel

mesh = make_mesh(8)
scoring = _load_scoring("aa")
go, ge = GAP_PARAMS["aa"]
dim = 20
B, L = 16, 12
rng = np.random.default_rng(7)
s1b = rng.integers(0, 20, (B, L)).astype(np.int32)
s2b = rng.integers(0, 20, (B, L)).astype(np.int32)
l1 = np.full(B, L, np.int32)
l2 = np.full(B, L, np.int32)

def garr(a, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

counts, gaps, wf = sharded_nw_counts(
    mesh, garr(s1b, P("pairs")), garr(s2b, P("pairs")),
    garr(l1, P("pairs")), garr(l2, P("pairs")),
    garr(scoring, P()), go, ge, dim)

# local single-device reference (kernel correctness itself is covered by
# tests/test_nw_device.py against the host path)
kern = _make_kernel(L, L, go, ge, dim, scoring.shape[0])
rc, rg, rw = jax.jit(kern)(s1b, s2b, l1, l2, scoring)
rc, rg, rw = np.asarray(rc), np.asarray(rg), np.asarray(rw)

for arr, ref in ((counts, rc), (gaps, rg), (wf, rw)):
    for shard in arr.addressable_shards:
        got = np.asarray(shard.data)
        want = ref[shard.index]
        assert np.array_equal(got, want), (shard.index, got, want)

# +F histogram psum across processes: replicated result == local full sum
values = rng.integers(-1, 20, (B, 24)).astype(np.int32)
hist = sharded_freq_hist(mesh, garr(values, P("pairs")), dim)
histl = np.asarray(hist.addressable_shards[0].data
                   if hist.addressable_shards else hist)
expect = np.zeros(dim, np.float32)
for v in values.reshape(-1):
    if 0 <= v < dim:
        expect[v] += 1
assert np.array_equal(histl.reshape(-1), expect), (histl, expect)

# --- the PRODUCTION graph-DP level batch across BOTH processes
# align_pairs_device under the 8-device global mesh,
# interpret-mode kernel, mappings byte-compared against the host engine
# in every process
from prographmsa_tpu.config import Options
from prographmsa_tpu.alphabet import AA_SPEC
from prographmsa_tpu.graph.graph import sequence_graph
from prographmsa_tpu.models.factory import WagModelFactory
from prographmsa_tpu.align.scores import DynProgScores
from prographmsa_tpu.align.graph_dp_pallas import align_pairs_device
from prographmsa_tpu.engine.progressive import align_graphs

opts = Options()
fact = WagModelFactory()
model = fact.get_model(0.4, opts)
aas = "ACDEFGHIKLMNPQRSTVWY"
grng = np.random.default_rng(21)
items = []
for _ in range(16):
    a1 = "".join(grng.choice(list(aas)) for _ in range(18))
    a2 = "".join(grng.choice(list(aas)) for _ in range(16))
    g1 = sequence_graph(AA_SPEC, AA_SPEC.encode(a1))
    g2 = sequence_graph(AA_SPEC, AA_SPEC.encode(a2))
    items.append((g1, g2, model, DynProgScores(g1, g2, model, opts)))
res = align_pairs_device(items, interpret=True, mesh=mesh)
assert all(r is not None for r in res), "level batch left the mesh path"
for r, (g1, g2, m, sc) in zip(res, items):
    aln, _ = align_graphs(g1, g2, m, opts.replace(engine="numpy"),
                          scores=sc)
    assert list(r[0]) == list(aln.mapping1)
    assert list(r[1]) == list(aln.mapping2)

print("DIST2-OK", jax.process_index())
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster():
    port = _free_port()
    procs = []
    for pid in (0, 1):
        env = dict(os.environ)
        env.pop("PYTEST_CURRENT_TEST", None)
        env.update(JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PROGRAPHMSA_DIST="1",
                   PROGRAPHMSA_COORD="127.0.0.1:%d" % port,
                   PROGRAPHMSA_NUM_PROCESSES="2",
                   PROGRAPHMSA_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD % {"repo": REPO}], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, "process %d failed:\n%s" % (pid, err[-3000:])
        assert "DIST2-OK %d" % pid in out, (out, err[-1500:])
