"""Mesh-sharded kernels: the multi-chip execution path.

Everything here is `shard_map` over a 1-D ``pairs`` mesh axis:

* ``sharded_nw_counts`` — the all-pairs NW distance kernel
  (distances/nw_device.py) data-parallel over pair batches; no collectives
  (pairs are independent), results gathered by the output sharding.
* ``sharded_gram`` — the angle-distance cosine Gram matrix: rows sharded,
  one ``all_gather`` of the (small) count matrix per device, local GEMM
  block (DistanceFactoryAngle.h:115 at scale).
* ``sharded_freq_hist`` — the +F residue histogram as a ``psum``
  (ModelFactoryPlusF.h:72-106's count loop, sharded over sequences).
* ``pipeline_step`` — the sharded distance step (NW counts -> Gram ->
  histogram) jitted as ONE program over the mesh; used by
  ``__graft_entry__.dryrun_multichip`` and by the scale tests.  The
  guide-tree alignment stage is exercised separately through the
  PRODUCTION ``align_pairs_device`` mesh path (align/graph_dp_pallas.py).
"""

from __future__ import annotations


def _shard_map(fn, mesh, in_specs, out_specs):
    # check_vma=False: our scan carries start from broadcast constants
    # (-inf/zero init rows) which the varying-manual-axes checker rejects
    # even though every per-shard computation is independent.
    import jax
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def sharded_nw_counts(mesh, s1b, s2b, l1, l2, scoring, go: int, ge: int,
                      dim: int):
    """All-pairs NW fill+backtrack sharded over the ``pairs`` axis.
    B must be a multiple of the mesh size (pad with length-1 dummies)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..distances.nw_device import _make_kernel

    kern = _make_kernel(s1b.shape[1], s2b.shape[1], go, ge, dim,
                        scoring.shape[0])
    f = _shard_map(kern, mesh,
                   (P("pairs"), P("pairs"), P("pairs"), P("pairs"), P()),
                   (P("pairs"), P("pairs"), P("pairs")))
    counts, gaps, wf = f(jnp.asarray(s1b), jnp.asarray(s2b),
                         jnp.asarray(l1), jnp.asarray(l2),
                         jnp.asarray(scoring))
    return counts, gaps, wf


def sharded_gram(mesh, counts_f32):
    """Cosine-GEMM Gram matrix with rows sharded over the mesh: each device
    all_gathers the count matrix (tiny: N x DIM^K) and emits its row
    block."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def block(c_local):
        c_all = jax.lax.all_gather(c_local, "pairs", axis=0, tiled=True)
        return jnp.dot(c_local, c_all.T, precision="highest",
                       preferred_element_type=jnp.float32)

    f = _shard_map(block, mesh, (P("pairs"),), P("pairs"))
    return f(jnp.asarray(counts_f32))


def sharded_freq_hist(mesh, values, dim: int):
    """+F residue histogram: values [B, L] int32 (invalid < 0), sharded over
    sequences; per-device one-hot sum, then psum across the mesh
    (ModelFactoryPlusF.h:82-92 as a collective)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def hist(v):
        oh = jax.nn.one_hot(jnp.clip(v, 0, dim - 1), dim,
                            dtype=jnp.float32)
        oh = oh * ((v >= 0) & (v < dim))[..., None]
        local = oh.sum(axis=(0, 1))
        return jax.lax.psum(local, "pairs")

    f = _shard_map(hist, mesh, (P("pairs"),), P())
    return f(jnp.asarray(values))


def make_pipeline_step(mesh, nw_shapes, scoring_shape,
                       go: int, ge: int, dim: int):
    """Build the sharded distance-pipeline step as one jitted program:
    (1) all-pairs NW counts, (2) angle Gram, (3) +F histogram psum.  All
    stages run under a single ``jax.jit`` with mesh shardings, so XLA lays
    out the collectives.  (The guide-tree alignment stage is NOT a toy
    stage here any more — the dryrun exercises the production
    ``align_pairs_device`` level batch under the same mesh directly.)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..distances.nw_device import _make_kernel

    B, L = nw_shapes
    kern = _make_kernel(L, L, go, ge, dim, scoring_shape[0])

    def step(s1b, s2b, l1, l2, scoring, kmer_counts, values):
        counts, gaps, wf = kern(s1b, s2b, l1, l2, scoring)

        c_all = jax.lax.all_gather(kmer_counts, "pairs", axis=0, tiled=True)
        gram = jnp.dot(kmer_counts, c_all.T, precision="highest",
                       preferred_element_type=jnp.float32)

        oh = jax.nn.one_hot(jnp.clip(values, 0, dim - 1), dim,
                            dtype=jnp.float32)
        oh = oh * ((values >= 0) & (values < dim))[..., None]
        hist = jax.lax.psum(oh.sum(axis=(0, 1)), "pairs")

        return counts, gaps, wf, gram, hist

    sm = _shard_map(
        step, mesh,
        (P("pairs"), P("pairs"), P("pairs"), P("pairs"), P(),
         P("pairs"), P("pairs")),
        (P("pairs"), P("pairs"), P("pairs"), P("pairs"), P()))
    return jax.jit(sm)
