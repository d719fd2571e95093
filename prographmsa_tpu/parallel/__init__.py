"""Multi-chip scaling: device meshes, sharded kernels, collectives.

The reference is single-threaded C++ (SURVEY.md §2.5: no parallelism of any
kind); this package is the multi-device design it lacks — data-parallel
sharding of the all-pairs distance workload and of per-tree-level alignment
batches over a ``jax.sharding.Mesh``, with XLA collectives (all_gather,
psum) that XLA hands to NCCL on GPUs.
"""

from .mesh import make_mesh  # noqa: F401
