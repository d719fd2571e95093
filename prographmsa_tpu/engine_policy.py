"""Engine selection policy: which kernel tier runs each stage.

The framework has three executors per stage (SURVEY §7): the device tier
(JAX/XLA and the Pallas graph-DP fill on the GPU), the native host tier
(C++ via ctypes), and the numpy parity tier.  ``Options.engine`` picks:

  auto    the exact device stages on a GPU backend, native otherwise
  pallas  force the fused device graph-DP + device NW
  device  force the per-pair XLA graph-DP + device NW (debug)
  native  force the C++ host tier
  numpy   force the numpy parity tier

Under ``auto`` on a GPU, every stage whose device result is exact runs
there, whatever its size: all-pairs NW (int32 arithmetic, and one-hot
products that are exact at any precision), prealigned pair statistics
(0/1 products, integer counts) and the graph-pair DP (f32 add, subtract
and max over the host's exact S).  The float64 stages (ML Newton, angle
cosine transform, CS profiles, BioNJ) stay on the host: they are double
precision in the reference (DistanceFactoryML.h, DistanceFactoryAngle.h,
CSProfile.cpp) and their rounding decides guide-tree tie-breaks, so their
f32 device versions (angle Gram, CS mixing) run only under the explicit
device engines.  Each decision is counted under ``--timings``.
"""

from __future__ import annotations

import functools

from . import timings


@functools.lru_cache(maxsize=1)
def device_backend() -> str:
    """The JAX backend name.  A backend that fails to initialise raises
    here: the program does not quietly run on the host instead."""
    import jax
    return jax.default_backend()


def on_gpu() -> bool:
    return device_backend() == "gpu"


def _route(stage: str, options, device_engines=("device", "pallas"),
           auto=None) -> bool:
    eng = getattr(options, "engine", "auto")
    if eng == "auto":
        dev = on_gpu() if auto is None else auto
    else:
        dev = eng in device_engines
    timings.count("route_%s_%s" % (stage, "device" if dev else "host"))
    return dev


def use_device_nw(options) -> bool:
    """All-pairs NW distances on the device?"""
    return _route("nw", options)


def use_device_angle(options) -> bool:
    """Angle (k-mer) distances via the device Gram?  Only under the
    explicit device engines: the Gram itself is exact for the
    fixture-scale counts, but the host f64 path replays Eigen's
    accumulation order and its rounding decides NJ tie-breaks, so
    ``auto`` keeps the bit-parity guarantee."""
    return _route("angle", options, auto=False)


def use_device_prealigned(options) -> bool:
    """Prealigned pair statistics on the device?  The counts GEMM is exact
    (0/1 bf16 operands, f32 accumulate) and gap openings are an int scan,
    so unlike the f64 stages this one loses no rounding parity."""
    return _route("prealigned", options)


def use_pallas_dp(options) -> bool:
    """Level-batched graph-pair DP on the device fill?"""
    return _route("dp", options, device_engines=("pallas",))


@functools.lru_cache(maxsize=1)
def level_mesh():
    """Mesh for sharding a tree level's pair batch across every visible
    device (align/graph_dp_pallas.py mesh path); None on a single device
    (shard_map overhead buys nothing there)."""
    import jax
    if len(jax.devices()) < 2:
        return None
    from .parallel.mesh import make_mesh
    return make_mesh(len(jax.devices()))
