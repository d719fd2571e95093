"""Multi-host (multi-controller) JAX scaffolding.

The reference is strictly single-process (SURVEY §2.5: no MPI/NCCL/threads
anywhere).  The replacement for scale-out is multi-controller JAX: every
host runs the same program, ``jax.distributed.initialize`` wires the hosts
into one global device mesh, and the existing ``shard_map`` programs
(parallel/sharded.py) then shard over ALL hosts' devices with no further
code changes (the mesh in ``parallel/mesh.py`` is built from
``jax.devices()``, which becomes the global device list).

Activation is explicit and environment-driven (the CLI on a laptop must
never try to join a cluster):

  PROGRAPHMSA_DIST=1                    enable
  PROGRAPHMSA_COORD=host0:8476          coordinator address
  PROGRAPHMSA_NUM_PROCESSES / PROGRAPHMSA_PROCESS_ID
                                        explicit topology

On GPU hosts all three are needed: nothing tells JAX of the cluster.
``shutdown()`` is registered atexit so the coordinator service winds down
cleanly.
"""

from __future__ import annotations

import atexit
import os
import sys

_initialized = False


def is_enabled() -> bool:
    return os.environ.get("PROGRAPHMSA_DIST", "0") == "1"


def maybe_initialize() -> bool:
    """Join the multi-host cluster if PROGRAPHMSA_DIST=1.  Returns whether
    distributed mode is active.  Idempotent; failures are fatal (a job
    that was asked to be distributed must not silently run 1-host)."""
    global _initialized
    if not is_enabled():
        return False
    if _initialized:
        return True
    import jax

    kwargs = {}
    if os.environ.get("PROGRAPHMSA_COORD"):
        kwargs["coordinator_address"] = os.environ["PROGRAPHMSA_COORD"]
    if os.environ.get("PROGRAPHMSA_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["PROGRAPHMSA_NUM_PROCESSES"])
    if os.environ.get("PROGRAPHMSA_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["PROGRAPHMSA_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    _initialized = True
    atexit.register(shutdown)
    print("prographmsa: joined distributed cluster as process %d/%d "
          "(%d local / %d global devices)"
          % (jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count()),
          file=sys.stderr)
    return True


def shutdown() -> None:
    global _initialized
    if not _initialized:
        return
    _initialized = False
    try:
        import jax
        jax.distributed.shutdown()
    except Exception:  # noqa: BLE001 — atexit must never raise
        pass
