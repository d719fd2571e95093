"""Test configuration.

The suite runs on the CPU: ``JAX_PLATFORMS`` defaults to ``cpu``, with an
8-virtual-device host platform so that the sharded code paths are testable
without accelerators (SURVEY.md §4.3).

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them unless JAX's backend is a GPU.  On a
machine with a card they run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end differential test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other backends)")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, not at import)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX's backend is %s"
                    % jax.default_backend())


@pytest.fixture
def interpret_fill(monkeypatch):
    """Run the engine's graph-DP fill in the Pallas interpreter: a host
    without a GPU cannot compile the Triton kernel."""
    from prographmsa_tpu.align import graph_dp_pallas as G

    orig = G.align_pairs_device
    monkeypatch.setattr(
        G, "align_pairs_device",
        lambda items, interpret=False, **kw: orig(items, interpret=True,
                                                  **kw))
