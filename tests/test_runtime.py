"""Compile-cache placement and the GPU smoke test's refusal to run without
a GPU."""

import json
import os
import subprocess
import sys

import jax

from prographmsa_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _updates(monkeypatch)
    assert runtime.enable_compile_cache.__wrapped__() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set
    assert "jax_compilation_cache_dir" not in calls


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _updates(monkeypatch)
    want = os.path.join(REPO, ".jax_cache")
    assert runtime.enable_compile_cache.__wrapped__() == want
    assert calls["jax_compilation_cache_dir"] == want


def test_chip_smoke_refuses_a_host_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            last = None
        assert not (isinstance(last, dict) and last.get("ok"))
