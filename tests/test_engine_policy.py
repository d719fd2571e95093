"""Engine policy: one GPU predicate decides every ``auto`` route, the
explicit engines override it, and each decision is counted."""

from prographmsa_tpu import engine_policy as EP
from prographmsa_tpu import timings
from prographmsa_tpu.config import Options


def _routes(opts):
    return (EP.use_device_nw(opts), EP.use_device_prealigned(opts),
            EP.use_pallas_dp(opts), EP.use_device_angle(opts))


def test_gpu_predicate_follows_backend(monkeypatch):
    monkeypatch.setattr(EP, "device_backend", lambda: "gpu")
    assert EP.on_gpu()
    monkeypatch.setattr(EP, "device_backend", lambda: "cpu")
    assert not EP.on_gpu()


def test_backend_is_the_one_jax_reports():
    import jax
    assert EP.device_backend() == jax.default_backend()
    assert EP.on_gpu() == (jax.default_backend() == "gpu")


def test_auto_routes_exact_stages_to_gpu(monkeypatch):
    monkeypatch.setattr(EP, "on_gpu", lambda: True)
    # angle stays on the f64 host path under auto (tie-break parity)
    assert _routes(Options()) == (True, True, True, False)


def test_auto_stays_on_host_without_gpu(monkeypatch):
    monkeypatch.setattr(EP, "on_gpu", lambda: False)
    assert _routes(Options()) == (False, False, False, False)


def test_explicit_engines_override_and_are_counted(monkeypatch):
    monkeypatch.setattr(EP, "on_gpu", lambda: True)
    auto = Options()
    timings.enable(True)
    try:
        assert _routes(auto.replace(engine="pallas")) == (True, True, True,
                                                          True)
        assert _routes(auto.replace(engine="device")) == (True, True, False,
                                                          True)
        for eng in ("native", "numpy"):
            assert _routes(auto.replace(engine=eng)) == (False,) * 4
        c = timings.counters()
    finally:
        timings.enable(False)
    assert c["route_dp_device"] == 1 and c["route_dp_host"] == 3
    assert c["route_nw_device"] == 2 and c["route_nw_host"] == 2
