"""The port's SLO registry (cruise_control_tpu_torch.common.slo) on the CPU:
tests/test_slo.py's 11 tests that build no service, pointed at the port
(the SLO_BURN anomaly is the port's detector.anomalies.SloBurn, the
scheduler the port's fleet.scheduler).  At the end, test_service_slo_surface
and test_slo_disabled_leaves_no_registry, over the port's simulated service.
The reference's notes follow.

SLO registry tests (common/slo.py): burn-rate windows, once-per-
episode alerting on injected clocks, the sensor/exposition surface, and
the GET /slo endpoint."""

import pytest

from cruise_control_tpu_torch.common.exposition import parse_exposition, prometheus_text
from cruise_control_tpu_torch.common.sensors import SensorRegistry
from cruise_control_tpu_torch.common.slo import SloRegistry, SloSpec
import json
import urllib.request


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _registry(clock, *, sink=None, sensors=None, threshold=2.0):
    return SloRegistry(
        fast_window_s=60.0,
        slow_window_s=600.0,
        burn_threshold=threshold,
        clock=clock,
        anomaly_sink=sink,
        sensors=sensors,
    )


# ----------------------------------------------------------------------
# burn-rate math
# ----------------------------------------------------------------------


def test_burn_rate_is_bad_fraction_over_budget():
    clock = Clock()
    reg = _registry(clock)
    # objective 0.9 -> error budget 0.1: 1 bad in 10 = burn 1.0
    reg.register(SloSpec(name="s", description="d", objective=0.9))
    for i in range(9):
        reg.record("s", True)
    reg.record("s", False)
    (state,) = reg.tick()
    assert state["fastBurnRate"] == pytest.approx(1.0)
    assert state["slowBurnRate"] == pytest.approx(1.0)
    assert state["compliance"] == pytest.approx(0.9)
    assert not state["alerting"]


def test_windows_age_out_events():
    clock = Clock()
    reg = _registry(clock)
    reg.register(SloSpec(name="s", description="d", objective=0.9))
    reg.record("s", False)
    clock.t += 120.0  # past the fast window, inside the slow one
    reg.record("s", True)
    (state,) = reg.tick()
    assert state["fastBurnRate"] == 0.0  # only the good sample is recent
    assert state["slowBurnRate"] > 0.0


def test_no_samples_is_zero_burn_and_none_compliance():
    reg = _registry(Clock())
    reg.register(SloSpec(name="s", description="d", objective=0.99))
    (state,) = reg.tick()
    assert state["fastBurnRate"] == 0.0
    assert state["compliance"] is None


def test_unknown_record_ignored_and_duplicate_register_rejected():
    reg = _registry(Clock())
    reg.register(SloSpec(name="s", description="d", objective=0.99))
    reg.record("nope", False)  # a producer without a configured SLO
    with pytest.raises(ValueError, match="already registered"):
        reg.register(SloSpec(name="s", description="d", objective=0.5))
    with pytest.raises(ValueError, match="objective"):
        SloSpec(name="bad", description="d", objective=1.0)


def test_probe_none_means_no_data():
    clock = Clock()
    reg = _registry(clock)
    verdicts = iter([None, True, False])
    reg.register(SloSpec(
        name="s", description="d", objective=0.9,
        probe=lambda: next(verdicts),
    ))
    assert reg.tick()[0]["samples"] == 0  # None: skipped, not bad
    assert reg.tick()[0]["samples"] == 1
    state = reg.tick()[0]
    assert state["samples"] == 2 and state["badSamples"] == 1


def test_broken_probe_is_no_data_not_a_breach():
    reg = _registry(Clock())
    reg.register(SloSpec(
        name="s", description="d", objective=0.9,
        probe=lambda: 1 / 0,
    ))
    assert reg.tick()[0]["samples"] == 0


# ----------------------------------------------------------------------
# episodes: the acceptance story
# ----------------------------------------------------------------------


def test_sustained_breach_fires_exactly_once_per_episode():
    """An injected sustained freshness-style breach fires ONE SLO_BURN
    for the whole episode; recovery re-arms; a second breach fires a
    second anomaly — twice across two episodes, never more."""
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType, SloBurn

    clock = Clock()
    fired = []
    reg = _registry(clock, sink=fired.append)
    breaching = {"on": True}
    reg.register(SloSpec(
        name="proposal-freshness", description="d", objective=0.9,
        probe=lambda: not breaching["on"],
    ))
    # sustained breach: every tick for 3 fast windows samples bad
    for _ in range(30):
        reg.tick()
        clock.t += 6.0
    assert len(fired) == 1, "one episode must fire exactly one anomaly"
    anomaly = fired[0]
    assert isinstance(anomaly, SloBurn)
    assert anomaly.anomaly_type is AnomalyType.SLO_BURN
    assert anomaly.slo == "proposal-freshness"
    assert anomaly.fast_burn_rate >= 2.0
    assert not anomaly.fixable
    # recovery: good samples push the fast burn under the threshold
    breaching["on"] = False
    for _ in range(30):
        reg.tick()
        clock.t += 6.0
    (state,) = reg.tick()
    assert not state["alerting"]
    assert len(fired) == 1
    # second sustained breach = second episode = second anomaly
    breaching["on"] = True
    for _ in range(30):
        reg.tick()
        clock.t += 6.0
    assert len(fired) == 2
    assert fired[1].episode == 2


def test_blip_does_not_alert():
    """One bad sample in a sea of good must not page: the slow window
    exists to absorb blips."""
    clock = Clock()
    fired = []
    reg = _registry(clock, sink=fired.append, threshold=3.0)
    reg.register(SloSpec(name="s", description="d", objective=0.9))
    for i in range(60):
        reg.record("s", i != 30)  # one bad sample mid-stream
        reg.tick()
        clock.t += 6.0
    assert fired == []


def test_alert_failure_does_not_break_evaluation():
    clock = Clock()

    def sink(_):
        raise RuntimeError("notifier down")

    reg = _registry(clock, sink=sink)
    reg.register(SloSpec(
        name="s", description="d", objective=0.9, probe=lambda: False,
    ))
    for _ in range(20):
        reg.tick()
        clock.t += 6.0
    assert reg.tick()[0]["alerting"] is True  # evaluation survived


# ----------------------------------------------------------------------
# sensor / exposition surface
# ----------------------------------------------------------------------


def test_burn_gauges_render_in_lint_clean_exposition():
    clock = Clock()
    sensors = SensorRegistry()
    reg = _registry(clock, sensors=sensors)
    reg.register(SloSpec(name="pub", description="d", objective=0.9))
    reg.register(SloSpec(name="fresh", description="d", objective=0.99))
    for _ in range(10):
        reg.record("pub", False)
    reg.tick()
    body = prometheus_text(sensors)
    families = parse_exposition(body)
    burn = families["cruisecontrol_slo_burn_rate"]["samples"]
    by_label = {
        (l["slo"], l["window"]): v for _n, l, v in burn
    }
    assert by_label[("pub", "fast")] == pytest.approx(10.0)  # 100%/10% budget
    assert by_label[("fresh", "fast")] == 0.0
    assert "cruisecontrol_slo_compliance" in families
    assert "cruisecontrol_slo_evaluations_total" in families
    assert "cruisecontrol_slo_bad_samples_total" in families


def test_scheduler_feeds_urgent_queue_wait():
    from cruise_control_tpu_torch.fleet.scheduler import DeviceScheduler, WorkClass

    clock = Clock()
    reg = _registry(clock)
    reg.register(SloSpec(
        name="urgent-queue-wait", description="d", objective=0.99,
    ))
    sched = DeviceScheduler(slice_budget_s=0.5)
    sched.slo_registry = reg
    assert sched.run(WorkClass.URGENT, lambda: 42) == 42
    sched.run(WorkClass.BACKGROUND, lambda: None)  # background: no sample
    (state,) = reg.tick()
    assert state["samples"] == 1 and state["badSamples"] == 0


# ------------------------- the service's SLO surface (tests/test_slo.py :232-300)


def test_service_slo_surface():
    """The full wiring: a simulated service registers the SLO set, the
    cold-start sample lands on the first proposal, GET /slo serves the
    registry, /fleet carries the burn summary, and the exposition (with
    the slo gauges) lints clean over HTTP."""
    from cruise_control_tpu_torch.service.main import build_simulated_service
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fetcher, admin, sampler = build_simulated_service(seed=11, device="cpu")
    app.start()
    try:
        cc = app.cc
        assert cc.slo_registry is not None
        assert cc.slo_registry.names() == [
            "cold-start", "proposal-freshness", "streaming-publish",
        ]
        cc.proposals(OperationProgress())
        state = {s["name"]: s for s in cc.slo_registry.tick()}
        assert state["cold-start"]["samples"] == 1
        # a second proposal must not re-record the one-shot sample
        cc.proposals(OperationProgress(), ignore_cache=True)
        state = {s["name"]: s for s in cc.slo_registry.tick()}
        assert state["cold-start"]["samples"] == 1
        # the freshness probe sees the cached proposal: a good sample
        assert state["proposal-freshness"]["badSamples"] == 0
        base = f"http://{app.host}:{app.port}{app.prefix}"
        with urllib.request.urlopen(base + "/slo", timeout=30) as r:
            body = json.loads(r.read())
        assert body["numClusters"] == 1
        slos = {s["name"] for s in body["clusters"]["default"]["slos"]}
        assert "proposal-freshness" in slos
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            families = parse_exposition(r.read().decode())
        assert "cruisecontrol_slo_burn_rate" in families
        # /fleet rollup (single-cluster synthetic entry) carries the
        # per-SLO burn summary
        with urllib.request.urlopen(base + "/fleet", timeout=30) as r:
            fleet = json.loads(r.read())
        assert "proposal-freshness" in fleet["clusters"]["default"]["slo"]
    finally:
        app.stop()


def test_slo_disabled_leaves_no_registry():
    from cruise_control_tpu_torch.config.app_config import CruiseControlConfig
    from cruise_control_tpu_torch.service.main import build_simulated_service

    app, *_ = build_simulated_service(
        CruiseControlConfig({
            "webserver.http.port": 0, "slo.enabled": False,
        }),
        seed=12, device="cpu",
    )
    try:
        assert app.cc.slo_registry is None
        assert app.cc.sensors.get("slo.burn-rate") is None
    finally:
        app.stop()
