"""Sensor registry tests, pointed at the port: tests/test_sensors.py's
tests :18-:110 name for name against the port's common/sensors.py and
common/exposition.py, and its service test (:117) over the port's
simulated service."""

import math
import time

import pytest

from cruise_control_tpu_torch.common.sensors import (
    Counter,
    Gauge,
    Histogram,
    Meter,
    SensorRegistry,
    Timer,
)


def test_counter_and_gauge():
    reg = SensorRegistry()
    reg.counter("x").inc()
    reg.counter("x").inc(2)
    assert reg.counter("x").count == 3
    reg.gauge("g").set(1.5)
    assert reg.gauge("g").value == 1.5
    reg.gauge("cb", fn=lambda: 7.0)
    snap = reg.snapshot()
    assert snap["x"] == {"type": "counter", "count": 3}
    assert snap["cb"]["value"] == 7.0


def test_timer_statistics():
    t = Timer()
    for ms in (10, 20, 30):
        t.update(ms / 1e3)
    snap = t.snapshot()
    assert snap["count"] == 3
    assert abs(snap["meanMs"] - 20.0) < 1e-6
    assert snap["minMs"] <= snap["p50Ms"] <= snap["maxMs"]
    with t.time():
        time.sleep(0.01)
    assert t.count == 4


def test_meter_mtba():
    clock = iter([0.0, 1.0, 3.0, 10.0])
    m = Meter(clock=lambda: next(clock))
    assert m.mean_time_between_ms() == float("inf")
    m.mark()  # t=0
    m.mark()  # t=1
    m.mark()  # t=3
    # mean time between 3 events spanning 3s = 1500ms
    assert abs(m.mean_time_between_ms() - 1500.0) < 1e-6
    snap = m.snapshot()
    assert snap["count"] == 3


def test_histogram_quantile_interpolates():
    h = Histogram(buckets=(0.1, 1.0, 10.0))
    assert math.isnan(h.quantile(0.5))
    for v in (0.05, 0.3, 0.6, 2.0):
        h.observe(v)
    # rank 2 of 4 falls in the (0.1, 1.0] bucket: linear interpolation
    assert 0.1 < h.quantile(0.5) <= 1.0
    # the +Inf bucket answers its floor, never infinity
    h.observe(100.0)
    assert h.quantile(1.0) == 10.0
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_histogram_exemplars_latest_per_bucket():
    h = Histogram(buckets=(1.0, 10.0))
    h.observe(0.5, exemplar={"trace_id": "t1"})
    h.observe(0.7, exemplar={"trace_id": "t2"})  # same bucket: replaces
    h.observe(5.0)  # no exemplar: bucket stays empty
    ex = h.exemplars()
    assert len(ex) == 1
    bound, value, labels, ts = ex[0]
    assert bound == 1.0 and value == 0.7 and labels == {"trace_id": "t2"}
    assert ts > 0


def test_exposition_exemplars_openmetrics_only():
    from cruise_control_tpu_torch.common.exposition import (
        ExpositionError,
        parse_exposition,
        prometheus_text,
    )

    reg = SensorRegistry()
    reg.histogram("controller.window-roll-to-publish-seconds",
                  buckets=(1.0,)).observe(0.5, exemplar={"trace_id": "abc"})
    plain = prometheus_text(reg)
    assert " # " not in plain, "0.0.4 output must never carry exemplars"
    parse_exposition(plain)
    om = prometheus_text(reg, openmetrics=True)
    assert '# {trace_id="abc"} 0.5' in om
    assert om.rstrip().endswith("# EOF")
    fams = parse_exposition(om)
    assert "cruisecontrol_controller_window_roll_to_publish_seconds" in fams
    # lint: an exemplar on a non-bucket/counter sample is rejected
    bad = (
        "# TYPE g gauge\n"
        'g 1 # {trace_id="x"} 1\n'
    )
    with pytest.raises(ExpositionError, match="exemplar"):
        parse_exposition(bad)


def test_registry_get_never_creates():
    reg = SensorRegistry()
    assert reg.get("controller.window-roll-to-publish-seconds") is None
    h = reg.histogram("h", buckets=(1.0,))
    assert reg.get("h") is h


# ------------------------------------------- the service (tests/test_sensors.py :117)


def test_headline_sensors_reach_state_endpoint():
    """facade.state() must expose the (per-instance) sensor catalog under
    /state; a second service instance must not see the first's counters."""
    from cruise_control_tpu_torch.service.main import build_simulated_service

    app, fetcher, admin, sampler = build_simulated_service(seed=5, device="cpu")
    app2, *_ = build_simulated_service(seed=6, device="cpu")
    try:
        app.cc.sensors.timer("analyzer.proposal-computation-timer").update(0.5)
        out = app.cc.state()
        assert "Sensors" in out
        sensors = out["Sensors"]
        assert sensors["analyzer.proposal-computation-timer"]["count"] == 1
        assert "anomaly-detector.self-healing-enabled-ratio" in sensors
        # isolation: instance 2 never computed a proposal
        s2 = app2.cc.state()["Sensors"]
        assert "analyzer.proposal-computation-timer" not in s2
    finally:
        app.stop()
        app2.stop()
