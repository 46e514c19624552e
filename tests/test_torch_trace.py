"""Flight recorder + Prometheus exposition unit tests, pointed at the port.

tests/test_trace.py, name for name, against the port's stdlib copies
(common/trace.py, common/exposition.py, common/sensors.py) and its
common/profiling.py (torch.profiler in place of jax.profiler).
"""

import threading

import pytest

from cruise_control_tpu_torch.common.exposition import (
    CONTENT_TYPE,
    ExpositionError,
    metric_name,
    parse_exposition,
    prometheus_text,
)
from cruise_control_tpu_torch.common.sensors import (
    Collector,
    Histogram,
    SensorRegistry,
)
from cruise_control_tpu_torch.common.trace import NOOP_SPAN, Tracer


# ------------------------------------------------------------------ tracer


def test_span_lifecycle_and_attributes():
    tr = Tracer()
    with tr.span("analyzer.optimize", component="analyzer") as sp:
        sp.set(bucket="R3.B32.P2048.T16", engine_cache_hit=True)
        sp.event("round", n=1)
    assert sp.duration_s is not None and sp.duration_s >= 0
    j = sp.to_json()
    assert j["name"] == "analyzer.optimize"
    assert j["component"] == "analyzer"
    assert j["attributes"]["engine_cache_hit"] is True
    assert j["events"][0]["name"] == "round"
    assert j["events"][0]["offset_s"] >= 0
    assert not j["inFlight"]


def test_context_parentage_nests_spans():
    tr = Tracer()
    with tr.span("service.proposals") as root:
        with tr.span("monitor.cluster_model", component="monitor") as child:
            with tr.span("analyzer.optimize", component="analyzer") as grand:
                pass
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    assert grand.parent_id == child.span_id
    tree = tr.trace_tree(root.trace_id)
    assert len(tree) == 1
    assert tree[0]["name"] == "service.proposals"
    assert tree[0]["children"][0]["name"] == "monitor.cluster_model"
    assert tree[0]["children"][0]["children"][0]["name"] == "analyzer.optimize"


def test_root_flag_detaches_from_context():
    """A detector/recovery flow must not attach to whatever request
    context its thread inherited."""
    tr = Tracer()
    with tr.span("service.rebalance") as req:
        with tr.span("detector.handle", root=True) as det:
            pass
    assert det.parent_id is None
    assert det.trace_id != req.trace_id


def test_explicit_trace_id_propagates_cross_thread():
    """The purgatory hands the pool thread an explicit trace id (context
    vars do not cross threads)."""
    tr = Tracer()
    tid = tr.new_trace_id()
    out = {}

    def work():
        with tr.span("service.rebalance", trace_id=tid, root=True) as sp:
            with tr.span("analyzer.optimize", component="analyzer"):
                pass
            out["span"] = sp

    t = threading.Thread(target=work)
    t.start()
    t.join()
    spans = tr.trace(tid)
    assert len(spans) == 2
    assert {s.trace_id for s in spans} == {tid}


def test_disabled_tracer_hands_out_noop():
    tr = Tracer(enabled=False)
    with tr.span("anything") as sp:
        sp.set(x=1)
        sp.event("e")
    assert sp is NOOP_SPAN
    assert tr._all_spans() == []
    # a noop parent never leaks into a real tracer's spans
    assert tr.current() is None


def test_error_recorded_and_reraised():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("service.rebalance") as sp:
            raise RuntimeError("boom")
    assert sp.error is not None and "boom" in sp.error
    assert sp.duration_s is not None


def test_ring_retention_is_per_component():
    tr = Tracer(retention_per_component=4)
    for i in range(10):
        tr.start_span(f"device.op{i}", component="device", root=True).finish()
    keeper = tr.start_span("executor.execution", component="executor", root=True)
    keeper.finish()
    spans = tr._all_spans()
    assert sum(1 for s in spans if s.component == "device") == 4
    # the chatty device ring never evicted the executor's span
    assert any(s.component == "executor" for s in spans)


def test_event_bound_counts_drops():
    tr = Tracer(max_events_per_span=8)
    sp = tr.start_span("executor.execution", component="executor", root=True)
    for i in range(20):
        sp.event("task", n=i)
    sp.finish()
    assert len(sp.events) == 8
    assert sp.events_dropped == 12
    assert sp.to_json()["eventsDropped"] == 12


def test_in_flight_span_visible_immediately():
    """Crash tolerance: a span is published at START, so a live poll shows
    the frontier and a hung stage never vanishes."""
    tr = Tracer()
    sp = tr.start_span("device.engine-run", component="device", root=True)
    [j] = [s.to_json() for s in tr.trace(sp.trace_id)]
    assert j["inFlight"] is True
    assert j["durationMs"] is None
    sp.finish()


def test_orphaned_span_surfaces_as_extra_root():
    """A child whose parent aged out of its ring still appears in the
    tree (as a root) instead of disappearing."""
    tr = Tracer(retention_per_component=1)
    parent = tr.start_span("service.op", component="service", root=True)
    child = tr.start_span("device.op", component="device", parent=parent)
    child.finish()
    parent.finish()
    # evict the parent from the service ring
    tr.start_span("service.other", component="service", root=True).finish()
    tree = tr.trace_tree(parent.trace_id)
    assert [n["name"] for n in tree] == ["device.op"]


def test_recent_traces_and_summary():
    tr = Tracer()
    with tr.span("service.rebalance") as root:
        with tr.span("analyzer.optimize", component="analyzer"):
            pass
        with tr.span("analyzer.optimize", component="analyzer"):
            pass
    recent = tr.recent_traces()
    assert recent[0]["traceId"] == root.trace_id
    assert recent[0]["name"] == "service.rebalance"
    summary = tr.summarize(root.trace_id)
    assert summary["analyzer.optimize"]["count"] == 2
    assert summary["analyzer.optimize"]["totalMs"] >= 0
    assert summary["service.rebalance"]["count"] == 1


def test_tracer_validates_bounds():
    with pytest.raises(ValueError):
        Tracer(retention_per_component=0)
    with pytest.raises(ValueError):
        Tracer(max_events_per_span=0)


# ------------------------------------------------- histogram + collector


def test_histogram_buckets_cumulative():
    h = Histogram(buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    cum, total, n = h.cumulative()
    assert n == 5
    assert abs(total - 56.05) < 1e-9
    assert cum == [(0.1, 1), (1.0, 3), (10.0, 4), (float("inf"), 5)]
    snap = h.snapshot()
    assert snap["type"] == "histogram"
    assert snap["buckets"][-1] == {"le": "+Inf", "count": 5}


def test_histogram_boundary_value_lands_in_its_bucket():
    # le is INCLUSIVE (Prometheus convention): observe(1.0) counts in le=1.0
    h = Histogram(buckets=(1.0, 2.0))
    h.observe(1.0)
    cum, _, _ = h.cumulative()
    assert cum[0] == (1.0, 1)


def test_histogram_rejects_bad_buckets():
    with pytest.raises(ValueError):
        Histogram(buckets=())
    with pytest.raises(ValueError):
        Histogram(buckets=(1.0, 1.0))


def test_collector_labels_and_failing_callback():
    c = Collector(lambda: [({"bucket": "a"}, 1.5), ({"bucket": "b"}, 2.5)])
    assert c.values() == [({"bucket": "a"}, 1.5), ({"bucket": "b"}, 2.5)]

    def boom():
        raise RuntimeError("no")

    assert Collector(boom).values() == []


def test_registry_histogram_and_collector_in_snapshot():
    reg = SensorRegistry()
    reg.histogram("analyzer.proposal-computation-seconds").observe(0.2)
    reg.collector("tpu.device.memory-by-device",
                  lambda: [({"device": "0"}, 123.0)])
    snap = reg.snapshot()
    assert snap["analyzer.proposal-computation-seconds"]["count"] == 1
    assert snap["tpu.device.memory-by-device"]["values"] == [
        {"labels": {"device": "0"}, "value": 123.0}
    ]


# ------------------------------------------------------------ exposition


def test_metric_name_sanitization():
    assert metric_name("analyzer.engine-cache-hits") == (
        "cruisecontrol_analyzer_engine_cache_hits"
    )
    assert metric_name("x", namespace="") == "x"
    assert metric_name("0bad", namespace="") == "_0bad"


def test_prometheus_text_round_trips_through_the_lint_parser():
    reg = SensorRegistry()
    reg.counter("analyzer.engine-cache-hits").inc(3)
    reg.gauge("analyzer.engine-cache-size").set(2.0)
    t = reg.timer("monitor.cluster-model-creation-timer")
    t.update(0.05)
    t.update(0.07)
    reg.meter("anomaly-detector.mean-time-between-anomalies").mark()
    h = reg.histogram("analyzer.proposal-computation-seconds")
    h.observe(0.3)
    h.observe(7.0)
    reg.collector(
        "tpu.device.memory-by-device",
        lambda: [({"device": "0", "platform": "cpu"}, 1024.0)],
    )
    text = prometheus_text(reg)
    assert text.endswith("\n")
    fams = parse_exposition(text)
    assert fams["cruisecontrol_analyzer_engine_cache_hits_total"]["type"] == "counter"
    assert fams["cruisecontrol_analyzer_engine_cache_hits_total"]["samples"][0][2] == 3.0
    summary = fams["cruisecontrol_monitor_cluster_model_creation_timer_seconds"]
    assert summary["type"] == "summary"
    names = [s[0] for s in summary["samples"]]
    assert "cruisecontrol_monitor_cluster_model_creation_timer_seconds_count" in names
    hist = fams["cruisecontrol_analyzer_proposal_computation_seconds"]
    assert hist["type"] == "histogram"
    dev = fams["cruisecontrol_tpu_device_memory_by_device"]
    assert dev["samples"][0][1] == {"device": "0", "platform": "cpu"}


def test_exposition_label_escaping():
    reg = SensorRegistry()
    reg.collector(
        "planner.weird",
        lambda: [({"name": 'a"b\\c\nnewline'}, 1.0)],
    )
    text = prometheus_text(reg)
    fams = parse_exposition(text)
    assert fams["cruisecontrol_planner_weird"]["samples"][0][1]["name"] == (
        'a"b\\c\nnewline'
    )


def test_exposition_detects_family_collision():
    reg = SensorRegistry()
    reg.counter("a.b").inc()
    reg.counter("a-b").inc()
    with pytest.raises(ValueError, match="sanitize to the same"):
        prometheus_text(reg)


def test_lint_rejects_sample_without_type():
    with pytest.raises(ExpositionError, match="no preceding TYPE"):
        parse_exposition("orphan_metric 1\n")


def test_lint_rejects_duplicate_type_and_bad_counter_name():
    with pytest.raises(ExpositionError, match="duplicate TYPE"):
        parse_exposition(
            "# TYPE x_total counter\n# TYPE x_total counter\nx_total 1\n"
        )
    with pytest.raises(ExpositionError, match="must end in _total"):
        parse_exposition("# TYPE x counter\nx 1\n")


def test_lint_rejects_negative_counter_and_bad_value():
    with pytest.raises(ExpositionError, match="negative"):
        parse_exposition("# TYPE x_total counter\nx_total -1\n")
    with pytest.raises(ExpositionError, match="unparseable value"):
        parse_exposition("# TYPE g gauge\ng notanumber\n")


def test_lint_rejects_nonmonotonic_histogram():
    body = (
        "# TYPE h histogram\n"
        'h_bucket{le="1"} 5\n'
        'h_bucket{le="+Inf"} 3\n'
        "h_sum 1\nh_count 3\n"
    )
    with pytest.raises(ExpositionError, match="decreases"):
        parse_exposition(body)


def test_lint_rejects_inf_bucket_count_mismatch():
    body = (
        "# TYPE h histogram\n"
        'h_bucket{le="1"} 1\n'
        'h_bucket{le="+Inf"} 3\n'
        "h_sum 1\nh_count 4\n"
    )
    with pytest.raises(ExpositionError, match="!= _count"):
        parse_exposition(body)


def test_content_type_is_prometheus_text():
    assert "text/plain" in CONTENT_TYPE and "0.0.4" in CONTENT_TYPE


# ------------------------------------------------------------- profiling


def test_profiler_trace_noop_without_dir():
    from cruise_control_tpu_torch.common.profiling import profiler_trace

    ran = []
    with profiler_trace(None):
        ran.append(1)
    with profiler_trace(""):
        ran.append(2)
    assert ran == [1, 2]


def test_profiler_trace_survives_unwritable_dir():
    """A profiler that cannot start must never fail the run it observes."""
    from cruise_control_tpu_torch.common.profiling import profiler_trace

    ran = []
    with profiler_trace("/proc/definitely-not-writable/x"):
        ran.append(1)
    assert ran == [1]


def test_device_gauges_register_and_read():
    from cruise_control_tpu_torch.common.profiling import register_device_gauges

    reg = SensorRegistry()
    register_device_gauges(reg)
    snap = reg.snapshot()
    for name in (
        "tpu.device.memory-in-use-bytes",
        "tpu.device.memory-limit-bytes",
        "tpu.device.live-buffers",
        "tpu.device.memory-by-device",
    ):
        assert name in snap
    # CPU backend: values are numbers (0.0 where no stats), never raising
    assert isinstance(snap["tpu.device.live-buffers"]["value"], float)
