"""The JAX package's tests/test_integration.py, pointed at the port on the CPU.

Full-stack embedded integration test.

The one test that closes every seam at once, the role of the reference's
CruiseControlIntegrationTestHarness (cruise-control/src/test/java/com/
linkedin/kafka/cruisecontrol/CruiseControlIntegrationTestHarness.java:1-30)
+ ExecutorTest's embedded-cluster runs:

  per-broker MetricsReporter -> KafkaMetricsTransport (wire produce)
    -> fake_kafka reporter topic (live sockets)
    -> CruiseControlMetricsReporterSampler (wire fetch, columnar decode)
    -> MetricFetcherManager -> WindowedMetricSampleAggregator
    -> LoadMonitor -> REST POST /rebalance?dryrun=false
    -> Executor -> KafkaClusterAdmin.AlterPartitionReassignments
    -> fake_kafka topology CHANGES
  and the KafkaSampleStore replays the same history into a fresh
  aggregator ("restart") without re-sampling.

Each seam has its own contract test elsewhere; this exists to catch
cross-seam wiring drift.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from cruise_control_tpu_torch.config.app_config import CruiseControlConfig
from cruise_control_tpu_torch.kafka import KafkaAdminClient
from cruise_control_tpu_torch.kafka.sample_store import KafkaSampleStore
from cruise_control_tpu_torch.kafka.transport import (
    KafkaMetricsConsumer,
    KafkaMetricsTransport,
)
from cruise_control_tpu_torch.monitor.reporter_sampler import (
    CruiseControlMetricsReporterSampler,
)
from cruise_control_tpu_torch.reporter.metrics import MetricType
from cruise_control_tpu_torch.reporter.reporter import (
    MetricsRegistrySnapshotter,
    MetricsReporter,
)
from cruise_control_tpu_torch.testing.fake_kafka import FakeKafkaCluster

WINDOW_MS = 60_000
METRICS_TOPIC = "__CruiseControlMetrics"


def _skewed_cluster() -> FakeKafkaCluster:
    """4 brokers / 2 racks; every replica packed onto brokers 0+1 (brokers
    2 and 3 idle) — a blatant distribution violation the rebalance must fix."""
    parts = {}
    for t, n in (("T0", 8), ("T1", 8)):
        parts[t] = [
            {"partition": p, "leader": p % 2, "replicas": [p % 2, 1 - p % 2]}
            for p in range(n)
        ]
    # the reporter topic exists up front, as on a real cluster
    parts[METRICS_TOPIC] = [
        {"partition": p, "leader": p % 4, "replicas": [p % 4]} for p in range(4)
    ]
    return FakeKafkaCluster(
        brokers={
            0: {"rack": "r0"}, 1: {"rack": "r1"},
            2: {"rack": "r0"}, 3: {"rack": "r1"},
        },
        topics=parts,
    )


def _broker_metric_source(cluster: FakeKafkaCluster, broker_id: int):
    """Live per-broker metrics view: sizes/rates follow the CURRENT fake
    topology (what a real broker's metrics registry would show)."""

    def source():
        topics: dict = {}
        partitions: dict = {}
        for t, pmap in cluster.topics.items():
            led = [p for p in pmap.values() if p["leader"] == broker_id]
            for p in led:
                # partition p of topic t: deterministic size, heavier for T0
                size = 1000.0 * (p["partition"] + 1) * (2.0 if t == "T0" else 1.0)
                partitions[(t, p["partition"])] = size
            if led:
                topics[t] = {
                    MetricType.TOPIC_BYTES_IN: 500.0 * len(led),
                    MetricType.TOPIC_BYTES_OUT: 800.0 * len(led),
                }
        return {
            "broker": {
                MetricType.BROKER_CPU_UTIL: 10.0 + 5.0 * len(partitions),
                MetricType.BROKER_PRODUCE_REQUEST_RATE: 100.0,
            },
            "topics": topics,
            "partitions": partitions,
        }

    return source


@pytest.mark.slow
def test_full_stack_reporter_to_executor_round_trip():
    cluster = _skewed_cluster().start()
    clients: list[KafkaAdminClient] = []

    def new_client() -> KafkaAdminClient:
        c = KafkaAdminClient(cluster.bootstrap(), timeout_s=10.0)
        clients.append(c)
        return c

    try:
        # --- reporter side: one agent per broker over the wire ---
        reporter_client = new_client()
        transport = KafkaMetricsTransport(reporter_client, METRICS_TOPIC)
        reporters = [
            MetricsReporter(
                MetricsRegistrySnapshotter(b, _broker_metric_source(cluster, b)),
                transport,
            )
            for b in range(4)
        ]

        # --- service side: sampler consumes the reporter topic ---
        from cruise_control_tpu_torch.service.main import build_kafka_service

        service_client = new_client()
        sample_store = KafkaSampleStore(
            new_client(),
            topic_name_fn={0: "T0", 1: "T1"}.__getitem__,
            topic_id_fn={"T0": 0, "T1": 1}.__getitem__,
        )
        import tempfile

        journal_dir = tempfile.mkdtemp(prefix="ledger-integ-")
        config = CruiseControlConfig({
            "num.partition.metrics.windows": "2",
            "partition.metrics.window.ms": str(WINDOW_MS),
            "min.samples.per.partition.metrics.window": "1",
            "num.broker.metrics.windows": "2",
            "broker.metrics.window.ms": str(WINDOW_MS),
            "webserver.http.port": "0",
            # durable surfaces: the execution journal + the decision
            # ledger (derived beneath it) record this rebalance's episode
            "executor.journal.dir": journal_dir,
            "tpu.prewarm.enabled": "false",
        })
        from cruise_control_tpu_torch.kafka import KafkaMetadataProvider

        metadata_for_sampler = KafkaMetadataProvider(new_client())
        sampler = CruiseControlMetricsReporterSampler(
            KafkaMetricsConsumer(service_client, METRICS_TOPIC),
            metadata_for_sampler.topology,
        )
        app, fetcher, admin, client = build_kafka_service(
            config, f"127.0.0.1:{cluster.bootstrap()[0][1]}", sampler,
            sample_store=sample_store, device="cpu",
        )
        clients.append(client)

        # --- drive three sampling windows through every seam ---
        parts_fn = app.cc.task_runner.partitions_fn
        entities = parts_fn()
        assert len(entities) == 16
        for w in range(3):
            t_mid = w * WINDOW_MS + WINDOW_MS // 2
            for r in reporters:
                r.report_once(now_ms=t_mid)
            n = fetcher.fetch_once(entities, w * WINDOW_MS, (w + 1) * WINDOW_MS - 1)
            assert n > 0, f"window {w} absorbed no samples"
        # the sampler interned topics in the declared order
        assert sampler._topic_ids == {"T0": 0, "T1": 1}

        # --- REST rebalance, non-dryrun, against the live fake cluster ---
        app.start()
        base = f"http://{app.host}:{app.port}{app.prefix}"

        def req(method, ep, headers=None, **params):
            q = "&".join(f"{k}={v}" for k, v in params.items())
            r = urllib.request.Request(
                f"{base}/{ep}" + (f"?{q}" if q else ""),
                method=method, headers=headers or {},
            )
            with urllib.request.urlopen(r, timeout=120) as resp:
                return resp.status, json.loads(resp.read()), dict(resp.headers)

        def workload_placement():
            return {
                (t, p["partition"]): tuple(p["replicas"])
                for t, pmap in cluster.topics.items()
                if t in ("T0", "T1")
                for p in pmap.values()
            }

        before = workload_placement()
        assert not any(
            2 in r or 3 in r for r in before.values()
        ), "fixture must start with brokers 2/3 empty"

        cluster.auto_complete_after(2)
        status, payload, headers = req("POST", "rebalance", dryrun="false")
        tid = headers.get("User-Task-ID")
        deadline = time.time() + 180
        while status == 202 and time.time() < deadline:
            time.sleep(0.5)
            status, payload, headers = req(
                "POST", "rebalance", headers={"User-Task-ID": tid}, dryrun="false"
            )
        assert status == 200, payload
        assert payload["numReplicaMovements"] > 0
        assert payload["balancednessAfter"] >= payload["balancednessBefore"]
        if "execution" in payload:
            assert payload["execution"]["dead"] == 0

        after = workload_placement()
        assert after != before, "executor must have changed the fake topology"
        touched_brokers = {b for r in after.values() for b in r}
        assert {2, 3} & touched_brokers, "idle brokers must have received replicas"
        # executor really went through the admin path
        st, state, _ = req("GET", "state", substates="executor")
        assert state["ExecutorState"]["numFinishedMovements"] > 0

        # --- flight recorder: ONE trace id covers the whole pipeline ---
        trace_id = payload.get("_traceId")
        assert trace_id, "rebalance response must carry _traceId"
        st, trace, _ = req("GET", "trace", id=trace_id)
        assert st == 200 and trace["traceId"] == trace_id

        def flatten(nodes):
            out = []
            for n in nodes:
                out.append(n)
                out.extend(flatten(n["children"]))
            return out

        spans = flatten(trace["spans"])
        assert {s["traceId"] for s in spans} == {trace_id}
        by_name = {}
        for s in spans:
            by_name.setdefault(s["name"], s)
        # root: the submitted operation
        assert by_name["service.rebalance"]["parentId"] is None
        # stage 1: monitor model build
        assert "monitor.cluster_model" in by_name
        # stage 2: engine run with the timing record as attributes
        opt_attrs = by_name["analyzer.optimize"]["attributes"]
        assert "device_s" in opt_attrs
        assert "engine_cache_hit" in opt_attrs
        assert "bucket" in opt_attrs
        # stage 3: the supervised device op
        assert by_name["device.optimize"]["component"] == "device"
        # stage 4: execution, with EVERY task transition as span events
        exc = by_name["executor.execution"]
        task_events = [e for e in exc["events"] if e["name"] == "task"]
        ids_seen = {e["id"] for e in task_events}
        assert len(ids_seen) == exc["attributes"]["num_tasks"]
        completed = {
            e["id"] for e in task_events if e["state"] == "COMPLETED"
        }
        assert completed == ids_seen, "every task must reach COMPLETED"
        assert exc["attributes"]["completed"] == len(ids_seen)

        # --- decision ledger: the executed rebalance is one joined
        # decision -> outcome episode, calibrated once the next complete
        # metric window measures the post-move cluster, and GET /explain
        # replays it (analyzer/ledger.py acceptance story) ---
        cc = app.cc
        assert cc.ledger is not None
        episode = cc.ledger.entries(limit=10)
        executed = [e for e in episode if e["outcome"] is not None]
        assert executed, "the executed rebalance must have joined an outcome"
        entry = executed[0]
        did = entry["decision"]["id"]
        assert entry["decision"]["goals"]["names"] == cc.chain.names()
        assert entry["decision"]["convergence"]["rounds"] >= 1
        assert entry["outcome"]["completed"] == exc["attributes"]["completed"]
        # roll the NEXT complete metric window, then calibrate
        t_mid = 3 * WINDOW_MS + WINDOW_MS // 2
        for rep in reporters:
            rep.report_once(now_ms=t_mid)
        fetcher.fetch_once(entities, 3 * WINDOW_MS, 4 * WINDOW_MS - 1)
        cc._detect_model_drift()
        entry = cc.ledger.find(decision_id=did)
        assert entry["calibration"] is not None
        assert entry["calibration"]["error"]["goalMaxAbs"] >= 0.0
        st, explained, _ = req("GET", "explain", proposal=did)
        assert st == 200 and explained["decisionId"] == did
        assert explained["outcome"]["completed"] > 0
        assert explained["calibration"] is not None

        # --- Prometheus exposition over the live service ---
        from cruise_control_tpu_torch.common.exposition import parse_exposition

        r = urllib.request.Request(f"{base}/metrics")
        with urllib.request.urlopen(r, timeout=30) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            fams = parse_exposition(resp.read().decode())
        assert "cruisecontrol_executor_execution_started_total" in fams

        # --- scenario planner against the live fake cluster ---
        def poll(method, ep, **params):
            s, p, h = req(method, ep, **params)
            t_id = h.get("User-Task-ID")
            dl = time.time() + 180
            while s == 202 and time.time() < dl:
                time.sleep(0.5)
                s, p, _ = req(method, ep, headers={"User-Task-ID": t_id}, **params)
            return s, p

        placement_before_planning = workload_placement()
        # compact separators: the raw-URL helper does not percent-encode
        scenarios = json.dumps([
            {"name": "lose-a-broker", "removeBrokers": [3]},
            {"name": "add-two", "addBrokers": [{"count": 2}]},
            {"name": "t0-doubles", "topicLoadFactors": {"T0": 2.0}},
        ], separators=(",", ":"))
        status, sim = poll("POST", "simulate", scenarios=scenarios, optimize="true")
        assert status == 200, sim
        from cruise_control_tpu_torch.service.schemas import validate_response

        assert validate_response("simulate", sim) == []
        by_name = {s["name"]: s for s in sim["scenarios"]}
        base_alive = sim["baseline"]["brokersAlive"]
        assert by_name["lose-a-broker"]["brokersAlive"] == base_alive - 1
        assert by_name["add-two"]["brokersAlive"] == base_alive + 2
        assert by_name["t0-doubles"]["objective"] >= sim["baseline"]["objective"]
        assert by_name["lose-a-broker"]["fix"]["numReplicaMovements"] > 0

        status, rsz = poll("GET", "rightsize")
        assert status == 200, rsz
        assert validate_response("rightsize", rsz) == []
        assert rsz["currentBrokers"] == base_alive
        assert rsz["provisionStatus"] in (
            "RIGHT_SIZED", "OVER_PROVISIONED", "UNDER_PROVISIONED", "UNDECIDED"
        )
        # planning is READ-ONLY: the fake cluster's placement is untouched
        assert workload_placement() == placement_before_planning

        # --- "restart": replay the sample store into a FRESH aggregator ---
        from cruise_control_tpu_torch.monitor import (
            KAFKA_METRIC_DEF,
            MetricFetcherManager,
            WindowedMetricSampleAggregator,
        )

        fresh_agg = WindowedMetricSampleAggregator(
            num_windows=2, window_ms=WINDOW_MS, min_samples_per_window=1,
            metric_def=KAFKA_METRIC_DEF,
        )
        fresh_store = KafkaSampleStore(
            new_client(),
            topic_name_fn={0: "T0", 1: "T1"}.__getitem__,
            topic_id_fn={"T0": 0, "T1": 1}.__getitem__,
        )
        fresh_fetcher = MetricFetcherManager(
            sampler, fresh_agg, None, sample_store=fresh_store
        )
        replayed = fresh_fetcher.load_samples()
        assert replayed > 0
        res = fresh_agg.aggregate()
        assert res.values.shape[1] >= 2  # both completed windows restored
        assert bool(np.any(res.window_valid))

        app.stop()
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        cluster.stop()


@pytest.mark.slow
def test_live_socket_self_healing_broker_crash():
    """Chaos through the live-socket stack (reference RandomSelfHealingTest
    + ExecutorTest-with-killed-embedded-brokers semantics,
    detector/BrokerFailureDetector.java:44):

      kill a fake broker mid-run -> metadata stops listing it (its replica
      assignments remain) -> the SERVICE'S OWN BrokerFailureDetector loop
      fires -> SelfHealingNotifier FIXes -> remove_brokers runs through the
      real facade/optimizer/executor/admin path over sockets -> every
      workload replica is evacuated off the crashed broker.
    """
    parts = {}
    for t in ("T0", "T1"):
        parts[t] = [
            {"partition": p, "leader": p % 4, "replicas": [p % 4, (p + 1) % 4]}
            for p in range(8)
        ]
    # metrics topic lives on broker 0 only: the crash must not orphan it
    parts[METRICS_TOPIC] = [{"partition": 0, "leader": 0, "replicas": [0]}]
    cluster = FakeKafkaCluster(
        brokers={
            0: {"rack": "r0"}, 1: {"rack": "r1"},
            2: {"rack": "r0"}, 3: {"rack": "r1"},
        },
        topics=parts,
    ).start()
    clients: list[KafkaAdminClient] = []

    def new_client() -> KafkaAdminClient:
        c = KafkaAdminClient(cluster.bootstrap(), timeout_s=10.0)
        clients.append(c)
        return c

    try:
        reporter_client = new_client()
        transport = KafkaMetricsTransport(reporter_client, METRICS_TOPIC)
        reporters = [
            MetricsReporter(
                MetricsRegistrySnapshotter(b, _broker_metric_source(cluster, b)),
                transport,
            )
            for b in range(4)
        ]

        from cruise_control_tpu_torch.service.main import build_kafka_service

        config = CruiseControlConfig({
            "num.partition.metrics.windows": "2",
            "partition.metrics.window.ms": str(WINDOW_MS),
            "min.samples.per.partition.metrics.window": "1",
            "num.broker.metrics.windows": "2",
            "broker.metrics.window.ms": str(WINDOW_MS),
            "webserver.http.port": "0",
            "execution.progress.check.interval.ms": "200",
            # self-healing: fire immediately on a detected broker failure
            "self.healing.broker.failure.enabled": "true",
            "broker.failure.alert.threshold.ms": "0",
            "broker.failure.self.healing.threshold.ms": "0",
            "anomaly.detection.interval.ms": "500",
        })
        from cruise_control_tpu_torch.kafka import KafkaMetadataProvider

        sampler = CruiseControlMetricsReporterSampler(
            KafkaMetricsConsumer(new_client(), METRICS_TOPIC),
            KafkaMetadataProvider(new_client()).topology,
        )
        app, fetcher, admin, client = build_kafka_service(
            config, f"127.0.0.1:{cluster.bootstrap()[0][1]}", sampler, device="cpu",
        )
        clients.append(client)

        entities = app.cc.task_runner.partitions_fn()
        assert len(entities) == 16
        for w in range(3):
            t_mid = w * WINDOW_MS + WINDOW_MS // 2
            for r in reporters:
                r.report_once(now_ms=t_mid)
            n = fetcher.fetch_once(entities, w * WINDOW_MS, (w + 1) * WINDOW_MS - 1)
            assert n > 0

        def workload_replicas_on(broker_id: int) -> int:
            return sum(
                broker_id in p["replicas"]
                for t in ("T0", "T1")
                for p in cluster.topics[t].values()
            )

        assert workload_replicas_on(3) > 0

        app.start()
        # reassignments complete after a couple of executor progress polls
        cluster.auto_complete_after(2)
        # the service's own detection loop (not a test harness calling
        # detect()) must notice the crash and drive the fix
        app.cc.start_up(detection_interval_s=0.5)

        cluster.kill_broker(3)

        # evacuated AND the execution drained (the fix compiles a fresh
        # engine for the post-failure shape: allow several minutes on CPU)
        deadline = time.time() + 420
        while time.time() < deadline and (
            workload_replicas_on(3) > 0 or app.cc.executor.has_ongoing_execution
        ):
            time.sleep(0.5)
        det_state = app.cc.anomaly_detector.state.to_json(app.cc.notifier)
        assert workload_replicas_on(3) == 0, (
            f"self-healing did not evacuate the crashed broker; detector "
            f"state: {det_state}"
        )

        # the fix went through the real anomaly pipeline and the executor
        recent = det_state["recentAnomalies"].get("BROKER_FAILURE", [])
        assert any(r["status"].startswith("FIX") for r in recent), det_state
        assert app.cc.executor.tracker.tasks(), "executor executed no tasks"
        # survivors only, and leadership everywhere is on live brokers
        for t in ("T0", "T1"):
            for p in cluster.topics[t].values():
                assert 3 not in p["replicas"]
                assert p["leader"] in (0, 1, 2)

        app.cc.shutdown()
        app.stop()
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        cluster.stop()
