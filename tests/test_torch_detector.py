"""The port's detectors, notifier and self-healing loop on the CPU.

tests/test_detector.py's tests, pointed at the port (the models and the
optimizer on the CPU):
test_goal_violation_detector_on_unbalanced_cluster,
test_broker_failure_detector_persists_times, test_disk_failure_detector,
test_slow_broker_finder_peer_and_history, test_topic_rf_finder,
test_self_healing_notifier_broker_failure_thresholds,
test_detector_dispatch_and_busy_backoff,
test_self_healing_end_to_end_dead_broker and
test_slow_broker_finder_requires_majority_of_metric_families.
At the end, test_slow_broker_detector_wired_into_service (:274), over
the port's simulated service.  Also tests/test_faults.py's
test_detector_loop_survives_handler_exceptions.

Dead brokers must end with their replicas rebuilt elsewhere, as in the
reference's RandomSelfHealingTest.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu_torch.detector import (
    Action,
    AnomalyDetector,
    AnomalyType,
    BrokerFailureDetector,
    BrokerFailures,
    DiskFailureDetector,
    GoalViolationDetector,
    GoalViolations,
    SelfHealingNotifier,
    SlowBrokerFinder,
    TopicReplicationFactorAnomalyFinder,
)
from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN
from cruise_control_tpu_torch.monitor.topology import (
    BrokerNode,
    ClusterTopology,
    PartitionInfo,
    StaticMetadataProvider,
)
from cruise_control_tpu_torch.testing.fixtures import (
    RandomClusterSpec,
    random_cluster,
    small_cluster,
)


class RecordingActions:
    def __init__(self, busy=False):
        self.calls = []
        self.busy = busy

    def rebalance(self, reason):
        self.calls.append(("rebalance", reason))
        return True

    def remove_brokers(self, broker_ids, reason):
        self.calls.append(("remove_brokers", tuple(broker_ids)))
        return True

    def demote_brokers(self, broker_ids, reason):
        self.calls.append(("demote_brokers", tuple(broker_ids)))
        return True

    def fix_offline_replicas(self, reason):
        self.calls.append(("fix_offline_replicas",))
        return True

    def fix_topic_replication_factor(self, topics, target_rf, reason):
        self.calls.append(("fix_rf", tuple(sorted(topics)), target_rf))
        return True

    @property
    def is_busy(self):
        return self.busy


def topo(dead=(), offline_logdirs=None, rf=2):
    offline_logdirs = offline_logdirs or {}
    brokers = tuple(
        BrokerNode(
            i,
            rack=f"r{i % 2}",
            host=f"h{i}",
            alive=i not in dead,
            offline_logdirs=tuple(offline_logdirs.get(i, ())),
        )
        for i in range(4)
    )
    parts = tuple(
        PartitionInfo("T0", p, leader=p % 4, replicas=tuple((p + i) % 4 for i in range(rf)))
        for p in range(8)
    )
    return ClusterTopology(brokers=brokers, partitions=parts)


def test_goal_violation_detector_on_unbalanced_cluster():
    det = GoalViolationDetector(lambda: small_cluster("cpu"), DEFAULT_CHAIN)
    v = det.detect()
    assert v is not None and v.fixable_violations
    # balanced-enough random cluster: optimizer output should not flag hard goals
    state = random_cluster(RandomClusterSpec(num_brokers=8, num_partitions=100), seed=1, device="cpu")
    v2 = GoalViolationDetector(lambda: state, DEFAULT_CHAIN).detect()
    if v2 is not None:
        assert "RackAwareGoal" not in v2.unfixable_violations


def test_broker_failure_detector_persists_times(tmp_path):
    clock = {"now": 1000}
    p = str(tmp_path / "failed.json")
    provider = {"topo": topo(dead=(3,))}
    det = BrokerFailureDetector(
        lambda: provider["topo"], persist_path=p, now_ms=lambda: clock["now"]
    )
    a = det.detect()
    assert isinstance(a, BrokerFailures) and a.failed_brokers == {3: 1000}
    # restart: failure time must survive (reference ZK-persisted times :123-127)
    clock["now"] = 5000
    det2 = BrokerFailureDetector(
        lambda: provider["topo"], persist_path=p, now_ms=lambda: clock["now"]
    )
    a2 = det2.detect()
    assert a2.failed_brokers == {3: 1000}
    # broker recovers -> anomaly clears and persistence resets
    provider["topo"] = topo(dead=())
    assert det2.detect() is None
    det3 = BrokerFailureDetector(
        lambda: provider["topo"], persist_path=p, now_ms=lambda: clock["now"]
    )
    assert det3.detect() is None


def test_disk_failure_detector():
    det = DiskFailureDetector(lambda: topo(offline_logdirs={1: ["/d2"]}))
    a = det.detect()
    assert a is not None and a.failed_disks == {1: ["/d2"]}
    assert DiskFailureDetector(lambda: topo()).detect() is None


def test_slow_broker_finder_peer_and_history():
    finder = SlowBrokerFinder(peer_ratio=2.0, removal_threshold=3)
    normal = {0: 10.0, 1: 12.0, 2: 11.0, 3: 9.0}
    for _ in range(5):
        assert finder.detect(normal) is None
    slow = {**normal, 2: 100.0}
    a = finder.detect(slow)
    assert a is not None and 2 in a.slow_brokers and not a.remove_slow_brokers
    finder.detect(slow)
    a3 = finder.detect(slow)
    assert a3 is not None and a3.remove_slow_brokers  # escalates after strikes


def test_topic_rf_finder():
    det = TopicReplicationFactorAnomalyFinder(lambda: topo(rf=1), target_rf=2)
    a = det.detect()
    assert a is not None and a.bad_topics == {"T0": 1}


def test_self_healing_notifier_broker_failure_thresholds():
    clock = {"now": 0}
    n = SelfHealingNotifier(
        self_healing={AnomalyType.BROKER_FAILURE: True},
        broker_failure_alert_threshold_ms=1000,
        broker_failure_self_healing_threshold_ms=2000,
        now_ms=lambda: clock["now"],
    )
    anomaly = BrokerFailures(failed_brokers={3: 0})
    clock["now"] = 500  # before alert threshold
    r = n.on_anomaly(anomaly)
    assert r.action == Action.CHECK and r.delay_ms == 500
    clock["now"] = 1500  # alert, but not yet heal
    r = n.on_anomaly(anomaly)
    assert r.action == Action.CHECK and n.alerts[-1][1] is False
    clock["now"] = 2500  # past self-healing threshold
    r = n.on_anomaly(anomaly)
    assert r.action == Action.FIX and n.alerts[-1][1] is True
    # healing disabled -> IGNORE at fix time
    n.set_self_healing(AnomalyType.BROKER_FAILURE, False)
    assert n.on_anomaly(anomaly).action == Action.IGNORE


def test_detector_dispatch_and_busy_backoff():
    clock = {"now": 10_000}
    notifier = SelfHealingNotifier(
        self_healing={t: True for t in AnomalyType},
        broker_failure_alert_threshold_ms=0,
        broker_failure_self_healing_threshold_ms=0,
        now_ms=lambda: clock["now"],
    )
    actions = RecordingActions()
    det = AnomalyDetector(notifier, actions, now_ms=lambda: clock["now"])
    det.register_detector(lambda: GoalViolations(fixable_violations=["DiskCapacityGoal"]))
    recs = det.run_once()
    assert [r.status for r in recs] == ["FIX_STARTED"]
    assert actions.calls and actions.calls[0][0] == "rebalance"

    # busy executor defers the anomaly instead of fixing
    actions2 = RecordingActions(busy=True)
    det2 = AnomalyDetector(notifier, actions2, now_ms=lambda: clock["now"])
    det2.add_anomaly(BrokerFailures(failed_brokers={1: 0}))
    recs2 = det2._drain()
    assert recs2[0].status == "CHECKED" and not actions2.calls
    # after backoff elapses and executor frees up, the fix lands
    actions2.busy = False
    clock["now"] += 31_000
    recs3 = det2.run_once()
    assert ("remove_brokers", (1,)) in actions2.calls
    state = det2.detector_state()
    assert state["numSelfHealingStarted"] == 1


def test_self_healing_end_to_end_dead_broker():
    """Broker dies -> detector fires -> fix rebuilds replicas elsewhere
    (reference RandomSelfHealingTest semantics)."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.executor import ExecutionOptions, Executor, SimulatedClusterAdmin
    from cruise_control_tpu_torch.monitor import (
        FixedCapacityResolver,
        KAFKA_METRIC_DEF,
        LoadMonitor,
        MetricFetcherManager,
        ModelCompletenessRequirements,
        StaticMetadataProvider,
        WindowedMetricSampleAggregator,
    )
    from cruise_control_tpu_torch.testing.synthetic import (
        SyntheticWorkloadSampler,
        synthetic_topology,
    )

    base = synthetic_topology(num_brokers=5, topics={"T0": 10}, seed=9)
    meta = StaticMetadataProvider(base)
    sampler = SyntheticWorkloadSampler(base, seed=9)
    agg = WindowedMetricSampleAggregator(3, 1000, 1, KAFKA_METRIC_DEF)
    fetcher = MetricFetcherManager(sampler, agg, None)
    for w in range(4):
        fetcher.fetch_once(sampler.all_partition_entities(), w * 1000, (w + 1) * 1000 - 1)
    monitor = LoadMonitor(meta, FixedCapacityResolver([100.0, 1e5, 1e5, 1e6]), agg, device="cpu")

    # kill broker 4
    t = meta.topology()
    brokers = tuple(dataclasses.replace(b, alive=b.broker_id != 4) for b in t.brokers)
    meta.set_topology(dataclasses.replace(t, brokers=brokers))

    admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1e12)
    req = ModelCompletenessRequirements(min_required_num_windows=2)

    class Actions(RecordingActions):
        def remove_brokers(self, broker_ids, reason):
            state = monitor.cluster_model(req)
            cfg = OptimizerConfig(
                num_candidates=128, leadership_candidates=32, steps_per_round=16, num_rounds=2
            )
            res = GoalOptimizer(config=cfg, device="cpu").optimize(state)
            ex = Executor(admin, catalog=monitor.last_catalog)
            ex.execute_proposals(
                res.proposals,
                ExecutionOptions(progress_check_interval_s=1.0),
                removed_brokers=set(broker_ids),
            )
            self.calls.append(("remove_brokers", tuple(broker_ids)))
            return True

    notifier = SelfHealingNotifier(
        self_healing={AnomalyType.BROKER_FAILURE: True},
        broker_failure_alert_threshold_ms=0,
        broker_failure_self_healing_threshold_ms=0,
    )
    actions = Actions()
    det = AnomalyDetector(notifier, actions)
    bfd = BrokerFailureDetector(meta.topology)
    det.register_detector(bfd.detect)
    recs = det.run_once()
    assert any(r.status == "FIX_STARTED" for r in recs)

    # no partition may keep a replica on the dead broker
    after = meta.topology()
    for p in after.partitions:
        assert 4 not in p.replicas, f"partition {p} still on dead broker"


def test_slow_broker_finder_requires_majority_of_metric_families():
    """One noisy family spiking must NOT flag a broker; a majority of the
    evidence agreeing must (reference SlowBrokerFinder.java:99 multi-source
    evidence: byte rates + request latencies)."""
    finder = SlowBrokerFinder(peer_ratio=2.0, removal_threshold=3)

    def evidence(flush, produce, queue, broker=2):
        out = {}
        for b in range(4):
            out[b] = {
                "log_flush_time_ms_mean": 10.0 + b,
                "produce_local_time_ms_mean": 5.0 + b,
                "request_queue_size": 3.0,
            }
        out[broker] = {
            "log_flush_time_ms_mean": flush,
            "produce_local_time_ms_mean": produce,
            "request_queue_size": queue,
        }
        return out

    for _ in range(5):
        assert finder.detect(evidence(12.0, 6.0, 3.0)) is None
    # only ONE of three families spikes: not slow
    assert finder.detect(evidence(500.0, 6.0, 3.0)) is None
    # two of three agree (majority): slow
    a = finder.detect(evidence(500.0, 200.0, 3.0))
    assert a is not None and set(a.slow_brokers) == {2}
    assert not a.remove_slow_brokers
    # recovery clears the strikes
    assert finder.detect(evidence(12.0, 6.0, 3.0)) is None
    a2 = finder.detect(evidence(500.0, 200.0, 3.0))
    assert a2 is not None and not a2.remove_slow_brokers


def test_detector_loop_survives_handler_exceptions():
    import time

    from cruise_control_tpu_torch.common.sensors import SensorRegistry
    from cruise_control_tpu_torch.detector import AnomalyDetector
    from cruise_control_tpu_torch.detector.anomalies import GoalViolations

    class ExplodingNotifier:
        def on_anomaly(self, anomaly):
            raise RuntimeError("notifier crashed")

        def self_healing_enabled(self):
            return {}

    class Actions:
        is_busy = False

    sensors = SensorRegistry()
    det = AnomalyDetector(ExplodingNotifier(), Actions(), sensors=sensors)
    det.register_detector(lambda: GoalViolations(fixable_violations=["DiskUsage"]))
    det.start(interval_s=0.01)
    try:
        deadline = time.monotonic() + 5.0
        while (
            sensors.counter("detector.loop-failures").count < 2
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
    finally:
        det.shutdown()
    # the loop kept ticking across >= 2 failing rounds instead of dying
    assert sensors.counter("detector.loop-failures").count >= 2


# ------------------------- the service's slow-broker wiring (tests/test_detector.py :274)


def test_slow_broker_detector_wired_into_service():
    """The facade registers a SlowBrokerFinder fed from the broker
    aggregator (reference AnomalyDetector.java:63-68 wiring + metric
    sources SlowBrokerFinder.java:99)."""
    from cruise_control_tpu_torch.service.main import build_simulated_service

    app, fetcher, admin, sampler = build_simulated_service(seed=17, device="cpu")
    try:
        assert app.cc.slow_broker_finder is not None
        # a full detection round must execute the slow-broker feed without
        # error against the live broker aggregator
        records = app.cc.anomaly_detector.run_once()
        assert isinstance(records, list)
    finally:
        app.stop()
