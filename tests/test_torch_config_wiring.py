"""The JAX package's tests/test_config_wiring.py, pointed at the port on the CPU.

Config-key wiring tests: every key added for reference parity must
actually change behavior (VERDICT r2 missing #6 — config-key surface).

Reference anchors: config/constants/AnomalyDetectorConfig.java,
ExecutorConfig.java, AnalyzerConfig.java.
"""

import time

import pytest

from cruise_control_tpu_torch.config import ConfigException, CruiseControlConfig
from cruise_control_tpu_torch.service.main import build_simulated_service


def test_new_key_defaults_match_reference():
    c = CruiseControlConfig({})
    assert c.get("anomaly.detection.goals") == [
        "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
    ]
    assert c.get("self.healing.goals") == []
    assert c.get("num.cached.recent.anomaly.states") == 10
    assert c.get("max.num.cluster.movements") == 1250
    assert c.get("leader.movement.timeout.ms") == 180_000
    assert c.get("removal.history.retention.time.ms") == 1_209_600_000
    assert c.get("fixable.failed.broker.count.threshold") == 10
    assert c.get("fixable.failed.broker.percentage.threshold") == 0.4
    assert c.get("goal.balancedness.priority.weight") == 1.1
    assert c.get("goal.balancedness.strictness.weight") == 1.5
    # per-detector interval overrides default to unset (fall back to the
    # base anomaly.detection.interval.ms)
    assert c.get("goal.violation.detection.interval.ms") is None


def test_goal_list_keys_are_validated():
    for key in ("anomaly.detection.goals", "self.healing.goals",
                "intra.broker.goals"):
        with pytest.raises(ConfigException):
            CruiseControlConfig({key: "NoSuchGoal"})


def test_detector_interval_scheduling():
    """Per-detector cadence: a detector with a long interval runs once per
    window while unset-interval detectors run every scheduled round."""
    from cruise_control_tpu_torch.detector.detector import AnomalyDetector
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier

    class _IdleActions:
        is_busy = False

    det = AnomalyDetector(SelfHealingNotifier(), _IdleActions())
    calls = {"fast": 0, "slow": 0}
    det.register_detector(lambda: calls.__setitem__("fast", calls["fast"] + 1))
    det.register_detector(
        lambda: calls.__setitem__("slow", calls["slow"] + 1), interval_s=3600
    )
    for _ in range(3):
        det.run_once(respect_intervals=True)
    assert calls["fast"] == 3
    assert calls["slow"] == 1
    # forced rounds (default) ignore cadence — deterministic for tests
    det.run_once()
    assert calls["slow"] == 2


def test_anomaly_history_size_config():
    from cruise_control_tpu_torch.detector.detector import AnomalyDetector
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier

    class _IdleActions:
        is_busy = False

    det = AnomalyDetector(SelfHealingNotifier(), _IdleActions(), history_size=2)
    assert det.state.recent[next(iter(det.state.recent))].maxlen == 2


def test_executor_history_retention_and_drop():
    from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
    from cruise_control_tpu_torch.executor.executor import Executor
    from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=3, topics={"T0": 3}))
    )
    ex = Executor(admin, removal_history_retention_ms=50,
                  demotion_history_retention_ms=10_000)
    ex.execute_proposals([], removed_brokers={1}, demoted_brokers={2})
    assert ex.removed_brokers == {1}
    assert ex.demoted_brokers == {2}
    time.sleep(0.06)
    # removal history expired; demotion retention is longer
    assert ex.removed_brokers == set()
    assert ex.demoted_brokers == {2}
    ex.drop_demoted_brokers([2])
    assert ex.demoted_brokers == set()


def test_planner_max_total_budget():
    from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
    from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner

    planner = ExecutionTaskPlanner()
    proposals = [
        ExecutionProposal(
            topic="T0", partition=i, old_leader=0, new_leader=1,
            old_replicas=(0,), new_replicas=(1,),
            inter_broker_data_to_move=1.0,
        )
        for i in range(10)
    ]
    planner.add_execution_proposals(proposals, None)
    ready = {0: 100, 1: 100}
    got = planner.get_inter_broker_replica_movement_tasks(ready, set(), max_total=3)
    assert len(got) == 3
    # the rest stay queued for later rounds
    more = planner.get_inter_broker_replica_movement_tasks(
        {0: 100, 1: 100}, set(), max_total=100
    )
    assert len(more) == 7


@pytest.fixture(scope="module")
def wired_service():
    config = CruiseControlConfig(
        {
            "partition.metrics.window.ms": 1000,
            "min.samples.per.partition.metrics.window": 1,
            "execution.progress.check.interval.ms": 100,
            "webserver.http.port": 0,
            "tpu.num.candidates": 128,
            "tpu.leadership.candidates": 32,
            "tpu.steps.per.round": 16,
            "tpu.num.rounds": 2,
            "anomaly.detection.goals": "RackAwareGoal,ReplicaCapacityGoal",
            "self.healing.goals": "RackAwareGoal,ReplicaCapacityGoal,DiskCapacityGoal",
            "fixable.failed.broker.count.threshold": "2",
            "fixable.failed.broker.percentage.threshold": "0.5",
            "topics.excluded.from.partition.movement": "T1",
        }
    )
    app, fetcher, admin, sampler = build_simulated_service(config, seed=11, device="cpu")
    yield app


def test_anomaly_detection_goals_chain(wired_service):
    cc = wired_service.cc
    # the violation detector watches its own configured (smaller) chain
    gvd_chain_names = None
    for fn, _interval, _backoff in cc.anomaly_detector._detectors:
        owner = getattr(fn, "__self__", None)
        if owner is not None and hasattr(owner, "chain"):
            gvd_chain_names = owner.chain.names()
            break
    assert gvd_chain_names == ["RackAwareGoal", "ReplicaCapacityGoal"]


def test_self_healing_kwargs(wired_service):
    cc = wired_service.cc
    cc.executor._removed_history[4] = int(time.time() * 1000)
    cc.executor._demoted_history[5] = int(time.time() * 1000)
    try:
        kwargs = cc.actions._healing_kwargs()
        assert kwargs["goals"] == [
            "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
        ]
        assert kwargs["excluded_brokers_for_replica_move"] == [4]
        assert kwargs["excluded_brokers_for_leadership"] == [5]
    finally:
        cc.executor.drop_removed_brokers([4])
        cc.executor.drop_demoted_brokers([5])


def test_fixable_failed_broker_thresholds(wired_service):
    cc = wired_service.cc
    # count gate: 3 > threshold 2
    assert cc.actions.remove_brokers([0, 1, 2], reason="test") is False
    # percentage gate: 2 of 6 brokers is fine by count (<=2) and <= 50%,
    # so the guard passes through to the (dryrun=False) operation which we
    # do not want to actually run here — patch the facade call
    called = {}
    orig = cc.remove_brokers
    cc.remove_brokers = lambda *a, **k: called.setdefault("yes", True) or {}
    try:
        assert cc.actions.remove_brokers([0, 1], reason="test") is True
        assert called
    finally:
        cc.remove_brokers = orig


def test_config_excluded_topics_merged(wired_service):
    cc = wired_service.cc
    from cruise_control_tpu_torch.service.progress import OperationProgress

    state = cc._cluster_model(OperationProgress())
    opts = cc._build_options(state)
    assert opts.excluded_topics is not None
    catalog = cc.monitor.last_catalog
    t1 = catalog.topics.index("T1")
    assert bool(opts.excluded_topics[t1])
    t0 = catalog.topics.index("T0")
    assert not bool(opts.excluded_topics[t0])
    # request pattern widens, never narrows
    opts2 = cc._build_options(state, excluded_topics_pattern="T0")
    assert bool(opts2.excluded_topics[t0]) and bool(opts2.excluded_topics[t1])


# ------------------------------------------------------------- pluggables


def test_strategy_chain_resolution_and_pool():
    from cruise_control_tpu_torch.executor.strategy import (
        PrioritizeLargeReplicaMovementStrategy,
        resolve_strategy_chain,
    )

    chain = resolve_strategy_chain(
        ["PostponeUrpReplicaMovementStrategy", "PrioritizeLargeReplicaMovementStrategy"]
    )
    assert "PostponeUrp" in chain.name and "PrioritizeLarge" in chain.name
    # pool restriction (reference replica.movement.strategies)
    with pytest.raises(ValueError):
        resolve_strategy_chain(
            ["PrioritizeLargeReplicaMovementStrategy"],
            allowed={"BaseReplicaMovementStrategy"},
        )
    # dotted path resolves a custom class
    custom = resolve_strategy_chain(
        ["cruise_control_tpu_torch.executor.strategy.PrioritizeSmallReplicaMovementStrategy"]
    )
    assert custom.name == "PrioritizeSmallReplicaMovementStrategy"
    with pytest.raises(ValueError):
        resolve_strategy_chain(["NoSuchStrategy"])


def test_executor_notifier_called():
    from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
    from cruise_control_tpu_torch.executor.executor import Executor
    from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    calls = []

    class Notifier:
        def on_execution_finished(self, result, uuid):
            calls.append((result.completed, uuid))

    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=3, topics={"T0": 3}))
    )
    ex = Executor(admin, notifier=Notifier())
    ex.execute_proposals([], uuid="op-1")
    assert calls == [(0, "op-1")]


def test_regression_bucket_gate_and_auto_train():
    import numpy as np

    from cruise_control_tpu_torch.monitor.cpu_model import LinearRegressionModelParameters

    lr = LinearRegressionModelParameters(
        min_samples_to_train=6,
        cpu_util_bucket_size=10,
        required_samples_per_bucket=2,
        min_num_cpu_util_buckets=3,
    )
    rng = np.random.default_rng(1)
    # all samples in one CPU bucket: floor met but coverage insufficient
    for _ in range(6):
        x = rng.uniform(0, 1000, 3)
        lr.add_sample(*x, cpu_util=0.05)
    assert not lr.ready_to_train()
    assert not lr.train()
    # force (explicit /train) overrides coverage, not the sample floor
    assert lr.train(force=True)
    lr2 = LinearRegressionModelParameters(
        min_samples_to_train=6, cpu_util_bucket_size=10,
        required_samples_per_bucket=2, min_num_cpu_util_buckets=3,
    )
    for cpu in (0.05, 0.05, 0.35, 0.35, 0.65, 0.65):
        x = rng.uniform(0, 1000, 3)
        lr2.add_sample(*x, cpu_util=cpu)
    assert lr2.ready_to_train()
    assert lr2.train()


def test_rf_finder_uses_topic_config_provider():
    import dataclasses

    from cruise_control_tpu_torch.detector.detectors import (
        TopicReplicationFactorAnomalyFinder,
    )
    from cruise_control_tpu_torch.monitor.topic_config import StaticTopicConfigProvider
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    topo = synthetic_topology(num_brokers=4, topics={"T0": 2, "T1": 2}, seed=0)
    # force both topics to RF 2
    parts = tuple(
        dataclasses.replace(p, replicas=tuple(p.replicas[:2])) for p in topo.partitions
    )
    topo = dataclasses.replace(topo, partitions=parts)
    provider = StaticTopicConfigProvider({"T0": {"min.insync.replicas": "2"}})
    finder = TopicReplicationFactorAnomalyFinder(
        lambda: topo, target_rf=2, topic_config_provider=provider
    )
    anomaly = finder.detect()
    # T0 needs RF >= minISR+1 = 3 -> flagged; T1 (minISR 1) is fine at RF 2
    assert anomaly is not None
    assert set(anomaly.bad_topics) == {"T0"}
    # without a provider, RF 2 meets the global target -> no anomaly
    assert TopicReplicationFactorAnomalyFinder(lambda: topo, target_rf=2).detect() is None


def test_sampler_cpu_estimation_flag():
    from cruise_control_tpu_torch.config import CruiseControlConfig

    c = CruiseControlConfig({})
    assert c.get("sampling.allow.cpu.capacity.estimation") is True
    assert c.get("use.linear.regression.model") is False
    assert c.get("skip.loading.samples") is False
    assert c.get("max.allowed.extrapolations.per.broker") == 5


def test_cpu_weight_keys_wired():
    from cruise_control_tpu_torch.monitor.cpu_model import follower_cpu_util

    # default weights (0.7, 0.15, 0.15)
    base = follower_cpu_util(100.0, 100.0, 0.5)
    alt = follower_cpu_util(100.0, 100.0, 0.5, weights=(0.5, 0.25, 0.25))
    assert base != alt
    assert base == pytest.approx(0.5 * 0.15 * 100.0 / (0.7 * 100.0 + 0.15 * 100.0))


def test_reference_spelled_override_keys_accepted():
    from cruise_control_tpu_torch.service.parameters import (
        EndpointParameters,
        build_override_maps,
    )

    class MyParams(EndpointParameters):
        def __init__(self, endpoint, builtin):
            super().__init__(endpoint, builtin.params)

    # reference dotted spelling of add_broker.parameters.class (CLASS-typed
    # keys accept a class object directly)
    c = CruiseControlConfig({"add.broker.parameters.class": MyParams})
    parsers, handlers = build_override_maps(c)
    assert isinstance(parsers["add_broker"], MyParams)


def test_slow_task_rate_alerting():
    """A long-running task alerts only when ALSO slower than the MB/s floor
    (reference ExecutorConfig:142-158)."""
    from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
    from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
    from cruise_control_tpu_torch.executor.executor import ExecutionOptions, Executor
    from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=4, topics={"T0": 4})),
        link_rate_bytes_per_s=1.0,  # glacial: tasks run long
    )
    p0 = admin.metadata.topology().partitions[0]
    dest = next(
        b.broker_id
        for b in admin.metadata.topology().brokers
        if b.broker_id not in p0.replicas
    )
    # 50 KB over the many simulated seconds the 1 B/s link needs puts the
    # rate far under the default 0.1 MB/s floor — the DEFAULT threshold
    # must fire (units: data_to_move is bytes, the threshold is MB/s)
    prop = ExecutionProposal(
        topic=p0.topic, partition=p0.partition, old_leader=p0.leader,
        new_leader=p0.leader, old_replicas=tuple(p0.replicas),
        new_replicas=tuple(list(p0.replicas[1:]) + [dest]),
        inter_broker_data_to_move=50_000.0,
    )
    alerts = []

    class Notifier:
        def on_execution_finished(self, result, uuid):
            pass

        def on_task_alert(self, task):
            alerts.append(task)

    ex = Executor(admin, topic_names={0: "T0"}, notifier=Notifier())
    ex.execute_proposals(
        [prop],
        ExecutionOptions(
            progress_check_interval_s=1.0,
            task_execution_alerting_s=2.0,
            max_ticks=30,
        ),
    )
    assert alerts, "slow task should have alerted at the default floor"
    # a fast mover (same elapsed, vastly more data) must NOT alert
    admin2 = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=4, topics={"T0": 4})),
        link_rate_bytes_per_s=1e9,
    )
    q0 = admin2.metadata.topology().partitions[0]
    dest2 = next(
        b.broker_id
        for b in admin2.metadata.topology().brokers
        if b.broker_id not in q0.replicas
    )
    fast = ExecutionProposal(
        topic=q0.topic, partition=q0.partition, old_leader=q0.leader,
        new_leader=q0.leader, old_replicas=tuple(q0.replicas),
        new_replicas=tuple(list(q0.replicas[1:]) + [dest2]),
        inter_broker_data_to_move=5e9,
    )
    alerts2 = []

    class Notifier2:
        def on_execution_finished(self, result, uuid):
            pass

        def on_task_alert(self, task):
            alerts2.append(task)

    ex2 = Executor(admin2, topic_names={0: "T0"}, notifier=Notifier2())
    ex2.execute_proposals(
        [fast],
        ExecutionOptions(
            progress_check_interval_s=1.0,
            task_execution_alerting_s=2.0,
            max_ticks=30,
        ),
    )
    assert not alerts2, "fast mover must not rate-alert"


# ------------------------------------------------------------- webserver


def test_jwt_cookie_and_audience():
    from cruise_control_tpu_torch.service.security import JwtSecurityProvider

    p = JwtSecurityProvider("s3cret", cookie_name="CCJWT",
                            expected_audiences=["cruise-control"])
    from cruise_control_tpu_torch.service.security import jwt_encode

    good = jwt_encode({"sub": "u", "role": "ADMIN", "aud": "cruise-control"},
                      "s3cret")
    wrong_aud = jwt_encode({"sub": "u", "role": "ADMIN", "aud": "other"},
                           "s3cret")
    no_aud = jwt_encode({"sub": "u", "role": "ADMIN"}, "s3cret")
    assert p.authenticate({"Authorization": f"Bearer {good}"}) == ("u", "ADMIN")
    assert p.authenticate({"Cookie": f"CCJWT={good}"}) == ("u", "ADMIN")
    assert p.authenticate({"Authorization": f"Bearer {wrong_aud}"}) is None
    assert p.authenticate({"Authorization": f"Bearer {no_aud}"}) is None
    # header outranks cookie
    assert p.authenticate(
        {"Authorization": f"Bearer {wrong_aud}", "Cookie": f"CCJWT={good}"}
    ) is None


def test_purgatory_max_requests():
    from cruise_control_tpu_torch.service.purgatory import Purgatory

    p = Purgatory(max_requests=2)
    p.add("rebalance", {})
    p.add("rebalance", {})
    with pytest.raises(ValueError):
        p.add("rebalance", {})
    # reviewing one frees a slot
    info = p.board()[0]
    p.review(info["Id"] if isinstance(info, dict) else info.review_id, approve=False)
    p.add("rebalance", {})


def test_access_log_ncsa_and_retention(tmp_path):
    import os

    from cruise_control_tpu_torch.service.server import AccessLog

    path = tmp_path / "logs" / "access.log"
    log = AccessLog(str(path), retention_days=1)
    log.log("127.0.0.1", "admin", "GET", "/kafkacruisecontrol/state", 200, 42)
    line = path.read_text().strip()
    assert line.startswith("127.0.0.1 - admin [")
    assert '"GET /kafkacruisecontrol/state HTTP/1.1" 200 42' in line
    # a rolled file older than retention is pruned on the next roll
    old = tmp_path / "logs" / "access.log.2020-01-01"
    old.write_text("old\n")
    os.utime(old, (0, 0))
    log._day = "2020-01-02"  # force a roll on next write
    log.log("127.0.0.1", "-", "GET", "/x", 200, 1)
    assert not old.exists()


def test_user_task_category_retention():
    import time as _time

    from cruise_control_tpu_torch.service.tasks import UserTaskManager

    m = UserTaskManager(
        completed_retention_ms=3_600_000,
        category_retention_ms={"KAFKA_MONITOR": 0},  # evict instantly
    )
    t_monitor = m.submit("proposals", lambda p: {})
    t_admin = m.submit("rebalance", lambda p: {})
    t_monitor.future.result()
    t_admin.future.result()
    _time.sleep(0.01)
    m._maybe_evict()
    assert m.get(t_monitor.task_id) is None  # KAFKA_MONITOR retention 0
    assert m.get(t_admin.task_id) is not None  # general retention applies


def test_endpoint_types_cover_all_endpoints():
    from cruise_control_tpu_torch.config.endpoints import ALL_ENDPOINTS, ENDPOINT_TYPES

    assert set(ENDPOINT_TYPES) == set(ALL_ENDPOINTS)
    assert set(ENDPOINT_TYPES.values()) == {
        "KAFKA_MONITOR", "CRUISE_CONTROL_MONITOR",
        "KAFKA_ADMIN", "CRUISE_CONTROL_ADMIN",
    }


@pytest.fixture(scope="module")
def http_service(tmp_path_factory):
    """Live HTTP service exercising the CORS/access-log/reason-required keys."""
    import urllib.request

    from cruise_control_tpu_torch.config import CruiseControlConfig

    logdir = tmp_path_factory.mktemp("accesslog")
    config = CruiseControlConfig(
        {
            "partition.metrics.window.ms": 1000,
            "min.samples.per.partition.metrics.window": 1,
            "execution.progress.check.interval.ms": 100,
            "webserver.http.port": 0,
            "tpu.num.candidates": 128,
            "tpu.leadership.candidates": 32,
            "tpu.steps.per.round": 8,
            "tpu.num.rounds": 2,
            "webserver.http.cors.enabled": "true",
            "webserver.http.cors.origin": "https://ops.example.com",
            "webserver.accesslog.enabled": "true",
            "webserver.accesslog.path": str(logdir / "access.log"),
            "request.reason.required": "true",
        }
    )
    app, fetcher, admin, sampler = build_simulated_service(config, seed=13, device="cpu")
    app.start()
    yield app, logdir
    app.stop()


def test_cors_headers_and_preflight(http_service):
    import http.client
    import json as _json
    import urllib.request

    app, _ = http_service
    url = f"http://{app.host}:{app.port}{app.prefix}/state"
    with urllib.request.urlopen(url, timeout=30) as resp:
        assert resp.headers["Access-Control-Allow-Origin"] == "https://ops.example.com"
        assert "User-Task-ID" in resp.headers["Access-Control-Expose-Headers"]
        _json.loads(resp.read())
    conn = http.client.HTTPConnection(app.host, app.port, timeout=30)
    conn.request("OPTIONS", f"{app.prefix}/state")
    pre = conn.getresponse()
    assert pre.status == 200
    assert pre.headers["Access-Control-Allow-Methods"] == "OPTIONS, GET, POST"
    assert "Authorization" in pre.headers["Access-Control-Allow-Headers"]
    conn.close()


def test_session_cookie_issued(http_service):
    import urllib.request

    app, _ = http_service
    url = f"http://{app.host}:{app.port}{app.prefix}/state"
    with urllib.request.urlopen(url, timeout=30) as resp:
        cookie = resp.headers.get("Set-Cookie", "")
    assert cookie.startswith("CCSESSION=")
    assert "Path=/" in cookie and "HttpOnly" in cookie


def test_reason_required_on_posts(http_service):
    import urllib.error
    import urllib.request

    app, _ = http_service
    base = f"http://{app.host}:{app.port}{app.prefix}"
    req = urllib.request.Request(f"{base}/pause_sampling", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    req = urllib.request.Request(
        f"{base}/pause_sampling?reason=maintenance", method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 200
    req = urllib.request.Request(
        f"{base}/resume_sampling?reason=done", method="POST"
    )
    urllib.request.urlopen(req, timeout=30).read()


def test_access_log_written(http_service):
    app, logdir = http_service
    content = (logdir / "access.log").read_text()
    assert '"GET ' in content and "HTTP/1.1" in content


def test_cache_not_served_when_estimation_forbidden(wired_service):
    """A request with allow_capacity_estimation=false must not be served
    from a cache filled with estimation allowed (reference sanity-checks
    capacityEstimationInfoByBrokerId on cached results)."""
    import dataclasses

    from cruise_control_tpu_torch.monitor.load_monitor import (
        BrokerCapacityEstimationError,
    )
    from cruise_control_tpu_torch.service.progress import OperationProgress

    cc = wired_service.cc
    cc.proposals(OperationProgress())  # fill the cache (estimation allowed)
    resolver = cc.monitor.capacity_resolver
    orig = resolver.capacity_for_broker
    resolver.capacity_for_broker = lambda r, h, b: dataclasses.replace(
        orig(r, h, b), estimation_info="estimated"
    )
    try:
        with pytest.raises(BrokerCapacityEstimationError):
            cc.proposals(OperationProgress(), allow_capacity_estimation=False)
    finally:
        resolver.capacity_for_broker = orig
        cc.invalidate_proposal_cache()


def test_capacity_estimation_forbidden(wired_service):
    import dataclasses

    from cruise_control_tpu_torch.monitor.load_monitor import (
        BrokerCapacityEstimationError,
    )
    from cruise_control_tpu_torch.service.progress import OperationProgress

    cc = wired_service.cc
    resolver = cc.monitor.capacity_resolver
    orig = resolver.capacity_for_broker

    def estimated(rack, host, broker_id):
        return dataclasses.replace(
            orig(rack, host, broker_id), estimation_info="default capacity"
        )

    resolver.capacity_for_broker = estimated
    try:
        with pytest.raises(BrokerCapacityEstimationError):
            cc._cluster_model(OperationProgress(), allow_capacity_estimation=False)
        # allowed by default
        cc._cluster_model(OperationProgress())
    finally:
        resolver.capacity_for_broker = orig
