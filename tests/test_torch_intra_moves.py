"""Intra-broker (JBOD logdir) moves through the port's executor, on the CPU.

tests/test_intra_moves.py's tests, pointed at the port:
test_intra_move_completes_only_when_copy_lands,
test_intra_move_instant_when_admin_cannot_track,
test_slow_intra_copy_alerts, test_intra_copy_on_dead_broker_goes_dead,
test_unverifiable_copy_bounded_then_dead,
test_vanished_copy_without_landing_is_reexecuted,
test_partition_size_finder_wired_and_excludable,
test_intra_concurrency_cap_holds_while_copies_drain,
test_intra_cap_change_mid_execution,
test_graceful_stop_drains_tracked_copies,
test_transient_describe_failure_keeps_copies_pending and
test_unreachable_broker_backs_off_but_can_recover (these two drive the
port's kafka/admin.py KafkaClusterAdmin).
At the end, test_partition_size_detection_enabled_via_config, over the
port's simulated service.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
from cruise_control_tpu_torch.executor.executor import ExecutionOptions, Executor
from cruise_control_tpu_torch.executor.tasks import TaskState, TaskType
from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
from cruise_control_tpu_torch.testing.synthetic import synthetic_topology


def _intra_proposal(topo, data=1000.0):
    p0 = topo.partitions[0]
    return ExecutionProposal(
        topic=p0.topic, partition=p0.partition, old_leader=p0.leader,
        new_leader=p0.leader, old_replicas=tuple(p0.replicas),
        new_replicas=tuple(p0.replicas),
        disk_moves=((p0.replicas[0], 0, 1),),
        intra_broker_data_to_move=data,
    )


def test_intra_move_completes_only_when_copy_lands():
    topo = synthetic_topology(num_brokers=3, topics={"T0": 2}, seed=0)
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=100.0,
        intra_move_bytes=250.0,  # needs ~2.5 simulated seconds
    )
    ex = Executor(admin, topic_names={0: "T0"})
    res = ex.execute_proposals(
        [_intra_proposal(topo)], ExecutionOptions(progress_check_interval_s=1.0)
    )
    assert res.completed == 1
    # the copy took multiple ticks — it was NOT completed on submit
    assert res.ticks >= 2
    task = ex.tracker.tasks(state=TaskState.COMPLETED)[0]
    assert task.task_type == TaskType.INTRA_BROKER_REPLICA_ACTION


def test_intra_move_instant_when_admin_cannot_track():
    """Admins without logdir-progress reporting keep the submit-completes
    behavior (pre-KIP-113)."""
    topo = synthetic_topology(num_brokers=3, topics={"T0": 2}, seed=0)
    admin = SimulatedClusterAdmin(StaticMetadataProvider(topo))

    class NoTrackAdmin:
        def __getattr__(self, name):
            if name == "in_progress_logdir_moves":
                raise AttributeError(name)
            return getattr(admin, name)

    ex = Executor(NoTrackAdmin(), topic_names={0: "T0"})
    res = ex.execute_proposals(
        [_intra_proposal(topo)], ExecutionOptions(progress_check_interval_s=1.0)
    )
    assert res.completed == 1


def test_slow_intra_copy_alerts():
    topo = synthetic_topology(num_brokers=3, topics={"T0": 2}, seed=0)
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=1.0,
        intra_move_bytes=50.0,  # 50 simulated seconds at 1 B/s
    )
    alerts = []

    class Notifier:
        def on_execution_finished(self, result, uuid):
            pass

        def on_task_alert(self, task):
            alerts.append(task.task_type)

    ex = Executor(admin, topic_names={0: "T0"}, notifier=Notifier())
    res = ex.execute_proposals(
        [_intra_proposal(topo, data=1000.0)],
        ExecutionOptions(progress_check_interval_s=1.0, task_execution_alerting_s=2.0),
    )
    assert res.completed == 1
    assert TaskType.INTRA_BROKER_REPLICA_ACTION in alerts


def test_intra_copy_on_dead_broker_goes_dead():
    """A logdir copy whose broker dies mid-copy is killed, not spun on
    until max_ticks."""
    topo = synthetic_topology(num_brokers=3, topics={"T0": 2}, seed=0)
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=1.0,
        intra_move_bytes=1e9,  # would take forever
    )
    prop = _intra_proposal(topo)
    dead_broker = prop.disk_moves[0][0]
    orig_tick = admin.tick
    ticks = {"n": 0}

    def kill_broker(seconds):
        ticks["n"] += 1
        if ticks["n"] == 2:
            t = admin.metadata.topology()
            brokers = tuple(
                dataclasses.replace(b, alive=(b.broker_id != dead_broker))
                for b in t.brokers
            )
            admin.metadata.set_topology(dataclasses.replace(t, brokers=brokers))
        return orig_tick(seconds)

    admin.tick = kill_broker
    ex = Executor(admin, topic_names={0: "T0"})
    res = ex.execute_proposals(
        [prop], ExecutionOptions(progress_check_interval_s=1.0)
    )
    assert res.dead == 1
    assert res.ticks < 20


def test_unverifiable_copy_bounded_then_dead():
    """A copy that vanishes but can never be VERIFIED (logdir_of None —
    e.g. network-partitioned broker still alive in metadata) goes DEAD
    after max_intra_verify_failures ticks instead of spinning to
    max_ticks."""
    topo = synthetic_topology(num_brokers=3, topics={"T0": 2}, seed=0)
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=100.0,
        intra_move_bytes=150.0,
    )
    orig_tick = admin.tick

    def vanish_first(seconds):
        admin._intra_inflight.clear()  # copy aborts, never lands
        return orig_tick(seconds)

    admin.tick = vanish_first
    admin.logdir_of = lambda *a: None  # and the broker cannot be asked
    ex = Executor(admin, topic_names={0: "T0"})
    res = ex.execute_proposals(
        [_intra_proposal(topo)],
        ExecutionOptions(progress_check_interval_s=1.0, max_intra_verify_failures=3),
    )
    assert res.dead == 1
    assert res.ticks < 10


def test_vanished_copy_without_landing_is_reexecuted():
    """A copy that disappears from the future set WITHOUT landing on the
    target dir is re-submitted (broker restart aborts the future log),
    mirroring the inter-broker landed-check."""
    topo = synthetic_topology(num_brokers=3, topics={"T0": 2}, seed=0)
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=100.0,
        intra_move_bytes=150.0,
    )
    drops = {"n": 0}
    resubmits = []
    orig_alter = admin.alter_replica_logdirs

    def dropping_alter(moves):
        resubmits.append(list(moves))
        orig_alter(moves)

    admin.alter_replica_logdirs = dropping_alter
    # logdir_of: first query reports the OLD dir (copy aborted), later the
    # target — simulates a broker restart aborting the first attempt
    def logdir_of(topic, partition, broker):
        drops["n"] += 1
        return 0 if drops["n"] == 1 else 1

    admin.logdir_of = logdir_of
    orig_tick = admin.tick

    def tick_dropping_first(seconds):
        # abort the first copy attempt mid-flight once
        if drops["n"] == 0 and admin._intra_inflight:
            admin._intra_inflight.clear()
        return orig_tick(seconds)

    admin.tick = tick_dropping_first
    ex = Executor(admin, topic_names={0: "T0"})
    res = ex.execute_proposals(
        [_intra_proposal(topo)], ExecutionOptions(progress_check_interval_s=1.0)
    )
    assert res.completed == 1
    assert len(resubmits) >= 2, "aborted copy must be re-submitted"
    assert ex.executor_state()["numReexecutedTasks"] >= 1


def test_partition_size_finder_wired_and_excludable():
    from cruise_control_tpu_torch.detector.detectors import PartitionSizeAnomalyFinder
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster

    state = random_cluster(
        RandomClusterSpec(num_brokers=5, num_partitions=50, num_topics=2), seed=2, device="cpu"
    )

    class Catalog:
        def partition_key(self, pid):
            return ("T0" if pid % 2 == 0 else "T1", pid)

    sizes = np.asarray(state.replica_load_leader)[:, 3]
    lead = np.asarray(state.replica_is_leader) & np.asarray(state.replica_valid)
    threshold = float(np.percentile(sizes[lead], 50))
    finder = PartitionSizeAnomalyFinder(
        lambda: state, Catalog, max_partition_size=threshold
    )
    finder.catalog_provider = lambda: Catalog()
    anomaly = finder.detect()
    assert anomaly is not None and anomaly.oversized
    # excluding every topic silences it
    silent = PartitionSizeAnomalyFinder(
        lambda: state, lambda: Catalog(), max_partition_size=threshold,
        excluded_topics_pattern="T.*",
    )
    assert silent.detect() is None


def _multi_intra_proposals(topo, n, broker, data=1000.0):
    """n intra-broker disk moves all on the same broker."""
    out = []
    for i, p in enumerate(topo.partitions[:n]):
        out.append(ExecutionProposal(
            topic=p.topic, partition=p.partition, old_leader=p.leader,
            new_leader=p.leader, old_replicas=tuple(p.replicas),
            new_replicas=tuple(p.replicas),
            disk_moves=((broker, 0, 1),),
            intra_broker_data_to_move=data,
        ))
    return out


def test_intra_concurrency_cap_holds_while_copies_drain():
    """num.concurrent.intra.broker.partition.movements caps CONCURRENT
    copies per broker: copies still in flight consume their broker's
    slots, so the executor must not submit a fresh full-cap batch every
    tick (reference Executor per-broker intra concurrency)."""
    topo = synthetic_topology(num_brokers=3, topics={"T0": 8}, seed=0)
    broker = topo.partitions[0].replicas[0]
    # pin every proposal's broker to the same one so the cap is the binding
    # constraint; each copy takes ~3 ticks (250 bytes at 100 B/s)
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=100.0,
        intra_move_bytes=250.0,
    )
    concurrent = []
    orig = admin.tick

    def spy(seconds):
        concurrent.append(len(admin._intra_inflight))
        return orig(seconds)

    admin.tick = spy
    ex = Executor(admin, topic_names={0: "T0"})
    props = _multi_intra_proposals(topo, 6, broker)
    res = ex.execute_proposals(
        props,
        ExecutionOptions(
            concurrent_intra_broker_partition_movements=2,
            progress_check_interval_s=1.0,
        ),
    )
    assert res.completed == 6
    assert max(concurrent) <= 2, (
        f"intra cap violated: up to {max(concurrent)} concurrent copies"
    )


def test_intra_cap_change_mid_execution():
    """Raising the intra cap on a live execution speeds the drain."""
    topo = synthetic_topology(num_brokers=3, topics={"T0": 8}, seed=0)
    broker = topo.partitions[0].replicas[0]
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=100.0,
        intra_move_bytes=250.0,
    )
    concurrent = []
    orig = admin.tick

    def spy(seconds):
        concurrent.append(len(admin._intra_inflight))
        if len(concurrent) == 4:
            ex.set_requested_concurrency(intra_broker=4)
        return orig(seconds)

    admin.tick = spy
    ex = Executor(admin, topic_names={0: "T0"})
    props = _multi_intra_proposals(topo, 8, broker)
    res = ex.execute_proposals(
        props,
        ExecutionOptions(
            concurrent_intra_broker_partition_movements=1,
            progress_check_interval_s=1.0,
        ),
    )
    assert res.completed == 8
    assert max(concurrent[:4]) <= 1
    assert max(concurrent[4:]) > 1
    assert max(concurrent) <= 4


def test_graceful_stop_drains_tracked_copies():
    """Graceful stop waits for in-flight logdir copies instead of leaving
    them IN_PROGRESS in the tracker forever."""
    topo = synthetic_topology(num_brokers=3, topics={"T0": 4}, seed=0)
    broker = topo.partitions[0].replicas[0]
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(topo),
        link_rate_bytes_per_s=100.0,
        intra_move_bytes=350.0,
    )
    orig = admin.tick
    calls = []

    def stop_after_1(seconds):
        calls.append(1)
        if len(calls) == 1:
            ex.stop_execution(force=False)
        return orig(seconds)

    admin.tick = stop_after_1
    ex = Executor(admin, topic_names={0: "T0"})
    props = _multi_intra_proposals(topo, 3, broker)
    res = ex.execute_proposals(
        props,
        ExecutionOptions(
            concurrent_intra_broker_partition_movements=1,
            progress_check_interval_s=1.0,
        ),
    )
    assert res.stopped
    assert not ex.tracker.tasks(state=TaskState.IN_PROGRESS)
    assert res.completed + res.aborted + res.dead == len(ex.tracker.tasks())
    assert res.completed >= 1  # the tracked copy was drained, not dropped


def test_transient_describe_failure_keeps_copies_pending():
    """A DescribeLogDirs timeout must not read as 'no copies pending' —
    the executor treats absence as completion (kafka/admin.py
    in_progress_logdir_moves last-known fallback)."""
    from cruise_control_tpu_torch.kafka.admin import KafkaClusterAdmin

    class FlakyClient:
        def __init__(self):
            self.fail_next = False
            self.dirs = {
                "/d0": {"error_code": 0, "replicas": {}, "future_replicas": {("T0", 0)}},
                "/d1": {"error_code": 0, "replicas": {("T0", 0): 10}, "future_replicas": set()},
            }

        def describe_logdirs(self, node_id):
            if self.fail_next:
                self.fail_next = False
                raise OSError("socket timeout")
            return self.dirs

    admin = KafkaClusterAdmin(FlakyClient())
    admin._logdir_move_brokers = {3}

    assert admin.in_progress_logdir_moves() == {("T0", 0, 3)}
    # transient failure: last-known pending set still reported
    admin.client.fail_next = True
    assert admin.in_progress_logdir_moves() == {("T0", 0, 3)}
    # copy finishes: broker drops out of the polling set
    admin.client.dirs["/d0"]["future_replicas"] = set()
    assert admin.in_progress_logdir_moves() == set()
    assert admin._logdir_move_brokers == set()
    # landed-verification: the replica reports under dense dir index 1
    assert admin.logdir_of("T0", 0, 3) == 1


def test_unreachable_broker_backs_off_but_can_recover():
    """Past the consecutive-failure cap the broker is only PROBED every
    few polls (no per-tick socket timeout), its copies stay pending, and a
    recovered broker is re-observed — landed copies are not reported dead."""
    from cruise_control_tpu_torch.kafka.admin import KafkaClusterAdmin

    class FlakyDeadClient:
        calls = 0
        recovered = False

        def describe_logdirs(self, node_id):
            FlakyDeadClient.calls += 1
            if not FlakyDeadClient.recovered:
                raise OSError("unreachable")
            return {
                "/d0": {"error_code": 0, "replicas": {("T0", 0): 10},
                        "future_replicas": set()},
            }

    admin = KafkaClusterAdmin(FlakyDeadClient())
    admin._logdir_move_brokers = {7}
    admin._last_futures = {7: {("T0", 0, 7)}}
    # while failing: copies stay pending (a timeout is not completion)
    for _ in range(admin._max_describe_failures + 1):
        assert admin.in_progress_logdir_moves() == {("T0", 0, 7)}
    # backed off: most polls do NOT dial, pending still reported
    before = FlakyDeadClient.calls
    for _ in range(admin._probe_every - 1):
        assert admin.in_progress_logdir_moves() == {("T0", 0, 7)}
    assert FlakyDeadClient.calls == before
    # broker recovers; the next probe observes the landed copy
    FlakyDeadClient.recovered = True
    for _ in range(admin._probe_every + 1):
        pending = admin.in_progress_logdir_moves()
    assert pending == set()
    assert admin.logdir_of("T0", 0, 7) == 0


# ------------------------- the simulated service (tests/test_intra_moves.py :302)


def test_partition_size_detection_enabled_via_config():
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.service.main import build_simulated_service

    config = CruiseControlConfig({
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "webserver.http.port": 0,
        "tpu.num.candidates": 128,
        "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 8,
        "tpu.num.rounds": 2,
        "partition.size.detection.enabled": "true",
        "self.healing.partition.size.threshold.byte": "1",  # everything flags
    })
    app, *_ = build_simulated_service(config, seed=5, device="cpu")
    records = app.cc.anomaly_detector.run_once()
    kinds = {type(r.anomaly).__name__ for r in records}
    assert "TopicPartitionSizeAnomaly" in kinds
