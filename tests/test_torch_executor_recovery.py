"""Crash-safe execution on the port: durable journal, restart
reconciliation, stuck-move reaper, load-aware adaptive concurrency.

tests/test_executor_recovery.py's tests, pointed at the port:
test_journal_replay_tolerates_torn_tail,
test_finished_execution_is_not_recovered,
test_crash_mid_inter_broker_move_recovers,
test_crash_mid_leadership_recovers,
test_crash_mid_intra_broker_logdir_move_recovers,
test_truncated_journal_replay_recovers, test_reservations_survive_crash,
test_new_execution_blocked_while_recovering,
test_reaper_rolls_back_stalled_move,
test_reaper_dead_when_controller_cannot_cancel,
test_reaper_off_by_default, test_adaptive_backoff_under_urp_spike,
test_concurrency_adjuster_aimd_unit,
test_adjuster_throughput_collapse_counts_as_stress,
test_kill_and_restart_acceptance_story,
test_aborting_task_in_journal_finalizes_as_aborted,
test_failed_throttle_sweep_stays_recoverable,
test_stop_during_recovering_is_honored,
test_resume_restores_journaled_adaptive_cap,
test_adaptive_not_fooled_by_intra_only_throughput,
test_execution_stuck_alert_not_delayed_by_busy_executor and
test_executor_injected_clock_drives_reservation_retention.
At the end, test_facade_wires_journal_and_recovery, over the port's
simulated service.

The matrix kills the executor "process" (testing/faults.process_crash: the
progress loop raises and the dying process's cleanup calls never reach the
cluster) at different execution phases, truncates the journal at arbitrary
byte offsets, and asserts a fresh Executor over the same journal
reconciles against the simulated cluster and resumes to completion —
zero duplicate submissions, zero leaked throttles, reservations intact.
"""

import os

import pytest

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.detector import AnomalyDetector, AnomalyType, SelfHealingNotifier
from cruise_control_tpu_torch.detector.anomalies import ExecutionStuck
from cruise_control_tpu_torch.executor import (
    ConcurrencyAdjuster,
    ExecutionJournal,
    ExecutionOptions,
    Executor,
    ExecutorState,
    OngoingExecutionError,
    SimulatedClusterAdmin,
    TaskState,
    TaskType,
)
from cruise_control_tpu_torch.monitor.topology import (
    BrokerNode,
    ClusterTopology,
    PartitionInfo,
    StaticMetadataProvider,
)
from cruise_control_tpu_torch.testing import faults
import json


def proposal(topic, part, old, new, old_leader=None, new_leader=None, data=100.0,
             disk_moves=(), intra_data=0.0):
    return ExecutionProposal(
        partition=part,
        topic=topic,
        old_leader=old[0] if old_leader is None else old_leader,
        new_leader=new[0] if new_leader is None else new_leader,
        old_replicas=tuple(old),
        new_replicas=tuple(new),
        disk_moves=tuple(disk_moves),
        inter_broker_data_to_move=data,
        intra_broker_data_to_move=intra_data,
    )


def make_cluster(num_partitions=4, link_rate=1000.0, intra_move_bytes=0.0):
    parts = [
        PartitionInfo("T0", i, leader=0, replicas=(0, 1))
        for i in range(num_partitions)
    ]
    brokers = tuple(BrokerNode(i, rack=f"r{i % 2}", host=f"h{i}") for i in range(4))
    meta = StaticMetadataProvider(ClusterTopology(brokers=brokers, partitions=tuple(parts)))
    return SimulatedClusterAdmin(
        meta, link_rate_bytes_per_s=link_rate, intra_move_bytes=intra_move_bytes
    )


def journal_at(tmp_path, name="journal.jsonl"):
    return ExecutionJournal(str(tmp_path / name))


def spy_submissions(admin):
    """Count reassignment submissions per partition key across processes."""
    counts: dict = {}
    orig = admin.reassign_partitions

    def wrapper(specs):
        for s in specs:
            counts[(s.topic, s.partition)] = counts.get((s.topic, s.partition), 0) + 1
        return orig(specs)

    admin.reassign_partitions = wrapper
    return counts


# ---------------------------------------------------------------- journal


def test_journal_replay_tolerates_torn_tail(tmp_path):
    j = journal_at(tmp_path)
    j.start_execution({"uuid": "u1", "ms": 0, "tasks": [], "options": {}})
    j.append({"t": "task", "id": 0, "state": "IN_PROGRESS", "ms": 1})
    j.flush()
    with open(j.path, "a") as f:
        f.write('{"t": "task", "id": 0, "sta')  # torn mid-record
    records = ExecutionJournal(j.path).replay()
    assert [r["t"] for r in records] == ["start", "task"]


def test_finished_execution_is_not_recovered(tmp_path):
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, 0, [0, 1], [2, 1], data=500.0)]
    res = ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=1.0))
    assert res.completed == len(ex.tracker.tasks())
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.state == ExecutorState.NO_TASK_IN_PROGRESS
    assert ex2.recovery_info() is None
    assert not ex2.has_recovered_execution


# ------------------------------------------------- crash/restart matrix


def test_crash_mid_inter_broker_move_recovers(tmp_path):
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, i, [0, 1], [2, 1], data=3000.0) for i in range(4)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[4])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(
                concurrent_partition_movements_per_broker=2,
                progress_check_interval_s=1.0,
                replication_throttle_bytes_per_s=5000.0,
            ))
    # the dead process left its throttle on the brokers + moves in flight
    assert admin.throttle_rate == 5000.0
    assert admin.in_progress_reassignments()

    counts = spy_submissions(admin)
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.state == ExecutorState.RECOVERING
    assert ex2.has_recovered_execution
    # startup sweep: the orphaned throttle is gone before anything resumes
    assert admin.throttle_rate is None
    info = ex2.recovery_info()
    assert info["sweptThrottle"] is True
    assert info["tasksReadopted"] >= 1

    res = ex2.resume_recovered_execution()
    assert res is not None and res.dead == 0
    assert res.completed == len(ex2.tracker.tasks())
    # re-adopted moves were NOT resubmitted: every submission in the second
    # process is for a task the first one never put on the wire
    assert all(n == 1 for n in counts.values())
    by_key = {(p.topic, p.partition): set(p.replicas)
              for p in admin.topology().partitions}
    assert all(by_key[("T0", i)] == {1, 2} for i in range(4))
    assert admin.throttle_rate is None  # resume cleared its own throttle
    assert ex2.state == ExecutorState.NO_TASK_IN_PROGRESS
    # a second restart finds a cleanly finished journal
    ex3 = Executor(admin, journal=journal_at(tmp_path))
    assert ex3.recovery_info() is None


def test_crash_mid_leadership_recovers(tmp_path):
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    # leadership-only moves: phase 2 territory
    props = [proposal(0, i, [0, 1], [0, 1], old_leader=0, new_leader=1)
             for i in range(3)]
    with faults.process_crash(admin, on="elect_leaders"):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=1.0))

    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.state == ExecutorState.RECOVERING
    res = ex2.resume_recovered_execution()
    assert res.completed == 3 and res.dead == 0
    leaders = {(p.topic, p.partition): p.leader for p in admin.topology().partitions}
    assert all(leaders[("T0", i)] == 1 for i in range(3))


def test_crash_mid_intra_broker_logdir_move_recovers(tmp_path):
    admin = make_cluster(intra_move_bytes=3000.0)
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, i, [0, 1], [0, 1], data=0.0,
                      disk_moves=((0, 0, 1),), intra_data=3000.0)
             for i in range(2)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[1])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(
                progress_check_interval_s=1.0,
                concurrent_intra_broker_partition_movements=2,
            ))
    assert admin.in_progress_logdir_moves()  # copies still draining

    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.state == ExecutorState.RECOVERING
    info = ex2.recovery_info()
    assert info["tasksReadopted"] >= 1
    res = ex2.resume_recovered_execution()
    assert res.dead == 0
    assert res.completed == len(ex2.tracker.tasks())
    done = ex2.tracker.tasks(
        task_type=TaskType.INTRA_BROKER_REPLICA_ACTION, state=TaskState.COMPLETED
    )
    assert len(done) == 2
    assert not admin.in_progress_logdir_moves()


def test_truncated_journal_replay_recovers(tmp_path):
    """Journal truncated at an arbitrary byte (fsync racing the crash):
    replay trusts the intact prefix; tasks whose completion record was
    lost re-reconcile against the topology instead of re-executing."""
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, i, [0, 1], [2, 1], data=2000.0) for i in range(4)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[3])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(
                concurrent_partition_movements_per_broker=2,
                progress_check_interval_s=1.0,
            ))
    path = str(tmp_path / "journal.jsonl")
    # cut mid-way into the record stream, torn final line included — but
    # keep the start record (without it there is nothing to recover)
    with open(path, "rb") as f:
        start_len = len(f.readline())
    size = os.path.getsize(path)
    faults.truncate_file(path, keep_bytes=max(start_len, size - (size - start_len) // 2))

    counts = spy_submissions(admin)
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.state == ExecutorState.RECOVERING
    res = ex2.resume_recovered_execution()
    assert res.dead == 0
    assert res.completed == len(ex2.tracker.tasks())
    # truncation may have erased IN_PROGRESS records, but never causes a
    # double submission: landed moves reconcile COMPLETED off the topology,
    # in-flight ones are re-adopted (the simulated admin REJECTS duplicate
    # submissions for an in-flight partition, so this would raise)
    assert all(n <= 1 for n in counts.values())
    by_key = {(p.topic, p.partition): set(p.replicas)
              for p in admin.topology().partitions}
    assert all(by_key[("T0", i)] == {1, 2} for i in range(4))


def test_reservations_survive_crash(tmp_path):
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, 0, [0, 1], [2, 1], data=5000.0)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[1])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(
                props, ExecutionOptions(progress_check_interval_s=1.0),
                removed_brokers={3}, demoted_brokers={1},
            )
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.removed_brokers == {3}
    assert ex2.demoted_brokers == {1}
    ex2.resume_recovered_execution()
    assert ex2.removed_brokers == {3}  # resume does not drop reservations


def test_new_execution_blocked_while_recovering(tmp_path):
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, 0, [0, 1], [2, 1], data=5000.0)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[1])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=1.0))
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.has_ongoing_execution  # RECOVERING counts as ongoing
    with pytest.raises(OngoingExecutionError):
        ex2.execute_proposals(props)
    ex2.resume_recovered_execution()
    assert not ex2.has_ongoing_execution


# ------------------------------------------------------ stuck-move reaper


def test_reaper_rolls_back_stalled_move(tmp_path):
    admin = make_cluster()
    sink: list = []
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path),
                  anomaly_sink=sink.append)
    admin.stall(("T0", 0))
    props = [proposal(0, i, [0, 1], [2, 1], data=1500.0) for i in range(3)]
    res = ex.execute_proposals(props, ExecutionOptions(
        progress_check_interval_s=1.0,
        reaper_stuck_timeout_s=3.0,
    ))
    # the stalled move was reaped via per-partition cancellation (rollback
    # to the original replica set), the rest of the batch kept flowing
    assert res.aborted >= 1
    assert res.dead == 0
    by_key = {(p.topic, p.partition): set(p.replicas)
              for p in admin.topology().partitions}
    assert by_key[("T0", 0)] == {0, 1}  # rolled back
    assert by_key[("T0", 1)] == {1, 2} and by_key[("T0", 2)] == {1, 2}
    assert len(sink) == 1
    anomaly = sink[0]
    assert isinstance(anomaly, ExecutionStuck)
    assert (anomaly.topic, anomaly.partition) == ("T0", 0)
    assert anomaly.rolled_back is True
    # journal carries the reap record (recovery-visible)
    records = journal_at(tmp_path).replay()
    assert any(r["t"] == "reaped" and r["mode"] == "rollback" for r in records)


class _NoCancelAdmin:
    """Delegating admin that hides per-partition cancellation — the
    pre-KIP-455 controller the reaper's DEAD fallback exists for."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "cancel_partition_reassignments":
            raise AttributeError(name)
        return getattr(self._inner, name)


def test_reaper_dead_when_controller_cannot_cancel():
    admin = make_cluster()
    ex = Executor(_NoCancelAdmin(admin), topic_names={0: "T0"})
    admin.stall(("T0", 0))
    props = [proposal(0, 0, [0, 1], [2, 1], old_leader=1, new_leader=1,
                      data=1500.0)]
    res = ex.execute_proposals(props, ExecutionOptions(
        progress_check_interval_s=1.0, reaper_stuck_timeout_s=3.0,
    ))
    assert res.dead == 1 and res.aborted == 0


def test_reaper_off_by_default():
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"})
    admin.stall(("T0", 0))
    props = [proposal(0, 0, [0, 1], [2, 1], old_leader=1, new_leader=1,
                      data=500.0)]
    res = ex.execute_proposals(props, ExecutionOptions(
        progress_check_interval_s=1.0, max_ticks=20,
    ))
    # without the reaper the stalled move just burns the loop to max_ticks
    # and stays IN_PROGRESS in the tracker — the pre-reaper behavior
    assert res.aborted == 0 and res.completed == 0 and res.dead == 0
    assert len(ex.tracker.tasks(state=TaskState.IN_PROGRESS)) == 1


# -------------------------------------- load-aware adaptive concurrency


def test_adaptive_backoff_under_urp_spike():
    """An URP spike mid-execution (injected broker death away from the
    moves) multiplicatively backs off the movement caps; concurrency
    observed on the wire drops accordingly."""
    import dataclasses as dc

    from cruise_control_tpu_torch.common.sensors import SensorRegistry

    admin = make_cluster(num_partitions=8, link_rate=1000.0)
    sensors = SensorRegistry()
    ex = Executor(admin, topic_names={0: "T0"}, sensors=sensors)
    concurrent = []
    orig = admin.tick

    def spy(seconds):
        concurrent.append(len(admin.in_progress_reassignments()))
        if len(concurrent) == 3:
            # broker 3 dies: its replicas go under-replicated (it is not a
            # party to any move, so nothing in flight is killed)
            topo = admin.metadata.topology()
            parts = list(topo.partitions) + [
                PartitionInfo("U0", 0, leader=3, replicas=(3,))
            ]
            brokers = tuple(
                dc.replace(b, alive=(b.broker_id != 3)) for b in topo.brokers
            )
            admin.metadata.set_topology(
                dc.replace(topo, brokers=brokers, partitions=tuple(parts))
            )
        return orig(seconds)

    admin.tick = spy
    props = [proposal(0, i, [0, 1], [2, 1], data=4000.0) for i in range(8)]
    res = ex.execute_proposals(props, ExecutionOptions(
        concurrent_partition_movements_per_broker=4,
        progress_check_interval_s=1.0,
        adaptive_enabled=True,
        adaptive_backoff_factor=0.5,
    ))
    assert res.completed == len(ex.tracker.tasks())
    assert sensors.counter("executor.adaptive.backoff").count >= 1
    # before the spike the drain ran at the full cap; afterwards new
    # submissions honored the backed-off cap
    assert max(concurrent[:3]) == 4
    assert sensors.counter("executor.adaptive.recovery").count >= 0


def test_concurrency_adjuster_aimd_unit():
    class _Topo:
        def __init__(self, urps):
            self._urps = urps
            self.partitions = [
                PartitionInfo("T", i, leader=9, replicas=(9,)) for i in range(urps)
            ]

        def alive_broker_ids(self):
            return {0, 1}

    adj = ConcurrencyAdjuster(
        base_inter=8, base_cluster=80, min_cap=1, max_cap=16,
        backoff_factor=0.5, recover_step=1, urp_slack=0, stall_ticks=0,
    )
    assert adj.caps() == (8, 80)
    adj.observe(_Topo(0), completed=1, in_flight=2)  # baseline tick
    inter, cluster = adj.observe(_Topo(3), completed=0, in_flight=2)  # spike
    assert inter == 4 and cluster == 40  # multiplicative, cluster scales
    inter, _ = adj.observe(_Topo(3), completed=0, in_flight=2)
    assert inter == 2
    # spike clears: additive recovery toward the base, one step per tick
    inter, _ = adj.observe(_Topo(0), completed=1, in_flight=2)
    assert inter == 3
    for _ in range(10):
        inter, cluster = adj.observe(_Topo(0), completed=1, in_flight=2)
    assert (inter, cluster) == (8, 80)  # never overshoots the base
    assert adj.num_backoffs == 2


def test_adjuster_throughput_collapse_counts_as_stress():
    class _Topo:
        partitions = []

        @staticmethod
        def alive_broker_ids():
            return {0}

    adj = ConcurrencyAdjuster(
        base_inter=8, base_cluster=80, stall_ticks=3, backoff_factor=0.5,
    )
    adj.observe(_Topo, completed=1, in_flight=1)
    for _ in range(2):
        inter, _ = adj.observe(_Topo, completed=0, in_flight=1)
    assert inter == 8  # not yet: 2 idle ticks < 3
    inter, _ = adj.observe(_Topo, completed=0, in_flight=1)
    assert inter == 4  # third consecutive idle tick backs off


# ------------------------------------------------------ acceptance story


def test_kill_and_restart_acceptance_story(tmp_path):
    """ISSUE 4 acceptance: mixed inter-broker + leadership execution
    crashed mid-flight, journal truncated at an arbitrary record, fresh
    Executor replays + reconciles + resumes to completion — zero duplicate
    submissions, zero leaked throttles, reservations intact — and a
    stalled move is reaped into EXECUTION_STUCK (delivered via the
    notifier) without blocking the remaining tasks."""
    parts = [PartitionInfo("T0", i, leader=0, replicas=(0, 1)) for i in range(6)]
    brokers = tuple(BrokerNode(i, rack=f"r{i % 2}", host=f"h{i}") for i in range(4))
    meta = StaticMetadataProvider(ClusterTopology(brokers=brokers, partitions=tuple(parts)))
    admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1000.0)
    counts = spy_submissions(admin)

    options = ExecutionOptions(
        concurrent_partition_movements_per_broker=2,
        progress_check_interval_s=1.0,
        replication_throttle_bytes_per_s=4000.0,
        reaper_stuck_timeout_s=4.0,
    )
    # 4 inter-broker moves (one of them permanently stalled; leader 1 stays
    # so each is a pure replica action) + 2 leadership-only transfers
    props = [proposal(0, i, [0, 1], [2, 1], old_leader=1, new_leader=1,
                      data=2500.0) for i in range(4)]
    props += [proposal(0, i, [0, 1], [0, 1], old_leader=0, new_leader=1)
              for i in (4, 5)]
    admin.stall(("T0", 0))

    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[2])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, options, removed_brokers={3})
    assert admin.throttle_rate == 4000.0  # leaked by the "dead" process
    # crash-truncate the journal at an arbitrary record boundary
    path = str(tmp_path / "journal.jsonl")
    faults.truncate_file(path, drop_bytes=17)

    # --- restart: fresh executor, anomaly pipeline wired like the facade
    notifier = SelfHealingNotifier()
    detector = AnomalyDetector(notifier, type("A", (), {"is_busy": False})())
    ex2 = Executor(admin, journal=journal_at(tmp_path),
                   anomaly_sink=detector.add_anomaly)
    assert ex2.state == ExecutorState.RECOVERING
    assert admin.throttle_rate is None  # startup sweep
    assert ex2.removed_brokers == {3}  # reservation intact
    assert ex2.executor_state()["state"] == "RECOVERING"

    res = ex2.resume_recovered_execution()
    assert res is not None
    total = len(ex2.tracker.tasks())
    assert total == 6
    # the stalled move was reaped (rollback -> ABORTED); everything else
    # ran to completion — the reaper did not block the batch
    assert res.aborted == 1
    assert res.completed == total - 1
    assert res.dead == 0
    assert ex2.tracker.tasks(state=TaskState.IN_PROGRESS) == []
    # zero duplicate submissions across both processes
    assert all(n == 1 for n in counts.values()), counts
    # zero leaked throttles
    assert admin.throttle_rate is None and admin.throttled_topics == set()
    # placements: stalled partition rolled back, the others landed
    by_key = {(p.topic, p.partition): p for p in admin.topology().partitions}
    assert set(by_key[("T0", 0)].replicas) == {0, 1}
    for i in (1, 2, 3):
        assert set(by_key[("T0", i)].replicas) == {1, 2}
    for i in (4, 5):
        assert by_key[("T0", i)].leader == 1
    # EXECUTION_STUCK delivered through the detector/notifier pipeline
    records = detector.run_once()
    stuck = [r for r in records
             if r.anomaly.anomaly_type == AnomalyType.EXECUTION_STUCK]
    assert len(stuck) == 1 and stuck[0].status == "IGNORED"
    assert len(notifier.alerts) == 1
    alert_anomaly, auto_fix = notifier.alerts[0]
    assert isinstance(alert_anomaly, ExecutionStuck) and auto_fix is False
    # reservations survived the whole story
    assert ex2.removed_brokers == {3}
    # the journal ends cleanly: a third process has nothing to recover
    assert journal_at(tmp_path).unfinished_execution() is None
    assert any(r["t"] == "finished"
               for r in journal_at(tmp_path).replay())


def test_aborting_task_in_journal_finalizes_as_aborted(tmp_path):
    """A crash between the ABORTING and ABORTED journal records (reaper or
    force-stop mid-cancellation) must finalize the task as ABORTED on
    recovery — never resubmit a deliberately-cancelled move, and never
    crash construction on an illegal ABORTING->COMPLETED transition."""
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, 0, [0, 1], [2, 1], old_leader=1, new_leader=1,
                      data=5000.0)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[1])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=1.0))
    # forge the torn-cancellation tail: ABORTING journaled, ABORTED lost
    j = journal_at(tmp_path)
    j.append({"t": "task", "id": 0, "state": "ABORTING", "ms": 1})
    j.close()
    counts = spy_submissions(admin)
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    res = ex2.resume_recovered_execution()
    aborted = ex2.tracker.tasks(state=TaskState.ABORTED)
    assert len(aborted) == 1 and aborted[0].execution_id == 0
    assert counts == {}  # the cancelled move was never resubmitted
    assert res is None or res.aborted == 1


def test_failed_throttle_sweep_stays_recoverable(tmp_path):
    """A sweep the admin rejects must NOT journal throttle_cleared — the
    next restart has to see the leak and retry."""
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, 0, [0, 1], [2, 1], old_leader=1, new_leader=1,
                      data=5000.0)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[1])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(
                progress_check_interval_s=1.0,
                replication_throttle_bytes_per_s=2000.0,
            ))
    assert admin.throttle_rate == 2000.0
    # restart #1: the admin rejects the sweep (still partitioned away)
    with faults.method_fault(admin, "clear_replication_throttle",
                             faults.raising(lambda: ConnectionError("nope"))):
        ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.recovery_info()["sweptThrottle"] is False
    assert admin.throttle_rate == 2000.0  # still leaked
    # restart #2 (ex2 abandoned before resuming): sweep retried and lands
    ex3 = Executor(admin, journal=journal_at(tmp_path))
    assert ex3.recovery_info()["sweptThrottle"] is True
    assert admin.throttle_rate is None
    ex3.resume_recovered_execution()


def test_stop_during_recovering_is_honored(tmp_path):
    """stop_execution issued while the executor sits RECOVERING must not
    be wiped by the resume — the resumed loop drains instead of driving
    the recovered execution to completion."""
    admin = make_cluster()
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    props = [proposal(0, i, [0, 1], [2, 1], old_leader=1, new_leader=1,
                      data=20_000.0) for i in range(4)]
    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[1])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(
                concurrent_partition_movements_per_broker=1,
                progress_check_interval_s=1.0,
            ))
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    assert ex2.state == ExecutorState.RECOVERING
    ex2.stop_execution(force=True)
    res = ex2.resume_recovered_execution()
    assert res.stopped
    assert res.completed == 0  # 20k bytes never finished in a drain
    assert res.aborted == len(ex2.tracker.tasks())
    assert admin.in_progress_reassignments() == set()  # force-cancelled


def test_resume_restores_journaled_adaptive_cap(tmp_path):
    """A resumed execution picks the adaptive cap back up from the journal
    instead of re-hitting a recently-stressed cluster at full base
    concurrency."""
    import dataclasses as dc

    admin = make_cluster(num_partitions=8)
    ex = Executor(admin, topic_names={0: "T0"}, journal=journal_at(tmp_path))
    calls = []
    orig = admin.tick

    def spy(seconds):
        calls.append(1)
        if len(calls) == 2:  # URP spike -> backoff journaled before crash
            topo = admin.metadata.topology()
            parts = list(topo.partitions) + [
                PartitionInfo("U0", 0, leader=3, replicas=(3,))
            ]
            brokers = tuple(
                dc.replace(b, alive=(b.broker_id != 3)) for b in topo.brokers
            )
            admin.metadata.set_topology(
                dc.replace(topo, brokers=brokers, partitions=tuple(parts))
            )
        return orig(seconds)

    admin.tick = spy
    props = [proposal(0, i, [0, 1], [2, 1], old_leader=1, new_leader=1,
                      data=20_000.0) for i in range(8)]
    with faults.process_crash(admin, on="reassign_partitions",
                              schedule=faults.FaultSchedule(after=2)):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex.execute_proposals(props, ExecutionOptions(
                concurrent_partition_movements_per_broker=4,
                progress_check_interval_s=1.0,
                adaptive_enabled=True,
            ))
    records = journal_at(tmp_path).replay()
    journaled = [r for r in records if r["t"] == "concurrency"]
    assert journaled, "backoff should have been journaled before the crash"
    ex2 = Executor(admin, journal=journal_at(tmp_path))
    seen_caps = []
    orig2 = admin.tick

    def spy2(seconds):
        adj = ex2._adjuster
        if adj is not None:
            seen_caps.append(adj.inter_cap)
        return orig2(seconds)

    admin.tick = spy2
    ex2.resume_recovered_execution()
    # the resumed adjuster started from the journaled (backed-off) cap —
    # at most one additive recovery step above it by the first tick —
    # not from the base of 4
    assert seen_caps, "adjuster never observed"
    assert seen_caps[0] <= journaled[-1]["inter"] + 1
    assert seen_caps[0] < 4


def test_adaptive_not_fooled_by_intra_only_throughput():
    """Intra-broker logdir completions count as throughput: a healthy
    intra-heavy execution must not trip the stall signal."""
    from cruise_control_tpu_torch.common.sensors import SensorRegistry

    admin = make_cluster(intra_move_bytes=2000.0)
    sensors = SensorRegistry()
    ex = Executor(admin, topic_names={0: "T0"}, sensors=sensors)
    props = [proposal(0, i, [0, 1], [0, 1], data=0.0,
                      disk_moves=((0, 0, 1),), intra_data=2000.0)
             for i in range(4)]
    res = ex.execute_proposals(props, ExecutionOptions(
        progress_check_interval_s=1.0,
        concurrent_intra_broker_partition_movements=1,
        adaptive_enabled=True,
        adaptive_stall_ticks=3,  # copies complete every 2 ticks
    ))
    assert res.completed == 4
    assert sensors.counter("executor.adaptive.backoff").count == 0


def test_execution_stuck_alert_not_delayed_by_busy_executor():
    """EXECUTION_STUCK fires mid-execution, while the executor is by
    definition busy — the alert must go out immediately, not park in the
    detector's busy re-check queue until the execution ends."""
    notifier = SelfHealingNotifier()
    detector = AnomalyDetector(notifier, type("A", (), {"is_busy": True})())
    detector.add_anomaly(ExecutionStuck(topic="T0", partition=0, stalled_s=9.0))
    records = detector.run_once()
    assert len(records) == 1 and records[0].status == "IGNORED"
    assert len(notifier.alerts) == 1  # alerted despite the busy executor


# ----------------------------------------------- facade/service wiring


def test_executor_injected_clock_drives_reservation_retention():
    """Satellite: _pruned rides the injected clock, so simulated time
    controls reservation expiry (no real sleeps)."""
    admin = make_cluster()
    now = {"ms": 1_000_000}
    ex = Executor(admin, topic_names={0: "T0"}, clock=lambda: now["ms"],
                  removal_history_retention_ms=5_000)
    ex.execute_proposals([], removed_brokers={2})
    assert ex.removed_brokers == {2}
    now["ms"] += 4_999
    assert ex.removed_brokers == {2}
    now["ms"] += 2
    assert ex.removed_brokers == set()


# ------------------------- the facade's journal wiring (tests/test_executor_recovery.py :700)


def test_facade_wires_journal_and_recovery(tmp_path):
    """build_simulated_service with executor.journal.dir: executions
    journal + finish cleanly; a second facade over the same dir starts
    clean (no recovery) and /state carries the executor block."""
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.service.main import build_simulated_service

    cfg = {
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "execution.progress.check.interval.ms": 100,
        "webserver.http.port": 0,
        "tpu.num.candidates": 64,
        "tpu.leadership.candidates": 16,
        "tpu.steps.per.round": 8,
        "tpu.num.rounds": 1,
        "executor.journal.dir": str(tmp_path),
    }
    app, fetcher, admin, sampler = build_simulated_service(CruiseControlConfig(cfg), device="cpu")
    cc = app.cc
    assert cc.executor.journal is not None
    assert cc.executor.anomaly_sink == cc.anomaly_detector.add_anomaly
    opts = cc._exec_options({})
    assert opts.reaper_stuck_timeout_s == 900.0
    assert opts.adaptive_enabled is True
    cc.executor.topic_names = {0: "T0"}  # fixture-built proposal below
    res = cc.executor.execute_proposals(
        [proposal(0, 0, [0, 1], [2, 1], old_leader=1, new_leader=1, data=10.0)],
        opts,
    )
    assert res.completed == len(cc.executor.tracker.tasks())
    journal_path = os.path.join(str(tmp_path), "execution-journal.jsonl")
    assert os.path.exists(journal_path)
    records = [json.loads(line) for line in open(journal_path)]
    assert records[0]["t"] == "start" and records[-1]["t"] == "finished"
    # restart: nothing to recover
    app2, *_ = build_simulated_service(CruiseControlConfig(cfg), device="cpu")
    assert app2.cc.executor.recovery_info() is None
