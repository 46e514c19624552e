"""The port's executor (cruise_control_tpu_torch.executor) on the CPU.

tests/test_executor.py's 18 tests, pointed at the port:
test_planner_concurrency_and_fairness, test_strategy_ordering,
test_execute_replica_and_leader_moves, test_throttle_set_and_cleared,
test_per_broker_concurrency_cap, test_force_stop_aborts,
test_dead_destination_marks_task_dead, test_ongoing_execution_guard,
test_optimizer_to_executor_full_loop (the monitor -> optimize -> execute
loop, the model and the optimizer on the CPU), test_dropped_reassignments_are_reexecuted,
test_reexecution_bound_marks_task_dead, test_mid_execution_concurrency_change,
test_mid_execution_concurrency_decrease,
test_concurrency_change_rejected_when_idle,
test_progress_check_interval_change_mid_execution,
test_graceful_stop_drains_in_flight,
test_leader_movement_timeout_declares_dead and
test_force_stop_with_slow_and_hung_admin.  The simulated cluster backend
stands in for embedded brokers, as in the reference's
ExecutionTaskPlannerTest + ExecutorTest.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor import (
    ExecutionOptions,
    ExecutionTaskPlanner,
    Executor,
    ExecutorState,
    NoOngoingExecutionError,
    OngoingExecutionError,
    PrioritizeLargeReplicaMovementStrategy,
    PrioritizeSmallReplicaMovementStrategy,
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


def proposal(topic, part, old, new, old_leader=None, new_leader=None, data=100.0):
    return ExecutionProposal(
        partition=part,
        topic=topic,
        old_leader=old[0] if old_leader is None else old_leader,
        new_leader=new[0] if new_leader is None else new_leader,
        old_replicas=tuple(old),
        new_replicas=tuple(new),
        inter_broker_data_to_move=data,
    )


def topo_4brokers(partitions):
    brokers = tuple(BrokerNode(i, rack=f"r{i % 2}", host=f"h{i}") for i in range(4))
    return ClusterTopology(brokers=brokers, partitions=tuple(partitions))


@pytest.fixture()
def sim():
    parts = [
        PartitionInfo("T0", 0, leader=0, replicas=(0, 1)),
        PartitionInfo("T0", 1, leader=1, replicas=(1, 2)),
        PartitionInfo("T1", 0, leader=2, replicas=(2, 3)),
        PartitionInfo("T1", 1, leader=3, replicas=(3, 0)),
    ]
    meta = StaticMetadataProvider(topo_4brokers(parts))
    return SimulatedClusterAdmin(meta, link_rate_bytes_per_s=200.0)


def test_planner_concurrency_and_fairness():
    pl = ExecutionTaskPlanner()
    props = [proposal(0, i, [0, 1], [0, 2], data=10.0 * (i + 1)) for i in range(6)]
    pl.add_execution_proposals(props)
    # broker 1 (drop) and 2 (add) involved in every move; cap 2 each
    tasks = pl.get_inter_broker_replica_movement_tasks({0: 5, 1: 2, 2: 2, 3: 5}, set())
    assert len(tasks) == 2
    assert len(pl.remaining_inter_broker_moves) == 4
    # in-progress partitions are excluded
    tasks2 = pl.get_inter_broker_replica_movement_tasks(
        {1: 5, 2: 5}, {(0, tasks[0].proposal.partition)}
    )
    assert all(t.proposal.partition != tasks[0].proposal.partition for t in tasks2)


def test_strategy_ordering():
    props = [proposal(0, i, [0], [1], data=d) for i, d in enumerate([50.0, 200.0, 100.0])]
    pl = ExecutionTaskPlanner(PrioritizeLargeReplicaMovementStrategy())
    pl.add_execution_proposals(props)
    sizes = [t.proposal.inter_broker_data_to_move for t in pl.remaining_inter_broker_moves]
    assert sizes == sorted(sizes, reverse=True)
    pl2 = ExecutionTaskPlanner(PrioritizeSmallReplicaMovementStrategy())
    pl2.add_execution_proposals(props)
    sizes2 = [t.proposal.inter_broker_data_to_move for t in pl2.remaining_inter_broker_moves]
    assert sizes2 == sorted(sizes2)


def test_execute_replica_and_leader_moves(sim):
    ex = Executor(sim, topic_names={0: "T0", 1: "T1"})
    props = [
        proposal(0, 0, [0, 1], [2, 1], old_leader=0, new_leader=2, data=100.0),
        proposal(1, 0, [2, 3], [2, 3], old_leader=2, new_leader=3, data=0.0),  # leader only
    ]
    res = ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=0.5))
    # proposal 0 emits a replica task + a leadership task; proposal 1 one task
    assert res.completed == 3 and res.dead == 0
    topo = sim.topology()
    by_key = {(p.topic, p.partition): p for p in topo.partitions}
    assert set(by_key[("T0", 0)].replicas) == {1, 2}
    assert by_key[("T0", 0)].leader == 2
    assert by_key[("T1", 0)].leader == 3
    assert ex.state == ExecutorState.NO_TASK_IN_PROGRESS
    assert sim.election_calls >= 1


def test_throttle_set_and_cleared(sim):
    observed = []
    orig_tick = sim.tick

    def spy_tick(seconds):
        observed.append(sim.throttle_rate)
        return orig_tick(seconds)

    sim.tick = spy_tick
    ex = Executor(sim, topic_names={0: "T0"})
    props = [proposal(0, 0, [0, 1], [2, 1], data=500.0)]
    ex.execute_proposals(
        props,
        ExecutionOptions(
            replication_throttle_bytes_per_s=100.0, progress_check_interval_s=1.0
        ),
    )
    assert observed and all(r == 100.0 for r in observed)
    assert sim.throttle_rate is None  # cleared afterwards
    # throttled rate (100/s) on 500 bytes -> at least 5 ticks
    assert len(observed) >= 5


def test_per_broker_concurrency_cap(sim):
    # all proposals touch broker 0 -> cap 1 means strictly serial execution
    parts = [PartitionInfo("T0", i, leader=0, replicas=(0, 1)) for i in range(4)]
    meta = StaticMetadataProvider(topo_4brokers(parts))
    admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1000.0)
    max_concurrent = []
    orig = admin.tick

    def spy(seconds):
        max_concurrent.append(len(admin.in_progress_reassignments()))
        return orig(seconds)

    admin.tick = spy
    ex = Executor(admin, topic_names={0: "T0"})
    props = [proposal(0, i, [0, 1], [2, 1], data=1000.0) for i in range(4)]
    res = ex.execute_proposals(
        props,
        ExecutionOptions(
            concurrent_partition_movements_per_broker=1, progress_check_interval_s=1.0
        ),
    )
    # 4 replica tasks + 4 leadership tasks (leader 0 left the replica set)
    assert res.completed == 8
    assert max(max_concurrent) == 1


def test_force_stop_aborts(sim):
    ex = Executor(sim, topic_names={0: "T0"})
    orig = sim.tick
    calls = []

    def stop_after_2(seconds):
        calls.append(1)
        if len(calls) == 2:
            ex.stop_execution(force=True)
        return orig(seconds)

    sim.tick = stop_after_2
    props = [proposal(0, i, [0, 1], [2, 1], data=10_000.0) for i in range(2)]
    res = ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=1.0))
    assert res.stopped
    assert res.aborted >= 1
    assert sim.in_progress_reassignments() == set()


def test_dead_destination_marks_task_dead(sim):
    ex = Executor(sim, topic_names={0: "T0"})
    orig = sim.tick
    calls = []

    def kill_broker_2(seconds):
        calls.append(1)
        if len(calls) == 1:
            topo = sim.metadata.topology()
            brokers = tuple(
                dataclasses.replace(b, alive=(b.broker_id != 2)) for b in topo.brokers
            )
            sim.metadata.set_topology(dataclasses.replace(topo, brokers=brokers))
        return orig(seconds)

    sim.tick = kill_broker_2
    props = [proposal(0, 0, [0, 1], [2, 1], data=100_000.0)]
    res = ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=1.0))
    # the replica move to dead broker 2 is DEAD, and so is the leadership
    # transfer onto it (its election can never be confirmed)
    assert res.dead == 2
    assert res.completed == 0


def test_ongoing_execution_guard(sim):
    ex = Executor(sim)
    ex.state = ExecutorState.STARTING_EXECUTION
    with pytest.raises(OngoingExecutionError):
        ex.execute_proposals([proposal(0, 0, [0], [1])])


def test_optimizer_to_executor_full_loop():
    """Monitor-model -> optimizer -> executor -> topology reflects proposals
    (the SURVEY §3.3 rebalance stack minus HTTP)."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.monitor import (
        FixedCapacityResolver,
        LoadMonitor,
        MetricFetcherManager,
        ModelCompletenessRequirements,
        StaticMetadataProvider as SMP,
        WindowedMetricSampleAggregator,
        KAFKA_METRIC_DEF,
    )
    from cruise_control_tpu_torch.testing.synthetic import (
        SyntheticWorkloadSampler,
        WorkloadSpec,
        synthetic_topology,
    )

    topo = synthetic_topology(num_brokers=5, topics={"T0": 10, "T1": 10}, seed=5)
    meta = SMP(topo)
    sampler = SyntheticWorkloadSampler(topo, WorkloadSpec(), seed=5)
    agg = WindowedMetricSampleAggregator(3, 1000, 1, KAFKA_METRIC_DEF)
    fetcher = MetricFetcherManager(sampler, agg, None)
    parts = sampler.all_partition_entities()
    for w in range(4):
        fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
    monitor = LoadMonitor(meta, FixedCapacityResolver([100.0, 1e5, 1e5, 1e6]), agg, device="cpu")
    state = monitor.cluster_model(ModelCompletenessRequirements(min_required_num_windows=2))

    cfg = OptimizerConfig(
        num_candidates=128, leadership_candidates=32, steps_per_round=16, num_rounds=2
    )
    res = GoalOptimizer(config=cfg, device="cpu").optimize(state)
    if not res.proposals:
        pytest.skip("optimizer found nothing to move on this fixture")

    admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1e12)
    ex = Executor(admin, catalog=monitor.last_catalog)
    out = ex.execute_proposals(res.proposals, ExecutionOptions(progress_check_interval_s=1.0))
    assert out.dead == 0 and out.completed > 0

    # post-execution topology must match the optimizer's target placement
    after = meta.topology()
    by_key = {(p.topic, p.partition): p for p in after.partitions}
    for p in res.proposals:
        got = by_key[monitor.last_catalog.partition_key(p.partition)]
        assert set(got.replicas) == set(p.new_replicas)
        if p.new_leader >= 0:
            assert got.leader == p.new_leader


def test_dropped_reassignments_are_reexecuted(sim):
    """A reassignment the controller silently drops must be detected (the
    target placement never landed) and re-submitted until it completes —
    reference Executor.maybeReexecuteTasks:1430."""
    ex = Executor(sim, topic_names={0: "T0", 1: "T1"})
    sim._drop_once.update({("T0", 0), ("T1", 0)})
    props = [
        proposal(0, 0, [0, 1], [2, 1], old_leader=0, new_leader=2, data=100.0),
        proposal(0, 1, [1, 2], [1, 3], old_leader=1, new_leader=1, data=100.0),
        proposal(1, 0, [2, 3], [0, 3], old_leader=2, new_leader=0, data=100.0),
    ]
    res = ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=0.5))
    assert sim.dropped_reassignments == [("T0", 0), ("T1", 0)]
    assert res.dead == 0 and res.completed == len(ex.tracker.tasks())
    by_key = {(p.topic, p.partition): set(p.replicas) for p in sim.topology().partitions}
    assert by_key[("T0", 0)] == {2, 1}
    assert by_key[("T0", 1)] == {1, 3}
    assert by_key[("T1", 0)] == {0, 3}
    state = ex.executor_state()
    assert state["numReexecutedTasks"] == 2
    assert state["taskStatus"]["INTER_BROKER_REPLICA_ACTION"] == {"COMPLETED": 3}


def test_reexecution_bound_marks_task_dead(sim):
    """A reassignment dropped more times than max_reexecution_attempts goes
    DEAD instead of looping forever (ExecutionTask.java:26-40 DEAD state)."""
    ex = Executor(sim, topic_names={0: "T0"})
    sim._drop_once.add(("T0", 0))
    props = [proposal(0, 0, [0, 1], [2, 1], old_leader=0, new_leader=2, data=100.0)]
    res = ex.execute_proposals(
        props,
        ExecutionOptions(progress_check_interval_s=0.5, max_reexecution_attempts=0),
    )
    assert res.dead == 1
    dead = ex.tracker.tasks(state=TaskState.DEAD)
    assert len(dead) == 1 and dead[0].task_type == TaskType.INTER_BROKER_REPLICA_ACTION
    # the topology still shows the OLD placement (the move never landed)
    by_key = {(p.topic, p.partition): set(p.replicas) for p in sim.topology().partitions}
    assert by_key[("T0", 0)] == {0, 1}


def test_mid_execution_concurrency_change(sim):
    """Operator raises the per-broker cap on a LIVE execution via
    set_requested_concurrency (reference Executor.java:485-510,
    driven by POST /admin) — the change applies on the next tick."""
    parts = [PartitionInfo("T0", i, leader=0, replicas=(0, 1)) for i in range(4)]
    meta = StaticMetadataProvider(topo_4brokers(parts))
    admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1000.0)
    concurrent = []
    orig = admin.tick

    def spy(seconds):
        concurrent.append(len(admin.in_progress_reassignments()))
        if len(concurrent) == 6:
            ex.set_requested_concurrency(inter_broker=4)
        return orig(seconds)

    admin.tick = spy
    ex = Executor(admin, topic_names={0: "T0"})
    props = [proposal(0, i, [0, 1], [2, 1], data=3000.0) for i in range(4)]
    res = ex.execute_proposals(
        props,
        ExecutionOptions(
            concurrent_partition_movements_per_broker=1, progress_check_interval_s=1.0
        ),
    )
    assert res.completed == len(ex.tracker.tasks()) and res.dead == 0
    # before the change: strictly serial; after: parallel drains appear
    assert max(concurrent[:6]) == 1
    assert max(concurrent[6:]) > 1
    # the override is reported in STATE and dies with the next execution
    assert ex.executor_state()["requestedConcurrency"] == {"inter_broker": 4}
    ex.execute_proposals([], ExecutionOptions())
    assert ex.requested_concurrency() == {}


def test_mid_execution_concurrency_decrease(sim):
    """Lowering the cap mid-flight throttles NEW submissions immediately
    (in-flight moves finish, but the steady state honors the new cap)."""
    parts = [PartitionInfo("T0", i, leader=0, replicas=(0, 1)) for i in range(8)]
    meta = StaticMetadataProvider(topo_4brokers(parts))
    admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1000.0)
    concurrent = []
    orig = admin.tick

    def spy(seconds):
        concurrent.append(len(admin.in_progress_reassignments()))
        if len(concurrent) == 2:
            ex.set_requested_concurrency(inter_broker=1)
        return orig(seconds)

    admin.tick = spy
    ex = Executor(admin, topic_names={0: "T0"})
    props = [proposal(0, i, [0, 1], [2, 1], data=3000.0) for i in range(8)]
    res = ex.execute_proposals(
        props,
        ExecutionOptions(
            concurrent_partition_movements_per_broker=4, progress_check_interval_s=1.0
        ),
    )
    assert res.completed == len(ex.tracker.tasks()) and res.dead == 0
    assert max(concurrent[:2]) == 4
    # once the initial burst drains, the loop never again exceeds 1
    drained = next(i for i, c in enumerate(concurrent) if i >= 2 and c <= 1)
    assert max(concurrent[drained:]) <= 1


def test_concurrency_change_rejected_when_idle(sim):
    """set_requested_concurrency raises atomically (under the executor
    lock) when nothing is executing — an execution finishing between the
    caller's check and the call must yield a loud error, not a lingering
    no-op override (ADVICE r4: /admin TOCTOU)."""
    ex = Executor(sim, topic_names={0: "T0"})
    with pytest.raises(NoOngoingExecutionError):
        ex.set_requested_concurrency(inter_broker=4)
    assert ex.requested_concurrency() == {}
    # validation still precedes the liveness check: bad values always raise
    with pytest.raises(ValueError):
        ex.set_requested_concurrency(inter_broker=0)


def test_progress_check_interval_change_mid_execution(sim):
    """execution_progress_check_interval_ms applies to the running loop."""
    intervals = []
    orig = sim.tick

    def spy(seconds):
        intervals.append(seconds)
        if len(intervals) == 2:
            ex.set_requested_concurrency(progress_check_interval_s=0.25)
        return orig(seconds)

    sim.tick = spy
    ex = Executor(sim, topic_names={0: "T0"})
    props = [proposal(0, 0, [0, 1], [2, 1], data=5000.0)]
    ex.execute_proposals(props, ExecutionOptions(progress_check_interval_s=1.0))
    assert intervals[:2] == [1.0, 1.0]
    assert set(intervals[3:]) == {0.25}


def test_graceful_stop_drains_in_flight(sim):
    """A non-forced stop submits nothing new but WAITS for in-flight moves
    to land, so no task is left IN_PROGRESS and the result counts add up
    (completed + aborted + dead == total)."""
    parts = [PartitionInfo("T0", i, leader=0, replicas=(0, 1)) for i in range(4)]
    meta = StaticMetadataProvider(topo_4brokers(parts))
    admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1000.0)
    orig = admin.tick
    calls = []

    def stop_after_1(seconds):
        calls.append(1)
        if len(calls) == 1:
            ex.stop_execution(force=False)
        return orig(seconds)

    admin.tick = stop_after_1
    ex = Executor(admin, topic_names={0: "T0"})
    props = [proposal(0, i, [0, 1], [2, 1], data=3000.0) for i in range(4)]
    res = ex.execute_proposals(
        props,
        ExecutionOptions(
            concurrent_partition_movements_per_broker=2, progress_check_interval_s=1.0
        ),
    )
    assert res.stopped
    total = len(ex.tracker.tasks())
    assert res.completed + res.aborted + res.dead == total
    assert not ex.tracker.tasks(state=TaskState.IN_PROGRESS)
    # the 2 in-flight moves were allowed to finish (graceful semantics)
    assert res.completed >= 2
    # and the topology reflects exactly the completed moves
    by_key = {(p.topic, p.partition): set(p.replicas) for p in admin.topology().partitions}
    moved = sum(1 for i in range(4) if by_key[("T0", i)] == {2, 1})
    assert moved == sum(
        1 for t in ex.tracker.tasks(state=TaskState.COMPLETED)
        if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION
    )


# ---------------------------------------------------------------- fault-
# injection coverage (testing/faults.py): dead-task timeout paths and
# force-stop under a misbehaving admin


def test_leader_movement_timeout_declares_dead(sim):
    """A leadership election the controller accepts but never performs
    (injected drop) must go DEAD at leader.movement.timeout.ms instead of
    spinning the confirmation loop until max_ticks."""
    from cruise_control_tpu_torch.common.sensors import SensorRegistry
    from cruise_control_tpu_torch.testing import faults

    sensors = SensorRegistry()
    ex = Executor(sim, topic_names={0: "T0"}, sensors=sensors)
    # leadership-only move: replicas unchanged, leader 0 -> 1
    props = [proposal(0, 0, [0, 1], [0, 1], old_leader=0, new_leader=1)]
    with faults.method_fault(sim, "elect_leaders", faults.dropping()) as log:
        res = ex.execute_proposals(
            props,
            ExecutionOptions(
                leader_movement_timeout_s=3.0, progress_check_interval_s=1.0
            ),
        )
    assert log.fired["elect_leaders"] == 1
    assert res.dead == 1 and res.completed == 0
    assert sensors.counter("executor.leader-movement-timeout").count == 1
    # simulated clock: the wait burned the timeout window, not max_ticks
    assert res.ticks <= 10


def test_force_stop_with_slow_and_hung_admin(sim):
    """stop_execution(force=True) mid-flight while the admin answers
    slowly (every progress probe injected +50ms) still aborts promptly:
    in-flight reassignments are cancelled, nothing stays IN_PROGRESS, and
    the executor returns well before the un-stopped execution would."""
    import threading
    import time as _time

    from cruise_control_tpu_torch.testing import faults

    ex = Executor(sim, topic_names={0: "T0"})
    # slow enough (200 B/s link, 100 MB each) that the execution cannot
    # finish on its own within the test
    props = [proposal(0, i, [0, 1], [2, 1], data=100e6) for i in range(4)]
    started = threading.Event()

    def progress_probe(orig, *a, **k):
        started.set()
        _time.sleep(0.05)
        return orig(*a, **k)

    box = {}

    def run():
        try:
            box["res"] = ex.execute_proposals(
                props, ExecutionOptions(progress_check_interval_s=0.01)
            )
        except Exception as e:  # pragma: no cover - surfaced by the assert below
            box["err"] = e

    with faults.method_fault(sim, "in_progress_reassignments", progress_probe):
        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert started.wait(10.0)
        ex.stop_execution(force=True)
        t.join(timeout=30.0)
    assert not t.is_alive(), "force stop did not terminate the execution"
    assert "err" not in box, box.get("err")
    res = box["res"]
    assert res.stopped
    assert sim.in_progress_reassignments() == set()  # cancelled on the wire
    assert not ex.tracker.tasks(state=TaskState.IN_PROGRESS)
    assert res.completed + res.aborted + res.dead == len(ex.tracker.tasks())
    assert not ex.has_ongoing_execution
