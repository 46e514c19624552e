"""Fleet HA on the port: the leases (fleet/leases.py) and the fencing seams
of the port's executor, journal and admin, on the CPU.

tests/test_fleet_ha.py's tests, pointed at the port:
test_lease_store_acquire_renew_expire,
test_lease_store_epochs_survive_restart,
test_epoch_floor_survives_lease_file_loss,
test_fence_is_time_based_not_event_based,
test_lease_manager_loss_and_reacquire_callbacks,
test_lease_manager_validates_timings,
test_journal_append_stamps_and_checks_epoch,
test_replay_drops_zombie_writes_below_high_water,
test_fenced_cluster_admin_blocks_mutations_passes_reads,
test_fenced_executor_aborts_batch_cleanly,
test_fenced_start_does_not_wedge_executor,
test_journal_rotation_archives_terminal_executions,
test_journal_prune_respects_count_and_hours,
test_prune_never_touches_unfinished_journals,
test_executor_reconciliation_prunes_archives,
test_zero_length_journal_is_no_unfinished_execution,
test_torn_first_line_journal_is_no_unfinished_execution,
test_lease_partition_fail_injector_accounting,
test_lease_partition_hang_injector_releases_on_exit,
test_clock_skew_injector and test_chaos_schedule_single_holder_invariant.
At the end, over the port's simulated fleet service:
test_ha_disabled_default_is_classic_fleet,
test_kill_and_takeover_acceptance_story and
test_zombie_writer_is_fenced_everywhere (the last two marked slow, as in
the JAX package).

The invariants: at most one lease holder per cluster at any instant
(provable from the lease store's audit trail); a fenced zombie can neither
append to the journal nor mutate the cluster; a fenced start does not
wedge the executor; journal retention never prunes an unfinished journal.
"""

import json
import os
import time

import pytest

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor import (
    ExecutionJournal,
    ExecutionOptions,
    Executor,
    ExecutorState,
)
from cruise_control_tpu_torch.executor.admin import FencedClusterAdmin, SimulatedClusterAdmin
from cruise_control_tpu_torch.fleet.leases import (
    FencedError,
    FileLeaseStore,
    LeaseManager,
    single_holder_violations,
)
from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
from cruise_control_tpu_torch.testing import faults
from cruise_control_tpu_torch.testing.synthetic import (
    synthetic_topology,
)
from cruise_control_tpu_torch.service.main import build_simulated_fleet
from cruise_control_tpu_torch.service.schemas import validate_response
from cruise_control_tpu_torch.testing.synthetic import SyntheticWorkloadSampler, synthetic_topology

# ---------------------------------------------------------------- helpers


class FakeClock:
    """Injected instance clock (seconds float), advanced by tests."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class StubFence:
    """Minimal fence for journal/admin unit tests."""

    def __init__(self, epoch: int = 1, ok: bool = True):
        self.epoch_value = epoch
        self.ok = ok

    def check(self, op: str = "") -> int:
        if not self.ok:
            raise FencedError(f"stub fence ({op})")
        return self.epoch_value


def rotation_proposals(admin, *, data=3000.0):
    """Proposals shifting every T0 partition's replicas by one broker —
    real inter-broker moves against the live simulated topology."""
    topo = admin.topology()
    n = len(topo.brokers)
    props = []
    for p in topo.partitions:
        if p.topic != "T0":
            continue
        old = tuple(p.replicas)
        new = tuple((b + 1) % n for b in old)
        props.append(ExecutionProposal(
            partition=p.partition,
            topic=0,
            old_leader=p.leader,
            new_leader=new[0],
            old_replicas=old,
            new_replicas=new,
            inter_broker_data_to_move=data,
        ))
    return props


# ------------------------------------------------------------ lease store


def test_lease_store_acquire_renew_expire(tmp_path):
    clock = FakeClock()
    store = FileLeaseStore(str(tmp_path), skew_slack_s=1.0, clock=clock)
    a = store.acquire("c1", "A", 10.0)
    assert (a.epoch, a.holder_id) == (1, "A")
    # exclusive while live (even right at the deadline + slack boundary)
    assert store.acquire("c1", "B", 10.0) is None
    clock.advance(9.0)
    renewed = store.renew(a, 10.0)
    assert renewed.epoch == 1 and renewed.deadline == clock() + 10.0
    # expiry + skew slack opens the takeover window; the epoch bumps
    clock.advance(11.5)
    b = store.acquire("c1", "B", 10.0)
    assert (b.epoch, b.holder_id) == (2, "B")
    # the deposed holder's renewal is fenced
    assert store.renew(renewed, 10.0) is None
    # release -> immediate re-acquire, epoch still monotonic
    store.release(b)
    c = store.acquire("c1", "A", 10.0)
    assert c.epoch == 3
    assert single_holder_violations(store.audit_events()) == []


def test_lease_store_epochs_survive_restart(tmp_path):
    clock = FakeClock()
    store = FileLeaseStore(str(tmp_path), skew_slack_s=0.5, clock=clock)
    a = store.acquire("c1", "A", 5.0)
    store.release(a)
    # a fresh store object (restarted process) continues the epoch chain
    store2 = FileLeaseStore(str(tmp_path), skew_slack_s=0.5, clock=clock)
    b = store2.acquire("c1", "B", 5.0)
    assert b.epoch == 2


def test_epoch_floor_survives_lease_file_loss(tmp_path):
    """A lost/corrupt lease file must not reset the fencing token: with
    execution journals already stamped at higher epochs, an epoch reset
    would make replay's high-water filter drop the NEW holder's
    legitimate writes as zombie writes.  The audit trail is the floor."""
    clock = FakeClock()
    store = FileLeaseStore(str(tmp_path), skew_slack_s=0.5, clock=clock)
    a = store.acquire("c1", "A", 5.0)
    store.release(a)
    b = store.acquire("c1", "B", 5.0)
    assert b.epoch == 2
    os.remove(store._lease_path("c1"))  # operator loses the lease file
    clock.advance(10.0)
    c = store.acquire("c1", "A", 5.0)
    assert c.epoch == 3  # continues past the audit-trail floor, not 1


def test_fence_is_time_based_not_event_based(tmp_path):
    """The zombie shape: the renewal thread stalls, so NO loss event ever
    fires — the fence must still revoke itself by time, strictly before
    the store's takeover window opens."""
    clock = FakeClock()
    store = FileLeaseStore(str(tmp_path), skew_slack_s=1.0, clock=clock)
    mgr = LeaseManager(store, ["c1"], holder_id="A", ttl_s=10.0, renew_s=2.0,
                       skew_slack_s=1.0, clock=clock)
    mgr.poll_once()
    fence = mgr.fence("c1")
    assert fence.check() == 1
    # deadline-slack = +9s: the fence dies at 9 even though the manager
    # never polls again
    clock.advance(9.5)
    with pytest.raises(FencedError):
        fence.check()
    # ...while the store would only grant a takeover at +11
    assert store.acquire("c1", "B", 10.0) is None
    clock.advance(2.0)
    assert store.acquire("c1", "B", 10.0) is not None


def test_lease_manager_loss_and_reacquire_callbacks(tmp_path):
    clock = FakeClock()
    store = FileLeaseStore(str(tmp_path), skew_slack_s=1.0, clock=clock)
    events = []
    a = LeaseManager(store, ["c1"], holder_id="A", ttl_s=10.0, renew_s=2.0,
                     skew_slack_s=1.0, clock=clock,
                     on_acquired=lambda cid, lease, tk: events.append(("A+", cid, tk)),
                     on_lost=lambda cid, lease: events.append(("A-", cid)))
    b = LeaseManager(store, ["c1"], holder_id="B", ttl_s=10.0, renew_s=2.0,
                     skew_slack_s=1.0, clock=clock,
                     on_acquired=lambda cid, lease, tk: events.append(("B+", cid, tk)))
    a.poll_once()
    b.poll_once()  # no-op: A holds
    assert events == [("A+", "c1", False)]
    clock.advance(12.0)  # A stalled past ttl + slack
    b.poll_once()
    assert events[-1] == ("B+", "c1", True)  # marked as a takeover
    a.poll_once()  # A wakes, discovers the loss
    assert events[-1] == ("A-", "c1")
    assert not a.owns("c1") and b.owns("c1")
    assert single_holder_violations(store.audit_events()) == []


def test_lease_manager_validates_timings(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    with pytest.raises(ValueError):
        LeaseManager(store, ["c1"], holder_id="A", ttl_s=5.0, renew_s=5.0)
    with pytest.raises(ValueError):
        LeaseManager(store, ["c1"], holder_id="A", ttl_s=5.0, renew_s=1.0,
                     skew_slack_s=3.0)
    with pytest.raises(ValueError):
        # renewals slower than the fence window (ttl - slack): the
        # rightful holder's fence would expire between heartbeats
        LeaseManager(store, ["c1"], holder_id="A", ttl_s=10.0, renew_s=9.0,
                     skew_slack_s=1.5)


# --------------------------------------------------------------- fencing


def test_journal_append_stamps_and_checks_epoch(tmp_path):
    fence = StubFence(epoch=3)
    j = ExecutionJournal(str(tmp_path / "j.jsonl"), fence=fence)
    j.start_execution({"uuid": "u", "ms": 0, "tasks": [], "options": {}})
    j.append({"t": "task", "id": 0, "state": "IN_PROGRESS", "ms": 1})
    j.flush()
    records = [json.loads(s) for s in open(j.path)]
    assert all(r["epoch"] == 3 for r in records)
    # the fence trips: nothing is written
    size = os.path.getsize(j.path)
    fence.ok = False
    with pytest.raises(FencedError):
        j.append({"t": "task", "id": 0, "state": "COMPLETED", "ms": 2})
    with pytest.raises(FencedError):
        j.start_execution({"uuid": "u2", "ms": 3, "tasks": [], "options": {}})
    j.flush()
    assert os.path.getsize(j.path) == size


def test_replay_drops_zombie_writes_below_high_water(tmp_path):
    """A deposed holder's late write (epoch below one already seen) is
    ignored; legitimate mixed epochs — a takeover appending at a HIGHER
    epoch onto its predecessor's records — replay in full."""
    p = tmp_path / "j.jsonl"
    lines = [
        {"t": "start", "uuid": "u", "ms": 0, "tasks": [], "options": {},
         "epoch": 1},
        {"t": "task", "id": 0, "state": "IN_PROGRESS", "ms": 1, "epoch": 1},
        {"t": "task", "id": 0, "state": "COMPLETED", "ms": 2, "epoch": 2},
        {"t": "task", "id": 1, "state": "IN_PROGRESS", "ms": 3, "epoch": 1},
        {"t": "task", "id": 2, "state": "IN_PROGRESS", "ms": 4, "epoch": 2},
    ]
    p.write_text("".join(json.dumps(r) + "\n" for r in lines))
    records = ExecutionJournal(str(p)).replay()
    assert [r.get("id") for r in records] == [None, 0, 0, 2]  # zombie id=1 gone
    # epoch-less (single-instance) records always replay
    p.write_text('{"t":"start","ms":0}\n{"t":"finished","ms":1}\n')
    assert len(ExecutionJournal(str(p)).replay()) == 2


def test_fenced_cluster_admin_blocks_mutations_passes_reads(tmp_path):
    inner = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=4,
                                                  topics={"T0": 2}, seed=1)),
        link_rate_bytes_per_s=1e12,
    )
    fence = StubFence()
    admin = FencedClusterAdmin(inner, fence)
    # optional-capability probes see the wrapped admin's surface
    assert hasattr(admin, "tick") and hasattr(admin, "reassignment_remaining_bytes")
    spec_props = rotation_proposals(inner)[:1]
    from cruise_control_tpu_torch.executor.admin import ReassignmentSpec

    spec = ReassignmentSpec("T0", spec_props[0].partition,
                            spec_props[0].new_replicas, 10.0)
    admin.reassign_partitions([spec])  # fenced-in: allowed
    assert inner.reassign_calls == 1
    fence.ok = False
    for call in (
        lambda: admin.reassign_partitions([spec]),
        lambda: admin.cancel_reassignments(),
        lambda: admin.cancel_partition_reassignments([("T0", 0)]),
        lambda: admin.elect_leaders([]),
        lambda: admin.alter_replica_logdirs([]),
        lambda: admin.set_replication_throttle(1e6, {"T0"}),
        lambda: admin.clear_replication_throttle(),
    ):
        with pytest.raises(FencedError):
            call()
    assert inner.reassign_calls == 1  # nothing reached the cluster
    # reads keep serving (degraded read-only mode)
    assert admin.topology() is not None
    assert admin.in_progress_reassignments() is not None


def test_fenced_executor_aborts_batch_cleanly(tmp_path):
    """Lease lost mid-batch: the executor's FencedError abort resets its
    state, journals nothing after the fence trip, and leaves the throttle
    for the NEW holder's reconciliation to sweep."""
    inner = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=4,
                                                  topics={"T0": 4}, seed=2)),
        link_rate_bytes_per_s=1000.0,
    )
    fence = StubFence()
    j = ExecutionJournal(str(tmp_path / "j.jsonl"), fence=fence)
    ex = Executor(FencedClusterAdmin(inner, fence), topic_names={0: "T0"},
                  journal=j)
    props = rotation_proposals(inner, data=3000.0)

    # trip the fence on the 3rd progress tick
    calls = [0]
    orig_tick = inner.tick

    def tick(seconds):
        calls[0] += 1
        if calls[0] == 3:
            fence.ok = False
        return orig_tick(seconds)

    inner.tick = tick
    with pytest.raises(FencedError):
        ex.execute_proposals(props, ExecutionOptions(
            concurrent_partition_movements_per_broker=1,
            progress_check_interval_s=1.0,
            replication_throttle_bytes_per_s=5000.0,
        ))
    assert ex.state == ExecutorState.NO_TASK_IN_PROGRESS
    assert ex.executor_state().get("fencedAbort") is True
    assert ex.sensors.counter("executor.fenced-aborts").count == 1
    # the zombie could NOT clear its throttle (that would race the new
    # holder); the journal shows it set and never cleared, so the new
    # holder's reconciliation sweeps it
    assert inner.throttle_rate == 5000.0
    records = ExecutionJournal(j.path).replay()
    assert any(r["t"] == "throttle_set" for r in records)
    assert not any(r["t"] in ("throttle_cleared", "finished") for r in records)


def test_fenced_start_does_not_wedge_executor(tmp_path):
    """A lease lost between the facade's pre-check and the journal's
    fsync'd start record must abort the request WITHOUT wedging the
    executor in STARTING_EXECUTION — the state resets, the abort is
    counted, and a re-fenced-in executor runs normally."""
    inner = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=4,
                                                  topics={"T0": 4}, seed=6)),
        link_rate_bytes_per_s=1e12,
    )
    fence = StubFence()
    j = ExecutionJournal(str(tmp_path / "j.jsonl"), fence=fence)
    ex = Executor(FencedClusterAdmin(inner, fence), topic_names={0: "T0"},
                  journal=j)
    props = rotation_proposals(inner)
    fence.ok = False
    with pytest.raises(FencedError):
        ex.execute_proposals(props[:1], ExecutionOptions())
    assert ex.state == ExecutorState.NO_TASK_IN_PROGRESS
    assert ex.executor_state().get("fencedAbort") is True
    # not wedged: reconciliation and a fenced-in execution both work
    fence.ok = True
    ex.reconcile_journal()
    res = ex.execute_proposals(props, ExecutionOptions(
        progress_check_interval_s=0.1))
    assert res.completed == len(ex.tracker.tasks()) and res.dead == 0


# ---------------------------------------------- journal retention (sat 1)


def _finished_execution(j):
    j.start_execution({"uuid": "u", "ms": 0, "tasks": [], "options": {}})
    j.append({"t": "finished", "ms": 1, "result": {}})


def test_journal_rotation_archives_terminal_executions(tmp_path):
    j = ExecutionJournal(str(tmp_path / "j.jsonl"), retention_count=10,
                         retention_hours=1000.0)
    for _ in range(4):
        _finished_execution(j)
    j.close()
    archives = sorted(tmp_path.glob("j.jsonl.*.done"))
    assert len(archives) == 3  # the 4th execution is the live file
    assert all(b'"t":"finished"' in a.read_bytes() for a in archives)


def test_journal_prune_respects_count_and_hours(tmp_path):
    j = ExecutionJournal(str(tmp_path / "j.jsonl"))  # retention unset
    for _ in range(6):
        _finished_execution(j)
    j.close()
    assert len(list(tmp_path.glob("j.jsonl.*.done"))) == 5
    assert j.prune_archives() == 0  # no bounds configured: prune is a no-op
    j.retention_count, j.retention_hours = 2, 1000.0
    assert j.prune_archives() == 3
    assert len(list(tmp_path.glob("j.jsonl.*.done"))) == 2
    # hours bound: age the survivors out
    j.retention_hours = 0.0
    assert j.prune_archives(now_ms=int(time.time() * 1000) + 10_000) == 2
    assert not list(tmp_path.glob("j.jsonl.*.done"))


def test_prune_never_touches_unfinished_journals(tmp_path):
    """Regression: pruning runs while an unfinished journal awaits
    recovery — the live journal AND any non-terminal file are intact."""
    j = ExecutionJournal(str(tmp_path / "j.jsonl"))
    _finished_execution(j)
    # live journal now holds an UNFINISHED execution awaiting recovery
    j.start_execution({"uuid": "u2", "ms": 2, "tasks": [], "options": {}})
    j.append({"t": "task", "id": 0, "state": "IN_PROGRESS", "ms": 3})
    j.close()
    # a stray non-terminal .done file (no finished record) is never pruned
    stray = tmp_path / "j.jsonl.123.deadbeef.done"
    stray.write_text('{"t":"start","ms":0}\n')
    j.retention_count, j.retention_hours = 0, 0.0  # prune EVERYTHING eligible
    assert j.prune_archives() == 1  # only the terminal archive went
    assert stray.exists()
    je = ExecutionJournal(str(tmp_path / "j.jsonl")).unfinished_execution()
    assert je is not None and je.uuid == "u2"


def test_executor_reconciliation_prunes_archives(tmp_path):
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=4,
                                                  topics={"T0": 2}, seed=3)),
        link_rate_bytes_per_s=1e12,
    )
    j = ExecutionJournal(str(tmp_path / "j.jsonl"), retention_count=1,
                         retention_hours=1000.0)
    for _ in range(4):
        _finished_execution(j)
    j.close()
    ex = Executor(admin, journal=ExecutionJournal(
        str(tmp_path / "j.jsonl"), retention_count=1, retention_hours=1000.0
    ))
    assert ex.state == ExecutorState.NO_TASK_IN_PROGRESS
    assert len(list(tmp_path.glob("j.jsonl.*.done"))) == 1


# ------------------------------------------- zero-length journal (sat 2)


def test_zero_length_journal_is_no_unfinished_execution(tmp_path):
    """Crash between file creation and the fsync'd start record."""
    p = tmp_path / "j.jsonl"
    p.write_bytes(b"")
    j = ExecutionJournal(str(p))
    assert j.replay() == []
    assert j.unfinished_execution() is None
    admin = SimulatedClusterAdmin(
        StaticMetadataProvider(synthetic_topology(num_brokers=4,
                                                  topics={"T0": 2}, seed=4)),
    )
    ex = Executor(admin, journal=ExecutionJournal(str(p)))
    assert ex.state == ExecutorState.NO_TASK_IN_PROGRESS
    assert not ex.has_recovered_execution
    # the file is appendable afterwards (torn-tail repair tolerates empty)
    j2 = ExecutionJournal(str(p))
    j2.append({"t": "task", "id": 0, "state": "PENDING", "ms": 0})
    j2.flush()
    assert len(ExecutionJournal(str(p)).replay()) == 1


def test_torn_first_line_journal_is_no_unfinished_execution(tmp_path):
    p = tmp_path / "j.jsonl"
    p.write_bytes(b'{"t": "sta')  # torn before the first record landed
    j = ExecutionJournal(str(p))
    assert j.unfinished_execution() is None
    j.append({"t": "task", "id": 0, "state": "PENDING", "ms": 0})
    j.flush()
    assert len(ExecutionJournal(str(p)).replay()) == 1  # tail repaired


# -------------------------------------------------- fault injectors (sat 3)


def test_lease_partition_fail_injector_accounting(tmp_path):
    clock = FakeClock()
    store = FileLeaseStore(str(tmp_path), skew_slack_s=1.0, clock=clock)
    mgr = LeaseManager(store, ["c1"], holder_id="A", ttl_s=10.0, renew_s=2.0,
                       skew_slack_s=1.0, clock=clock)
    mgr.poll_once()
    assert mgr.owns("c1")
    with faults.lease_partition(store, mode="fail") as log:
        clock.advance(2.0)
        mgr.poll_once()  # renew fails, but the fence window is still open
        assert mgr.owns("c1")
        clock.advance(7.5)  # past deadline - slack
        mgr.poll_once()  # renew fails AND the window closed: loss
        assert not mgr.owns("c1")
    assert log.calls.get("renew", 0) == 2
    assert log.total_fired == log.total_calls > 0
    # partition healed: the next poll re-acquires
    clock.advance(3.0)
    mgr.poll_once()
    assert mgr.owns("c1")


def test_lease_partition_hang_injector_releases_on_exit(tmp_path):
    import threading

    clock = FakeClock()
    store = FileLeaseStore(str(tmp_path), skew_slack_s=1.0, clock=clock)
    done = threading.Event()
    result = []
    with faults.lease_partition(store, ops=("acquire",), mode="hang") as log:
        def call():
            result.append(store.acquire("c1", "A", 10.0))
            done.set()

        t = threading.Thread(target=call, daemon=True)
        t.start()
        assert not done.wait(0.2)  # hung inside the partition
    assert done.wait(5.0)  # context exit released the call
    assert result[0] is not None and log.fired.get("acquire") == 1


def test_clock_skew_injector(tmp_path):
    clock = FakeClock(1000.0)
    store = FileLeaseStore(str(tmp_path), skew_slack_s=1.0, clock=clock)
    with faults.clock_skew(store, 5.0) as log:
        lease = store.acquire("c1", "A", 10.0)
        assert lease.deadline == 1015.0  # skewed now + ttl
    assert log.calls.get("clock", 0) >= 1
    assert store.clock() == 1000.0  # restored


def test_chaos_schedule_single_holder_invariant(tmp_path):
    """Seeded chaos: two instances, one with a flaky store partition and
    both with (within-slack) clock skew, racing one cluster set across
    many heartbeats — the audit trail must show at most one holder per
    cluster at any instant and both fences never held at once."""
    base = FakeClock()
    slack = 1.0
    store_a = FileLeaseStore(str(tmp_path), skew_slack_s=slack, clock=base)
    store_b = FileLeaseStore(str(tmp_path), skew_slack_s=slack, clock=base)
    a = LeaseManager(store_a, ["c1", "c2"], holder_id="A", ttl_s=6.0,
                     renew_s=1.5, skew_slack_s=slack, clock=base)
    b = LeaseManager(store_b, ["c1", "c2"], holder_id="B", ttl_s=6.0,
                     renew_s=1.5, skew_slack_s=slack, clock=base)
    with faults.clock_skew(store_a, 0.4), faults.clock_skew(a, 0.4), \
            faults.clock_skew(store_b, -0.4), faults.clock_skew(b, -0.4), \
            faults.lease_partition(
                store_a,
                schedule=faults.FaultSchedule(rate=0.35, seed=13),
                mode="fail",
            ):
        for _ in range(120):
            base.advance(1.1)
            a.poll_once()
            b.poll_once()
            for cid in ("c1", "c2"):
                assert not (a.owns(cid) and b.owns(cid)), (
                    f"both instances hold {cid}"
                )
    violations = single_holder_violations(store_a.audit_events())
    assert violations == [], violations


# ---------------------------------------- default-off parity (acceptance)


# -------------------------------- two-instance failover (the chaos gate)



# ------------------------- the simulated fleet (tests/test_fleet_ha.py :624-800)


def test_ha_disabled_default_is_classic_fleet(tmp_path):
    """fleet.ha.enabled=false (the default): no lease store on disk, no
    lease manager, contexts start immediately, journal records carry no
    epoch, /fleet carries no ownership/ha fields."""
    app, fleet = build_simulated_fleet(
        {"executor.journal.dir": str(tmp_path),
         "tpu.prewarm.enabled": "false"},  # see build_instance
        clusters={"solo": dict(num_brokers=4, topics={"T0": 4})},
        sampled_windows=1, device="cpu",
    )
    try:
        assert fleet.lease_manager is None
        assert not (tmp_path / "_leases").exists()
        cc = fleet.facade("solo")
        assert cc.fence is None
        fleet.start_up()
        assert fleet.contexts["solo"].started
        ex = cc.executor
        ex.topic_names[0] = "T0"
        props = rotation_proposals(cc.admin)[:2]
        res = ex.execute_proposals(props, ExecutionOptions(
            progress_check_interval_s=0.1))
        assert res.completed == len(ex.tracker.tasks()) and res.dead == 0
        records = ExecutionJournal(ex.journal.path).replay()
        assert records and all("epoch" not in r for r in records)
        state = fleet.fleet_state()
        assert "ha" not in state
        assert "ownership" not in state["clusters"]["solo"]
        assert validate_response("fleet", state) == []
    finally:
        fleet.shutdown()


@pytest.mark.slow
def test_kill_and_takeover_acceptance_story(tmp_path):
    """Instance A crashes mid-inter-broker batch (process_crash); B's
    heartbeat takes the lease over after expiry, replays A's journal,
    sweeps the leaked throttle and resumes the batch with ZERO duplicate
    submissions; the audit trail shows a clean single-holder handover."""
    clock = FakeClock()
    backends = shared_backends(("c1",), link_rate=1000.0)
    inner_admin = backends["c1"][1]
    counts = spy_submissions(inner_admin)

    app_a, fleet_a = build_instance("A", tmp_path, backends, clock)
    lm_a = fleet_a.lease_manager
    lm_a.poll_once()
    assert lm_a.owns("c1")
    ex_a = fleet_a.facade("c1").executor
    assert wait_until(lambda: fleet_a.contexts["c1"].started
                      and not ex_a.has_ongoing_execution)
    ex_a.topic_names[0] = "T0"
    props = rotation_proposals(inner_admin, data=3000.0)
    with faults.process_crash(inner_admin,
                              schedule=faults.FaultSchedule(calls=[4])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex_a.execute_proposals(props, ExecutionOptions(
                concurrent_partition_movements_per_broker=2,
                progress_check_interval_s=1.0,
                replication_throttle_bytes_per_s=5000.0,
            ))
    # the dead process left its throttle + in-flight moves behind
    assert inner_admin.throttle_rate == 5000.0
    assert inner_admin.in_progress_reassignments()
    journal_path = ex_a.journal.path
    records = ExecutionJournal(journal_path).replay()
    assert all(r["epoch"] == 1 for r in records)

    # A is dead: its heartbeat never runs again; the lease expires
    clock.advance(12.0)
    app_b, fleet_b = build_instance("B", tmp_path, backends, clock)
    lm_b = fleet_b.lease_manager
    lm_b.poll_once()
    assert lm_b.owns("c1")
    cc_b = fleet_b.facade("c1")
    # activation (async) reconciles A's journal: the throttle sweep is
    # journaled into the recovery report before anything resumes
    assert wait_until(lambda: cc_b.executor.recovery_info() is not None)
    info = cc_b.executor.recovery_info()
    assert info["sweptThrottle"] is True

    # the resume thread drives the remainder to completion
    assert wait_until(
        lambda: (not cc_b.executor.has_recovered_execution
                 and not cc_b.executor.has_ongoing_execution
                 and fleet_b.contexts["c1"].started),
        timeout=60,
    )
    assert cc_b.executor.state == ExecutorState.NO_TASK_IN_PROGRESS
    # ZERO duplicate submissions across the kill-and-takeover
    assert counts and all(n == 1 for n in counts.values()), counts
    # every partition landed on its rotated replica set
    topo = inner_admin.topology()
    n = len(topo.brokers)
    by_key = {(p.topic, p.partition): set(p.replicas) for p in topo.partitions}
    for p in props:
        assert by_key[("T0", p.partition)] == set(p.new_replicas)
    assert inner_admin.throttle_rate is None  # zero leaked throttles
    # B's resume journaled at its own (higher) epoch
    records = ExecutionJournal(journal_path).replay()
    assert {r["epoch"] for r in records} == {1, 2}
    violations = single_holder_violations(
        lm_b.store.audit_events()
    )
    assert violations == [], violations

    # A wakes up a zombie: degraded, fenced, loud
    lm_a.poll_once()  # discovers the loss
    ctx_a = fleet_a.contexts["c1"]
    assert ctx_a.degraded
    state = fleet_a.fleet_state()
    own = state["clusters"]["c1"]["ownership"]
    assert own["owned"] is False and own["degraded"] is True
    assert own.get("holderId") == "B"
    assert validate_response("fleet", state) == []
    # the FLEET_LEASE_LOST anomaly reached the notifier (alert-only)
    cc_a = fleet_a.facade("c1")
    handled = cc_a.anomaly_detector._drain()
    assert any(
        r.anomaly.anomaly_type.name == "FLEET_LEASE_LOST" for r in handled
    )
    assert any(
        a.anomaly_type.name == "FLEET_LEASE_LOST"
        for a, _fix in cc_a.notifier.alerts
    )
    fleet_a.shutdown()
    fleet_b.shutdown()


@pytest.mark.slow
def test_zombie_writer_is_fenced_everywhere(tmp_path):
    """A's stalled thread wakes AFTER the takeover: every journal append
    and every admin mutation is rejected with FencedError, and neither
    the journal file nor the cluster sees the write."""
    clock = FakeClock()
    backends = shared_backends(("c1",), link_rate=1000.0)
    inner_admin = backends["c1"][1]

    app_a, fleet_a = build_instance("A", tmp_path, backends, clock)
    fleet_a.lease_manager.poll_once()
    cc_a = fleet_a.facade("c1")
    ex_a = cc_a.executor
    assert wait_until(lambda: fleet_a.contexts["c1"].started
                      and not ex_a.has_ongoing_execution)
    ex_a.topic_names[0] = "T0"
    # A journals a live execution start, then its process stalls
    props = rotation_proposals(inner_admin, data=10_000.0)[:2]
    with faults.process_crash(inner_admin,
                              schedule=faults.FaultSchedule(calls=[1])):
        with pytest.raises(faults.SimulatedProcessCrash):
            ex_a.execute_proposals(props, ExecutionOptions(
                progress_check_interval_s=1.0))
    clock.advance(12.0)  # A's lease expires while it is stalled

    app_b, fleet_b = build_instance("B", tmp_path, backends, clock)
    fleet_b.lease_manager.poll_once()
    assert fleet_b.lease_manager.owns("c1")

    # ...now A's stalled thread wakes and tries to keep going
    reassign_calls = inner_admin.reassign_calls
    journal_size = os.path.getsize(ex_a.journal.path)
    with pytest.raises(FencedError):
        ex_a.journal.append({"t": "task", "id": 0, "state": "COMPLETED",
                             "ms": 99})
    from cruise_control_tpu_torch.executor.admin import ReassignmentSpec

    with pytest.raises(FencedError):
        cc_a.admin.reassign_partitions([
            ReassignmentSpec("T0", 0, (0, 1), 1.0)
        ])
    with pytest.raises(FencedError):
        cc_a.admin.clear_replication_throttle()
    # a full re-execution attempt through the facade gate is fenced too
    with pytest.raises(FencedError):
        cc_a.fence.check(op="execute")
    assert inner_admin.reassign_calls == reassign_calls
    assert os.path.getsize(ex_a.journal.path) == journal_size
    # B is unaffected: its fenced-in resume finishes the batch
    cc_b = fleet_b.facade("c1")
    assert wait_until(
        lambda: (fleet_b.contexts["c1"].started
                 and not cc_b.executor.has_recovered_execution
                 and not cc_b.executor.has_ongoing_execution),
        timeout=60,
    )
    assert cc_b.executor.state == ExecutorState.NO_TASK_IN_PROGRESS
    fleet_a.shutdown()
    fleet_b.shutdown()


# the simulated fleet's helpers (tests/test_fleet_ha.py :78-167)


def shared_backends(cluster_ids=("c1",), *, link_rate=1e12, num_brokers=4,
                    partitions=8, seed=7):
    """{cid: (metadata, admin, sampler)} over ONE set of simulated
    clusters — passed to every instance of a multi-instance harness so
    all of them 'see' the same Kafka fleet."""
    out = {}
    for i, cid in enumerate(cluster_ids):
        topo = synthetic_topology(
            num_brokers=num_brokers, topics={"T0": partitions}, seed=seed + i
        )
        meta = StaticMetadataProvider(topo)
        admin = SimulatedClusterAdmin(meta, link_rate_bytes_per_s=link_rate)
        out[cid] = (meta, admin, SyntheticWorkloadSampler(topo, seed=seed + i))
    return out


def build_instance(instance_id, journal_dir, backends, clock, **extra):
    """One in-process tpu-cruise instance of an HA fleet.  Instances
    share ONLY the journal/lease directory and the simulated backends —
    the coordination surface real instances would share."""
    props = {
        "fleet.clusters": ",".join(backends),
        "fleet.ha.enabled": "true",
        "fleet.ha.instance.id": instance_id,
        "fleet.ha.lease.ttl.s": 10.0,
        "fleet.ha.renew.s": 2.0,
        "fleet.ha.skew.slack.s": 1.0,
        "executor.journal.dir": str(journal_dir),
        "anomaly.detection.interval.ms": 3_600_000,
        # keep start_up free of background compile threads (boot prewarm /
        # warm pool): a live XLA worker at interpreter exit segfaults the
        # pytest process (pre-existing; irrelevant to what HA pins here)
        "tpu.prewarm.enabled": "false",
    }
    props.update(extra)
    return build_simulated_fleet(
        props, backends=backends, ha_clock=clock, sampled_windows=1, device="cpu"
    )


def wait_until(cond, timeout=30.0):
    """Poll `cond` until true — cluster activation (reconcile + start_up)
    runs on its own thread off the lease heartbeat."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def spy_submissions(admin):
    """Per-partition reassignment submission counts across 'processes'."""
    counts: dict = {}
    orig = admin.reassign_partitions

    def wrapper(specs):
        for s in specs:
            counts[(s.topic, s.partition)] = counts.get((s.topic, s.partition), 0) + 1
        return orig(specs)

    admin.reassign_partitions = wrapper
    return counts
