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
Left out, as they build the simulated fleet service (item 9):
test_ha_disabled_default_is_classic_fleet,
test_kill_and_takeover_acceptance_story and
test_zombie_writer_is_fenced_everywhere.

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

