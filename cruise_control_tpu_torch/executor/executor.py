"""Executor — applies optimization proposals to the cluster.

Reference: executor/Executor.java:72 — executeProposals():395,
ProposalExecutionRunnable.run():749 (phase 1 inter/intra-broker moves,
phase 2 leadership), updateOngoingExecutionState():912 (progress loop),
maybeReexecuteTasks():1430, graceful + forced stop (:1145 deletes the ZK
reassignment node; here admin.cancel_reassignments), per-broker
concurrency caps (Executor.java:485-510), removed/demoted broker history.

The execution loop is tick-driven: each `progress_check` round collects
finished reassignments from the ClusterAdmin, transitions tasks, and
drains new ones within concurrency caps.  `execute_proposals` runs the
loop synchronously (simulation advances via admin.tick) or in a
background thread against a real cluster.

Crash safety (this file + executor/journal.py): when a journal is
attached, every execution start, task transition, throttle change and
reservation change is durably recorded.  A fresh Executor replays the
journal on construction; an execution the predecessor left in flight puts
the executor in RECOVERING state — reservations restored, leaked
throttles swept, every journaled task reconciled against the live
topology (landed -> COMPLETED, still moving -> re-adopted, vanished ->
re-submitted or DEAD) — and `resume_recovered_execution()` drives the
remainder to completion with zero duplicate submissions.

Two in-loop guardians (reference ConcurrencyAdjuster + stuck-task
handling): the stuck-move reaper cancels reassignments whose progress
watermark stalls past `executor.reaper.stuck.timeout.s` (rollback via
per-partition cancellation where the controller supports it, else DEAD)
and raises an EXECUTION_STUCK anomaly; the ConcurrencyAdjuster samples
cluster stress (under-replicated partitions, task throughput) every tick
and AIMD-adjusts the movement caps between `executor.adaptive.{min,max}`.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.admin import ClusterAdmin, LeadershipSpec, ReassignmentSpec
from cruise_control_tpu_torch.executor.journal import (
    ExecutionJournal,
    task_to_journal,
)
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import ReplicaMovementStrategy
from cruise_control_tpu_torch.executor.tasks import (
    ExecutionTask,
    ExecutionTaskTracker,
    TaskState,
    TaskType,
)
from cruise_control_tpu_torch.executor.throttle import ReplicationThrottleHelper

_TERMINAL = (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD)


class ExecutorState(enum.Enum):
    """Reference executor/ExecutorState.java states (+ RECOVERING: journal
    replay reconciled an execution a crashed predecessor left in flight
    and the remainder has not resumed/finished yet)."""

    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    RECOVERING = "RECOVERING"
    INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    )
    INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    )
    LEADER_MOVEMENT_TASK_IN_PROGRESS = "LEADER_MOVEMENT_TASK_IN_PROGRESS"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


@dataclasses.dataclass
class ExecutionOptions:
    """Concurrency caps (reference config/constants/ExecutorConfig.java:
    num.concurrent.partition.movements.per.broker default 5,
    num.concurrent.intra.broker.partition.movements default 2,
    num.concurrent.leader.movements default 1000)."""

    concurrent_partition_movements_per_broker: int = 5
    concurrent_intra_broker_partition_movements: int = 2
    concurrent_leader_movements: int = 1000
    #: global cap on concurrently ongoing movements cluster-wide, on top of
    #: the per-broker caps (reference ExecutorConfig
    #: max.num.cluster.movements, default 1250)
    max_num_cluster_movements: int = 1250
    #: a leadership move the topology has not confirmed within this window
    #: is declared DEAD (reference ExecutorConfig leader.movement.timeout.ms)
    leader_movement_timeout_s: float = 180.0
    #: MB/s floors for the slow-task alert: a replica move alerts when its
    #: execution time exceeds task_execution_alerting_s AND its data rate is
    #: below this (reference ExecutorConfig
    #: {inter,intra}.broker.replica.movement.rate.alerting.threshold)
    inter_broker_rate_alerting_mb_s: float = 0.1
    intra_broker_rate_alerting_mb_s: float = 0.2
    replication_throttle_bytes_per_s: float | None = None
    progress_check_interval_s: float = 0.5
    #: tasks in progress longer than this raise an alert flag
    task_execution_alerting_s: float = 90.0
    #: times a reassignment the controller dropped (vanished from the
    #: in-progress set without landing) is re-submitted before the task is
    #: declared DEAD.  The reference re-executes unboundedly
    #: (Executor.maybeReexecuteTasks:1430); the bound here exists so a
    #: pathologically dropping controller cannot loop forever, and defaults
    #: HIGH because the landed-check reads topology metadata that can lag
    #: the controller on a real cluster (a completed move that looks
    #: unplaced for a few ticks must not be DEAD-marked — 64 ticks at the
    #: 0.5s default interval tolerates ~30s of metadata staleness)
    max_reexecution_attempts: int = 64
    #: consecutive ticks a finished-looking logdir copy may stay
    #: UNVERIFIABLE (unreachable broker) before its task is declared DEAD
    max_intra_verify_failures: int = 8
    max_ticks: int = 10_000  # simulation safety bound
    #: stuck-move reaper (executor.reaper.stuck.timeout.s): an inter-broker
    #: move whose progress watermark (remaining bytes, when the admin can
    #: report them, else any completion) has not advanced for this long is
    #: cancelled — rolled back to the original replica set where the
    #: controller supports per-partition cancellation, DEAD otherwise —
    #: and an EXECUTION_STUCK anomaly is raised.  None disables.
    reaper_stuck_timeout_s: float | None = None
    #: load-aware adaptive concurrency (reference ConcurrencyAdjuster):
    #: AIMD on the per-broker + cluster-wide movement caps, driven by
    #: under-replicated partitions and task throughput
    adaptive_enabled: bool = False
    adaptive_min_concurrency: int = 1
    adaptive_max_concurrency: int = 64
    adaptive_backoff_factor: float = 0.5
    adaptive_recover_step: int = 1
    #: URPs above the execution-start baseline tolerated before backoff
    adaptive_urp_slack: int = 0
    #: consecutive no-completion ticks (with moves in flight) that count as
    #: stress — the throughput half of the stress signal
    adaptive_stall_ticks: int = 16


@dataclasses.dataclass
class ExecutionResult:
    completed: int
    aborted: int
    dead: int
    ticks: int
    stopped: bool
    tracker_status: dict


class OngoingExecutionError(Exception):
    """Reference sanityCheckDryRun / ongoing-execution guard
    (KafkaCruiseControl.java:216-229)."""


class NoOngoingExecutionError(Exception):
    """Mid-execution concurrency change requested while nothing executes
    (reference rejects ChangeExecutionConcurrency in that case)."""


class ConcurrencyAdjuster:
    """Load-aware movement-cap control (reference executor/ConcurrencyAdjuster):
    multiplicative backoff while the cluster shows stress, additive
    recovery toward the configured cap once it clears.

    Stress per progress tick = under-replicated partitions above the
    execution-start baseline (replicas or leaders on dead brokers — the
    metadata-level URP proxy every ClusterAdmin can serve), OR zero task
    completions for `stall_ticks` consecutive ticks while moves are in
    flight (throughput collapse).  The cluster-wide cap scales with the
    per-broker cap so both back off together.
    """

    def __init__(
        self,
        *,
        base_inter: int,
        base_cluster: int,
        min_cap: int = 1,
        max_cap: int = 64,
        backoff_factor: float = 0.5,
        recover_step: int = 1,
        urp_slack: int = 0,
        stall_ticks: int = 16,
        initial: int | None = None,
        sensors=None,
        journal: ExecutionJournal | None = None,
    ):
        self.base_inter = max(1, int(base_inter))
        self.base_cluster = max(1, int(base_cluster))
        self.min_cap = max(1, int(min_cap))
        self.max_cap = max(self.min_cap, int(max_cap))
        self.backoff_factor = backoff_factor
        self.recover_step = max(1, int(recover_step))
        self.urp_slack = max(0, int(urp_slack))
        self.stall_ticks = max(0, int(stall_ticks))
        self.sensors = sensors
        self.journal = journal
        self.inter_cap = self._clamp(
            initial if initial is not None else self.base_inter
        )
        self.baseline_urps: int | None = None
        self.last_urps = 0
        self.num_backoffs = 0
        self.num_recoveries = 0
        self._idle_ticks = 0

    def _clamp(self, cap: int) -> int:
        return max(self.min_cap, min(int(cap), self.max_cap))

    def caps(self) -> tuple[int, int]:
        """(per-broker inter cap, cluster-wide movement cap)."""
        cluster = max(
            1, round(self.base_cluster * self.inter_cap / self.base_inter)
        )
        return self.inter_cap, min(cluster, self.base_cluster)

    @staticmethod
    def urp_count(topo) -> int:
        """Metadata-level under-replication proxy: partitions whose leader
        or any replica sits on a dead broker."""
        alive = topo.alive_broker_ids()
        return sum(
            1
            for p in topo.partitions
            if p.leader not in alive or any(b not in alive for b in p.replicas)
        )

    def observe(
        self, topo, *, completed: int, in_flight: int, base_inter: int | None = None
    ) -> tuple[int, int]:
        """One progress tick: sample stress, adjust, return active caps."""
        if base_inter is not None and int(base_inter) != self.base_inter:
            # the operator moved the base mid-execution (requested
            # concurrency override) — recover toward the NEW target
            self.base_inter = max(1, int(base_inter))
        urps = self.urp_count(topo)
        self.last_urps = urps
        if self.baseline_urps is None:
            # first tick: the cluster's pre-existing URPs are not this
            # execution's fault and must not trigger immediate backoff
            self.baseline_urps = urps
        if completed > 0 or in_flight == 0:
            self._idle_ticks = 0
        else:
            self._idle_ticks += 1
        stressed = urps > self.baseline_urps + self.urp_slack or (
            self.stall_ticks > 0 and self._idle_ticks >= self.stall_ticks
        )
        prev = self.inter_cap
        if stressed:
            self.inter_cap = max(
                self.min_cap, int(self.inter_cap * self.backoff_factor)
            )
            if self.inter_cap < prev:
                self.num_backoffs += 1
                if self.sensors is not None:
                    self.sensors.counter("executor.adaptive.backoff").inc()
            # one stall episode is one backoff, not one per subsequent tick
            self._idle_ticks = 0
        else:
            ceiling = self._clamp(self.base_inter)
            if self.inter_cap < ceiling:
                self.inter_cap = min(ceiling, self.inter_cap + self.recover_step)
                self.num_recoveries += 1
                if self.sensors is not None:
                    self.sensors.counter("executor.adaptive.recovery").inc()
        if self.inter_cap != prev:
            inter, cluster = self.caps()
            if self.sensors is not None:
                self.sensors.gauge("executor.adaptive.inter-broker-cap").set(inter)
            if self.journal is not None:
                self.journal.append(
                    {"t": "concurrency", "inter": inter, "cluster": cluster,
                     "urps": urps}
                )
            # flight recorder: cap changes land as events on the live
            # execution span (observe() runs on the execution-loop thread,
            # inside the span's context)
            from cruise_control_tpu_torch.common.trace import TRACER

            TRACER.event(
                "adaptive-cap", inter=inter, cluster=cluster, urps=urps,
                stressed=bool(stressed),
            )
        return self.caps()

    def state_json(self) -> dict:
        inter, cluster = self.caps()
        return {
            "interBrokerCap": inter,
            "clusterMovementCap": cluster,
            "baseInterBrokerCap": self.base_inter,
            "underReplicatedPartitions": self.last_urps,
            "baselineUnderReplicatedPartitions": self.baseline_urps or 0,
            "numBackoffs": self.num_backoffs,
            "numRecoveries": self.num_recoveries,
        }


class Executor:
    def __init__(
        self,
        admin: ClusterAdmin,
        *,
        strategy: ReplicaMovementStrategy | None = None,
        topic_names: dict[int, str] | None = None,
        catalog=None,
        sensors=None,
        removal_history_retention_ms: int = 1_209_600_000,
        demotion_history_retention_ms: int = 1_209_600_000,
        notifier=None,
        journal: ExecutionJournal | None = None,
        clock=None,
        anomaly_sink=None,
        tracer=None,
        defer_recovery: bool = False,
    ):
        """notifier (reference ExecutorConfig executor.notifier.class): an
        object with on_execution_finished(result, uuid), called after every
        execution — success, stop or abort.

        journal: durable execution journal (executor/journal.py); an
        unfinished execution found in it is reconciled immediately (see
        class docstring) and the executor starts in RECOVERING state.
        clock: ms-epoch callable — reservation retention and wall
        timestamps ride it, so simulated runs and tests control time.
        anomaly_sink: callable(Anomaly) the stuck-move reaper reports
        EXECUTION_STUCK through (the facade wires the anomaly detector's
        add_anomaly here).

        tracer: flight recorder (common/trace.py) — every execution is an
        `executor.execution` span whose EVENTS are the task transitions
        (riding the same ExecutionTask.observer hook the journal uses),
        reaper actions and adaptive-cap changes; defaults to the
        process-wide TRACER.

        defer_recovery (fleet HA): skip the journal replay at
        construction — reconciliation touches the cluster (throttle
        sweep) and MUST wait for lease acquisition; the fleet manager
        calls reconcile_journal() once the lease is held."""
        from cruise_control_tpu_torch.common.sensors import REGISTRY
        from cruise_control_tpu_torch.common.trace import TRACER

        self.sensors = sensors if sensors is not None else REGISTRY
        self.tracer = tracer if tracer is not None else TRACER
        #: live span of the ongoing execution (task-transition events
        #: attach here from whatever thread drives the loop)
        self._exec_span = None
        self.admin = admin
        self.strategy = strategy
        self.notifier = notifier
        self.journal = journal
        self.anomaly_sink = anomaly_sink
        self._clock = clock or (lambda: int(time.time() * 1000))
        self.topic_names = topic_names or {}
        #: ClusterCatalog resolving global partition ids -> (topic, partition)
        self.catalog = catalog
        self.state = ExecutorState.NO_TASK_IN_PROGRESS
        self._stop_requested = False
        self._force_stop = False
        self._lock = threading.RLock()
        self.tracker = ExecutionTaskTracker(observer=self._journal_task)
        self._planner: ExecutionTaskPlanner | None = None
        # reference Executor recentlyRemovedBrokers / recentlyDemotedBrokers,
        # timestamped so entries expire after the configured retention
        # (reference ExecutorConfig {removal,demotion}.history.retention.time.ms)
        self._removal_retention_ms = removal_history_retention_ms
        self._demotion_retention_ms = demotion_history_retention_ms
        self._removed_history: dict[int, int] = {}  # broker id -> recorded ms
        self._demoted_history: dict[int, int] = {}
        self.num_executions_started = 0
        self.num_executions_stopped = 0
        self._uuid: str | None = None
        #: re-submission count per dropped reassignment key
        self._reexecutions: dict[tuple[str, int], int] = {}
        #: consecutive unverifiable-completion count per logdir-copy key
        self._intra_unknown: dict[tuple[str, int, int], int] = {}
        #: mid-execution concurrency overrides (reference
        #: Executor.java:485-510 setRequested*MovementConcurrency): the
        #: operator's knob to decelerate or unstick a LIVE execution via
        #: POST /admin.  Consulted every tick; cleared when a new
        #: execution starts so submitted options apply fresh.
        self._requested: dict[str, float | int] = {}
        #: journal-recovered (topic_id, partition_id) -> (name, number)
        #: key mapping — a fresh process has no catalog for proposals it
        #: did not plan itself
        self._key_override: dict[tuple[int, int], tuple[str, int]] = {}
        #: live ConcurrencyAdjuster of the ongoing execution (None outside)
        self._adjuster: ConcurrencyAdjuster | None = None
        #: recovery report of the last journal reconciliation (see
        #: executor_state()["recovery"]); None when the journal was clean
        self._recovery: dict | None = None
        #: stashed remainder of a reconciled execution, consumed by
        #: resume_recovered_execution()
        self._resume_state: tuple | None = None
        #: True after a FencedError aborted an execution (lease lost
        #: mid-batch); cleared when a new execution starts
        self._fenced_abort = False
        #: stuck-move reaper actions within the CURRENT execution (the
        #: decision ledger's outcome record wants the per-execution count,
        #: not the process-lifetime counter)
        self._exec_reaped = 0
        self._exec_started_ms: int | None = None
        #: callable(info: dict) fired when an execution finishes — success,
        #: stop, or fenced abort — riding the same finish path the PR-4
        #: notifier hook does.  The facade wires the decision ledger's
        #: outcome join here (analyzer/ledger.py); best-effort like the
        #: notifier: a broken observer must never fail the execution.
        self.execution_observer = None
        if journal is not None and not defer_recovery:
            self.reconcile_journal()

    def reconcile_journal(self) -> None:
        """Replay the journal and reconcile any unfinished execution
        against the live cluster (see _reconcile_journal), then prune
        terminal journal archives per the retention bounds.  Runs at
        construction by default; fleet HA defers it to lease acquisition
        (and re-runs it on every re-acquisition) — refuses while an
        execution is ongoing.

        The executor is parked in RECOVERING for the DURATION of the
        replay: reconciliation sweeps throttles and rebuilds the tracker,
        so a request-path execution starting mid-sweep would race it —
        the state guard makes execute_proposals reject until the
        reconcile settles."""
        if self.journal is None:
            return
        with self._lock:
            if self.has_ongoing_execution:
                raise OngoingExecutionError(
                    "cannot reconcile the journal mid-execution"
                )
            self.state = ExecutorState.RECOVERING
        settled = False
        try:
            self._reconcile_journal()
            settled = True
        finally:
            with self._lock:
                # _reconcile_journal leaves RECOVERING only when a resume
                # remainder exists (or set NO_TASK itself on the
                # everything-landed path); a clean/failed replay must not
                # leave the guard state wedged
                if self._resume_state is None and (
                    not settled or self.state == ExecutorState.RECOVERING
                ):
                    self.state = ExecutorState.NO_TASK_IN_PROGRESS
        pruned = self.journal.prune_archives(now_ms=self._clock())
        if pruned:
            self.sensors.counter("executor.journal-archives-pruned").inc(pruned)

    # ------------------------------------------------------------------
    # journal hooks

    def _journal_task(self, task: ExecutionTask, state: TaskState, now_ms: int):
        if self.journal is not None:
            self.journal.append(
                {"t": "task", "id": task.execution_id, "state": state.value,
                 "ms": now_ms}
            )
        # same observer, second consumer: every task transition is also a
        # flight-recorder event on the live execution span (bounded there)
        sp = self._exec_span
        if sp is not None:
            sp.event(
                "task",
                id=task.execution_id,
                type=task.task_type.value,
                state=state.value,
                ms=now_ms,
            )

    def _journal_reservations(self):
        if self.journal is not None:
            self.journal.append({
                "t": "reservation",
                "removed": {str(b): ms for b, ms in self._removed_history.items()},
                "demoted": {str(b): ms for b, ms in self._demoted_history.items()},
            })

    # ------------------------------------------------------------------
    # restart reconciliation (journal replay)

    def _reconcile_journal(self):
        """Replay the journal; reconcile an unfinished execution against
        the live cluster.  Runs on construction — cheap (one topology
        fetch + one in-progress listing); the long part (driving the
        remainder) is resume_recovered_execution()."""
        je = self.journal.unfinished_execution()
        if je is None:
            return
        rec_c = lambda name: self.sensors.counter(f"executor.recovery.{name}")  # noqa: E731
        rec_c("executions-recovered").inc()
        now = self._clock()
        self._uuid = je.uuid
        # 1. reservations: removed/demoted broker history survives the crash
        self._removed_history.update(je.removed)
        self._demoted_history.update(je.demoted)
        restored = len(je.removed) + len(je.demoted)
        if restored:
            rec_c("reservations-restored").inc(restored)
        # 2. throttle sweep: a crashed predecessor cannot have cleared its
        # replication throttle — remove it before resuming (or finishing)
        swept = False
        if je.throttle_active:
            try:
                self.admin.clear_replication_throttle()
                swept = True
                rec_c("throttles-swept").inc()
            except Exception:  # noqa: BLE001 — an unreachable admin must not
                # kill construction; the journal keeps showing the throttle
                # active so the NEXT restart retries the sweep
                pass
            if swept:
                # journal only a sweep that actually reached the brokers —
                # recording a failed one would make the leak permanently
                # invisible to future recoveries
                self.journal.append({"t": "throttle_cleared"})
        # 3. task reconciliation against live topology + controller state
        topo = self.admin.topology()
        placement = {
            (p.topic, p.partition): set(p.replicas) for p in topo.partitions
        }
        leaders = {(p.topic, p.partition): p.leader for p in topo.partitions}
        in_prog = self.admin.in_progress_reassignments()
        logdir_pending = (
            self.admin.in_progress_logdir_moves()
            if hasattr(self.admin, "in_progress_logdir_moves")
            else set()
        )
        self.tracker = ExecutionTaskTracker(observer=self._journal_task)
        adopted: dict[tuple[str, int], ExecutionTask] = {}
        adopted_intra: dict[int, tuple[ExecutionTask, dict]] = {}
        pending: list[ExecutionTask] = []
        counts = {"completed": 0, "readopted": 0, "resubmitted": 0}
        for task, key in je.tasks.values():
            self._key_override[(task.proposal.topic, task.proposal.partition)] = key
            self.topic_names.setdefault(task.proposal.topic, key[0])
            if task.state in _TERMINAL:
                self.tracker.add(task)
                continue
            if task.state == TaskState.ABORTING:
                # the reaper / a forced stop was cancelling this move when
                # the process died: finalize the cancellation — whether or
                # not the move landed meanwhile, it must NOT be resubmitted
                # (and COMPLETED is not a legal transition out of ABORTING)
                task.aborted(now)
                self.tracker.add(task)
                continue
            if task.task_type == TaskType.INTER_BROKER_REPLICA_ACTION:
                if placement.get(key) == set(task.proposal.new_replicas):
                    self._force_complete(task, now)
                    counts["completed"] += 1
                elif key in in_prog:
                    # still moving on the controller: re-adopt, never
                    # resubmit.  The CONTROLLER is the authority here, not
                    # the journaled state — crash truncation may have torn
                    # off the IN_PROGRESS record of a move that did reach
                    # the wire, and resubmitting it would double-submit
                    if task.state != TaskState.IN_PROGRESS:
                        task.state = TaskState.IN_PROGRESS
                        task.start_time_ms = now
                    adopted[key] = task
                    counts["readopted"] += 1
                else:
                    # vanished (controller dropped it) or never submitted:
                    # back to PENDING; the resumed loop re-submits it — and
                    # its dead-broker sweep DEAD-marks it if the
                    # destination died while we were down
                    task.state = TaskState.PENDING
                    pending.append(task)
                    if task.start_time_ms >= 0:
                        counts["resubmitted"] += 1
            elif task.task_type == TaskType.LEADER_ACTION:
                if leaders.get(key) == task.proposal.new_leader:
                    self._force_complete(task, now)
                    counts["completed"] += 1
                else:
                    task.state = TaskState.PENDING
                    pending.append(task)
            else:  # intra-broker logdir copy
                keys3 = {
                    (key[0], key[1], b): d_new
                    for (b, _d_old, d_new) in task.proposal.disk_moves
                }
                verify = getattr(self.admin, "logdir_of", None)
                still = {k3: d for k3, d in keys3.items() if k3 in logdir_pending}
                if still:
                    # copies live on the broker win over the journaled
                    # state (same torn-record reasoning as inter-broker)
                    if task.state != TaskState.IN_PROGRESS:
                        task.state = TaskState.IN_PROGRESS
                        task.start_time_ms = now
                    adopted_intra[task.execution_id] = (task, dict(keys3))
                    counts["readopted"] += 1
                elif (
                    task.state == TaskState.IN_PROGRESS
                    and verify is not None
                    and all(verify(*k3) == d for k3, d in keys3.items())
                ):
                    self._force_complete(task, now)
                    counts["completed"] += 1
                else:
                    task.state = TaskState.PENDING
                    pending.append(task)
                    if task.start_time_ms >= 0:
                        counts["resubmitted"] += 1
            self.tracker.add(task)
        for name, n in counts.items():
            if n:
                rec_c(f"tasks-{name}").inc(n)
        self._recovery = {
            "uuid": je.uuid,
            "recoveredMs": now,
            "sweptThrottle": swept,
            "restoredReservations": restored,
            "tasksCompletedWhileDown": counts["completed"],
            "tasksReadopted": counts["readopted"],
            "tasksResubmitted": counts["resubmitted"],
            "tasksPending": len(pending),
        }
        options = ExecutionOptions(**{
            k: v
            for k, v in je.options.items()
            if k in {f.name for f in dataclasses.fields(ExecutionOptions)}
        })
        if pending or adopted or adopted_intra:
            self.state = ExecutorState.RECOVERING
            self._resume_state = (options, adopted, adopted_intra, je.adaptive)
        else:
            # everything landed (or died) while we were down: finish the
            # recovered execution right here
            self._finish_execution(self._result(ticks=0), je.uuid)

    def _force_complete(self, task: ExecutionTask, now: int):
        """Reconciliation found the task's target already live."""
        if task.state == TaskState.PENDING:
            task.in_progress(now)
        task.completed(now)

    @property
    def has_recovered_execution(self) -> bool:
        """True while a reconciled execution awaits resume_recovered_execution."""
        with self._lock:
            return self._resume_state is not None

    def recovery_info(self) -> dict | None:
        with self._lock:
            return dict(self._recovery) if self._recovery else None

    def resume_recovered_execution(self) -> ExecutionResult | None:
        """Drive the reconciled remainder of a recovered execution to
        completion: re-adopted moves keep progressing without re-submission,
        pending/vanished ones flow through the normal drain.  Returns None
        when there is nothing to resume."""
        with self._lock:
            if self._resume_state is None:
                return None
            stash = self._resume_state
            self._resume_state = None
            try:
                options, adopted, adopted_intra, adaptive = stash
                # do NOT reset _stop_requested/_force_stop: an operator stop
                # issued while the executor sat RECOVERING must be honored —
                # the loop below then drains (or force-cancels) the adopted
                # moves instead of driving the recovery to completion
                self.num_executions_started += 1
                self.sensors.counter("executor.execution-started").inc()
                self._fenced_abort = False
                planner = ExecutionTaskPlanner(self.strategy)
                planner.adopt_tasks(self.tracker.tasks(state=TaskState.PENDING))
                self._planner = planner
                self._reexecutions = {}
                self._intra_unknown = {}
            except BaseException:
                # setup failed: put the remainder back so a retried resume
                # (or the next reconciliation) still sees it
                self._resume_state = stash
                raise
        live_proposals = [
            t.proposal for t in self.tracker.tasks() if t.state not in _TERMINAL
        ]
        # the recovery drive is its own ROOT trace: it belongs to no user
        # request (the crashed predecessor's request died with it)
        with self.tracer.span(
            "executor.recovery-resume",
            component="executor",
            root=True,
            num_tasks=len(live_proposals),
            adopted=len(adopted or {}),
        ) as sp:
            self._exec_span = sp
            try:
                result = self._run_guarded(
                    options,
                    live_proposals,
                    in_flight=adopted,
                    intra_in_flight=adopted_intra,
                    adaptive_initial=(adaptive or {}).get("inter"),
                )
            finally:
                self._exec_span = None
            sp.set(
                completed=result.completed, aborted=result.aborted,
                dead=result.dead, stopped=result.stopped,
            )
            return result

    # ------------------------------------------------------------------
    # mid-execution concurrency control (reference Executor.java:485-510,
    # driven by ADMIN ChangeExecutionConcurrencyParameters)

    def set_requested_concurrency(
        self,
        *,
        inter_broker: int | None = None,
        intra_broker: int | None = None,
        leadership: int | None = None,
        progress_check_interval_s: float | None = None,
    ) -> dict:
        """Adjust the concurrency caps of the ongoing execution.

        Each tick of the execution loop reads these instead of the frozen
        ExecutionOptions, so the change takes effect on the next progress
        check — matching the reference's
        setRequestedInterBrokerPartitionMovementConcurrency family.
        Returns the now-effective override map.
        """
        # validate everything BEFORE applying anything: a rejected call
        # must not leave a partial override active on the live execution
        staged: dict[str, float | int] = {}
        for name, v in (
            ("inter_broker", inter_broker),
            ("intra_broker", intra_broker),
            ("leadership", leadership),
        ):
            if v is not None:
                if v < 1:
                    raise ValueError(f"{name} concurrency must be >= 1, got {v}")
                staged[name] = int(v)
        if progress_check_interval_s is not None:
            if progress_check_interval_s <= 0:
                raise ValueError(
                    "progress_check_interval_s must be > 0, got "
                    f"{progress_check_interval_s}"
                )
            staged["interval_s"] = float(progress_check_interval_s)
        with self._lock:
            # checked under the lock: overrides die with the execution
            # (cleared at the next start), so accepting one after the
            # execution finished would 200 a silent no-op
            if not self.has_ongoing_execution:
                raise NoOngoingExecutionError(
                    "cannot change execution concurrency: no ongoing execution"
                )
            self._requested.update(staged)
        return self.requested_concurrency()

    def requested_concurrency(self) -> dict:
        """The active mid-execution overrides (empty when none set)."""
        with self._lock:
            return dict(self._requested)

    def _inter_cap(self, options: ExecutionOptions) -> int:
        with self._lock:
            v = self._requested.get("inter_broker")
        return int(v) if v is not None else options.concurrent_partition_movements_per_broker

    def _intra_cap(self, options: ExecutionOptions) -> int:
        with self._lock:
            v = self._requested.get("intra_broker")
        return int(v) if v is not None else options.concurrent_intra_broker_partition_movements

    def _leader_cap(self, options: ExecutionOptions) -> int:
        with self._lock:
            v = self._requested.get("leadership")
        return int(v) if v is not None else options.concurrent_leader_movements

    def _interval(self, options: ExecutionOptions) -> float:
        with self._lock:
            v = self._requested.get("interval_s")
        return float(v) if v is not None else options.progress_check_interval_s

    # ------------------------------------------------------------------

    def _pruned(self, history: dict[int, int], retention_ms: int) -> set[int]:
        # readers run on HTTP/detector threads while the execution thread
        # inserts under the lock — prune must take it too
        with self._lock:
            cutoff = self._clock() - retention_ms
            for b in [b for b, ts in history.items() if ts < cutoff]:
                del history[b]
            return set(history)

    @property
    def removed_brokers(self) -> set[int]:
        """Recently removed brokers, expired per the retention window."""
        return self._pruned(self._removed_history, self._removal_retention_ms)

    @property
    def demoted_brokers(self) -> set[int]:
        """Recently demoted brokers, expired per the retention window."""
        return self._pruned(self._demoted_history, self._demotion_retention_ms)

    def drop_removed_brokers(self, broker_ids):
        """Reference ADMIN drop_recently_removed_brokers."""
        with self._lock:
            for b in broker_ids:
                self._removed_history.pop(b, None)
            self._journal_reservations()

    def drop_demoted_brokers(self, broker_ids):
        with self._lock:
            for b in broker_ids:
                self._demoted_history.pop(b, None)
            self._journal_reservations()

    @property
    def has_ongoing_execution(self) -> bool:
        return self.state != ExecutorState.NO_TASK_IN_PROGRESS

    def stop_execution(self, *, force: bool = False):
        """Reference Executor.userTriggeredStopExecution (+ force stop :1145)."""
        with self._lock:
            if self.has_ongoing_execution:
                self._stop_requested = True
                self._force_stop = force
                self.num_executions_stopped += 1
                self.state = ExecutorState.STOPPING_EXECUTION
                # reference Executor execution-stopped gauge (:118-125,257)
                self.sensors.counter("executor.execution-stopped").inc()
                if force:
                    self.sensors.counter("executor.execution-stopped.forced").inc()

    def execute_proposals(
        self,
        proposals: list[ExecutionProposal],
        options: ExecutionOptions | None = None,
        *,
        uuid: str | None = None,
        removed_brokers: set[int] | None = None,
        demoted_brokers: set[int] | None = None,
        strategy_context: dict | None = None,
        strategy: ReplicaMovementStrategy | None = None,
    ) -> ExecutionResult:
        """Reference Executor.executeProposals():395 (synchronous variant).

        strategy: per-execution ordering override (reference per-request
        replica_movement_strategies); falls back to the configured default."""
        from cruise_control_tpu_torch.fleet.leases import FencedError

        options = options or ExecutionOptions()
        with self._lock:
            if self.has_ongoing_execution:
                raise OngoingExecutionError("an execution is already in progress")
            self.state = ExecutorState.STARTING_EXECUTION
            try:
                self._stop_requested = False
                self._force_stop = False
                self._uuid = uuid
                self.num_executions_started += 1
                # reference Executor execution-started sensor (:118-125)
                self.sensors.counter("executor.execution-started").inc()
                now = self._clock()
                for b in removed_brokers or ():
                    self._removed_history[b] = now
                for b in demoted_brokers or ():
                    self._demoted_history[b] = now
                self.tracker = ExecutionTaskTracker(observer=self._journal_task)
                self._reexecutions = {}
                self._intra_unknown = {}
                self._requested = {}  # overrides die with the previous one
                self._recovery = None
                self._fenced_abort = False
                self._exec_reaped = 0
                self._exec_started_ms = now
                self._planner = ExecutionTaskPlanner(strategy or self.strategy)
                tasks = self._planner.add_execution_proposals(
                    proposals, strategy_context
                )
                for t in tasks:
                    self.tracker.add(t)
                if self.journal is not None:
                    # durable BEFORE the first cluster mutation: a crash at
                    # any later point finds every task + reservation in the
                    # journal
                    self.journal.start_execution({
                        "uuid": uuid,
                        "ms": now,
                        "options": dataclasses.asdict(options),
                        "tasks": [
                            task_to_journal(t, self._partition_key(t.proposal))
                            for t in tasks
                        ],
                        "removed": {
                            str(b): ms for b, ms in self._removed_history.items()
                        },
                        "demoted": {
                            str(b): ms for b, ms in self._demoted_history.items()
                        },
                    })
            except BaseException as e:
                # a setup failure (bad proposals, fenced journal start, ...)
                # must not wedge the executor in STARTING_EXECUTION — that
                # state blocks every later execution AND reconciliation
                self.state = ExecutorState.NO_TASK_IN_PROGRESS
                self._planner = None
                if isinstance(e, FencedError):
                    self._fenced_abort = True
                    self.sensors.counter("executor.fenced-aborts").inc()
                raise
        with self.tracer.span(
            "executor.execution",
            component="executor",
            uuid=uuid,
            num_tasks=len(tasks),
        ) as sp:
            self._exec_span = sp
            try:
                result = self._run_guarded(options, proposals)
            finally:
                self._exec_span = None
            sp.set(
                completed=result.completed, aborted=result.aborted,
                dead=result.dead, stopped=result.stopped, ticks=result.ticks,
            )
            return result

    def _run_guarded(
        self,
        options: ExecutionOptions,
        proposals,
        *,
        in_flight=None,
        intra_in_flight=None,
        adaptive_initial: int | None = None,
    ) -> ExecutionResult:
        """Throttle lifecycle + state reset around the execution loop, in
        try/finally so no exit path — exception included — leaks a
        replication throttle onto the brokers or wedges the executor state.

        FencedError (fleet HA) aborts the batch cleanly: the zombie's
        cleanup calls are themselves fenced (it must not clear a throttle
        the NEW holder's reconciliation is about to sweep), the local
        state still resets, nothing is journaled, and the error
        propagates so the caller knows the lease is gone."""
        from cruise_control_tpu_torch.fleet.leases import FencedError

        throttle = ReplicationThrottleHelper(
            self.admin, options.replication_throttle_bytes_per_s,
            journal=self.journal,
        )
        uuid = self._uuid
        try:
            try:
                throttle.set_throttles(proposals, self.topic_names)
                result = self._run(
                    options, in_flight=in_flight,
                    intra_in_flight=intra_in_flight,
                    adaptive_initial=adaptive_initial,
                )
            finally:
                try:
                    throttle.clear_throttles()
                finally:
                    with self._lock:
                        self.state = ExecutorState.NO_TASK_IN_PROGRESS
                        self._planner = None
                        self._adjuster = None
            # inside the guard: a lease lost between the last task and the
            # finished-record append is STILL a fenced abort, not an
            # anonymous exception
            self._finish_execution(result, uuid)
        except FencedError:
            with self._lock:
                self._fenced_abort = True
            self.sensors.counter("executor.fenced-aborts").inc()
            # the observer still hears about the episode's end: a fenced
            # abort IS this execution's outcome (the new holder resumes
            # under its own decision)
            self._notify_execution_observer(
                result=None, uuid=uuid, fenced=True
            )
            raise
        return result

    def _notify_execution_observer(self, *, result, uuid, fenced: bool):
        obs = self.execution_observer
        if obs is None:
            return
        now = self._clock()
        started = self._exec_started_ms
        info = {
            "uuid": uuid,
            "startedMs": started,
            "finishedMs": now,
            "durationS": (
                round((now - started) / 1000.0, 3) if started is not None else None
            ),
            "completed": result.completed if result is not None else 0,
            "aborted": result.aborted if result is not None else 0,
            "dead": result.dead if result is not None else 0,
            "stopped": bool(result.stopped) if result is not None else False,
            "fencedAbort": bool(fenced),
            "reaped": self._exec_reaped,
        }
        try:
            obs(info)
        except Exception:  # noqa: BLE001 — observers must not fail the
            # execution (same contract as the notifier hook above)
            pass

    def _result(self, *, ticks: int) -> ExecutionResult:
        return ExecutionResult(
            completed=self.tracker.count(state=TaskState.COMPLETED),
            aborted=self.tracker.count(state=TaskState.ABORTED),
            dead=self.tracker.count(state=TaskState.DEAD),
            ticks=ticks,
            stopped=self._stop_requested,
            tracker_status=self.tracker.status(),
        )

    def _finish_execution(self, result: ExecutionResult, uuid: str | None):
        if self.journal is not None:
            self.journal.append({
                "t": "finished",
                "ms": self._clock(),
                "result": {
                    "completed": result.completed,
                    "aborted": result.aborted,
                    "dead": result.dead,
                    "stopped": result.stopped,
                },
            })
        with self._lock:
            self.state = ExecutorState.NO_TASK_IN_PROGRESS
        if self.notifier is not None:
            try:
                self.notifier.on_execution_finished(result, uuid)
            except Exception:  # noqa: BLE001 — a broken notifier must not fail the execution
                pass
        self._notify_execution_observer(result=result, uuid=uuid, fenced=False)

    # ------------------------------------------------------------------

    def _maybe_alert_slow_task(self, task, data_bytes, floor_mb_s, options, now):
        """Reference slow-task alerting (ExecutorConfig:142-158): alert once
        when a move runs past task.execution.alerting.threshold.ms AND its
        data rate (bytes -> MB/s) is under the configured floor."""
        if task.alert_time_ms >= 0:
            return
        elapsed_ms = now - task.start_time_ms
        if elapsed_ms <= options.task_execution_alerting_s * 1000:
            return
        if data_bytes / 1e6 / max(elapsed_ms / 1000.0, 1e-9) >= floor_mb_s:
            return
        task.alert_time_ms = now
        self.sensors.counter("executor.slow-task-alert").inc()
        if self.notifier is not None and hasattr(self.notifier, "on_task_alert"):
            try:
                self.notifier.on_task_alert(task)
            except Exception:  # noqa: BLE001 — a broken notifier must not fail the execution
                pass

    def _reap_stuck_move(
        self, task, key, in_flight, watermark, now: int, stalled_ms: int
    ):
        """Stuck-move reaper enforcement: cancel the wedged reassignment —
        per-partition rollback where the controller supports it, DEAD
        otherwise — journal it, raise EXECUTION_STUCK, and let the rest of
        the batch keep flowing."""
        cancel = getattr(self.admin, "cancel_partition_reassignments", None)
        rolled_back = False
        if cancel is not None:
            try:
                cancel([key])
                rolled_back = True
            except Exception:  # noqa: BLE001 — an uncancellable move still
                # must not wedge the batch; fall through to DEAD
                rolled_back = False
        if rolled_back:
            task.aborting(now)
            task.aborted(now)
            self.sensors.counter("executor.reaper.rollback").inc()
        else:
            task.kill(now)
        del in_flight[key]
        watermark.pop(key, None)
        self._exec_reaped += 1
        self.sensors.counter("executor.reaper.stuck-task").inc()
        sp = self._exec_span
        if sp is not None:
            sp.event(
                "reaped",
                id=task.execution_id,
                mode="rollback" if rolled_back else "dead",
                stalled_s=round(stalled_ms / 1000.0, 3),
            )
        if self.journal is not None:
            self.journal.append({
                "t": "reaped",
                "id": task.execution_id,
                "mode": "rollback" if rolled_back else "dead",
                "ms": now,
            })
        if self.anomaly_sink is not None:
            from cruise_control_tpu_torch.detector.anomalies import ExecutionStuck

            try:
                self.anomaly_sink(ExecutionStuck(
                    topic=key[0],
                    partition=key[1],
                    execution_id=task.execution_id,
                    uuid=self._uuid or "",
                    stalled_s=stalled_ms / 1000.0,
                    rolled_back=rolled_back,
                ))
            except Exception:  # noqa: BLE001 — anomaly delivery is best-effort
                pass

    def _run(
        self,
        options: ExecutionOptions,
        *,
        in_flight: dict[tuple[str, int], ExecutionTask] | None = None,
        intra_in_flight: dict | None = None,
        adaptive_initial: int | None = None,
    ) -> ExecutionResult:
        """The proposal execution loop (reference ProposalExecutionRunnable.run:749):
        phase 1 — inter/intra-broker replica moves; phase 2 — leadership.

        in_flight / intra_in_flight: moves re-adopted by restart
        reconciliation — tracked to completion without re-submission.
        adaptive_initial: journaled adaptive cap a resumed execution picks
        back up — a cluster that was stressed moments before the crash
        must not be re-hit at full base concurrency."""
        planner = self._planner
        assert planner is not None
        in_flight = in_flight if in_flight is not None else {}
        #: intra-broker tasks still copying between logdirs:
        #: execution id -> (task, {(topic, partition, broker): target disk})
        intra_in_flight = intra_in_flight if intra_in_flight is not None else {}
        ticks = 0
        simulated = hasattr(self.admin, "tick")
        # admins that cannot report logdir-copy progress complete intra
        # moves on submit (the pre-KIP-113 behavior)
        track_intra = hasattr(self.admin, "in_progress_logdir_moves")
        # stuck-move reaper state: key -> (last observed remaining bytes,
        # last progress ms).  remaining-bytes sampling is an optional admin
        # capability; without it the watermark only advances on completion.
        reap_timeout_ms = (
            int(options.reaper_stuck_timeout_s * 1000)
            if options.reaper_stuck_timeout_s
            else None
        )
        remaining_fn = getattr(self.admin, "reassignment_remaining_bytes", None)
        watermark: dict[tuple[str, int], tuple[float | None, int]] = {}
        adjuster = None
        if options.adaptive_enabled:
            adjuster = ConcurrencyAdjuster(
                base_inter=self._inter_cap(options),
                base_cluster=options.max_num_cluster_movements,
                min_cap=options.adaptive_min_concurrency,
                max_cap=options.adaptive_max_concurrency,
                backoff_factor=options.adaptive_backoff_factor,
                recover_step=options.adaptive_recover_step,
                urp_slack=options.adaptive_urp_slack,
                stall_ticks=options.adaptive_stall_ticks,
                initial=adaptive_initial,
                sensors=self.sensors,
                journal=self.journal,
            )
            self._adjuster = adjuster

        def now_ms() -> int:
            return self._clock() if not simulated else ticks * 1000

        # intra-broker completions land AFTER the adjuster's observe() in
        # the tick that collects them — carried into the next tick so an
        # intra-heavy execution is not falsely judged throughput-stalled
        carried_completions = 0

        # --- phase 1: replica movements ---
        self.state = ExecutorState.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
        while ticks < options.max_ticks:
            if self._stop_requested:
                self._handle_stop(in_flight, now_ms())
                if self._force_stop:
                    # logdir copies cannot be cancelled over the wire; the
                    # tasks are recorded aborted (reference behavior: an
                    # intra move is 'cancelled' by moving back later)
                    for t, _keys in intra_in_flight.values():
                        t.aborting(now_ms())
                        t.aborted(now_ms())
                    intra_in_flight.clear()
                    break
                # graceful stop: submit nothing new, but keep collecting
                # completions until everything in flight drains — an
                # untracked reassignment or logdir copy would otherwise sit
                # IN_PROGRESS in the tracker forever and the result counts
                # would not add up to the task total
                if not in_flight and not intra_in_flight:
                    break
            # collect completions.  A key leaving the in-progress set does
            # NOT prove the move landed: the controller may have dropped the
            # reassignment (reference Executor.maybeReexecuteTasks:1430) —
            # verify against the topology and re-submit dropped tasks, up to
            # a bound, before declaring them DEAD.
            in_progress = self.admin.in_progress_reassignments()
            # ONE topology snapshot per tick feeds both the landed-check and
            # the dead-broker sweep below (on a real cluster each topology()
            # is a wire Metadata round trip)
            topo = self.admin.topology()
            parts = None
            completed_this_tick = carried_completions
            carried_completions = 0
            for key, task in list(in_flight.items()):
                if key not in in_progress:
                    if parts is None:
                        parts = self._partitions_by_key(topo)
                    p = parts.get(key)
                    if p is not None and set(p.replicas) == set(task.proposal.new_replicas):
                        task.completed(now_ms())
                        del in_flight[key]
                        watermark.pop(key, None)
                        completed_this_tick += 1
                        continue
                    n = self._reexecutions.get(key, 0)
                    if n >= options.max_reexecution_attempts:
                        task.kill(now_ms())
                        del in_flight[key]
                        watermark.pop(key, None)
                        continue
                    self._reexecutions[key] = n + 1
                    # reference Executor sensor analog for re-executed tasks
                    self.sensors.counter("executor.task-reexecuted").inc()
                    self.admin.reassign_partitions([
                        ReassignmentSpec(
                            topic=key[0],
                            partition=key[1],
                            new_replicas=tuple(task.proposal.new_replicas),
                            data_to_move=task.proposal.inter_broker_data_to_move,
                        )
                    ])
                else:
                    self._maybe_alert_slow_task(
                        task,
                        task.proposal.inter_broker_data_to_move,
                        options.inter_broker_rate_alerting_mb_s,
                        options,
                        now_ms(),
                    )
            # stuck-move reaper: a move whose progress watermark stalls past
            # the timeout is cancelled (rollback where supported, else DEAD)
            # instead of holding its concurrency slots until max_ticks
            if reap_timeout_ms is not None and in_flight:
                rem_bytes = remaining_fn() if remaining_fn is not None else {}
                for key, task in list(in_flight.items()):
                    if key not in in_progress:
                        continue
                    rem = rem_bytes.get(key)
                    last_rem, last_ms = watermark.get(key, (None, now_ms()))
                    if key not in watermark:
                        watermark[key] = (rem, now_ms())
                    elif rem is not None and (last_rem is None or rem < last_rem):
                        watermark[key] = (rem, now_ms())  # progress observed
                    elif now_ms() - last_ms >= reap_timeout_ms:
                        self._reap_stuck_move(
                            task, key, in_flight, watermark,
                            now_ms(), now_ms() - last_ms,
                        )
            # mark tasks dead when a destination broker died mid-move
            alive = topo.alive_broker_ids()
            for key, task in list(in_flight.items()):
                if not set(task.proposal.new_replicas) <= alive:
                    task.kill(now_ms())
                    del in_flight[key]
                    watermark.pop(key, None)
            # same sweep for logdir copies: a copy on a dead broker can
            # never confirm — without this the phase-1 loop would spin on
            # it until max_ticks
            for eid, (t, keys) in list(intra_in_flight.items()):
                if any(b not in alive for (_tn, _pn, b) in keys):
                    t.kill(now_ms())
                    del intra_in_flight[eid]

            # load-aware adaptive caps: sample stress, adjust (AIMD)
            inter_cap = self._inter_cap(options)
            cluster_cap = options.max_num_cluster_movements
            if adjuster is not None:
                inter_cap, cluster_cap = adjuster.observe(
                    topo,
                    completed=completed_this_tick,
                    in_flight=len(in_flight) + len(intra_in_flight),
                    base_inter=self._inter_cap(options),
                )

            # drain new tasks within caps (per-broker AND the global
            # max.num.cluster.movements budget) — unless a graceful stop is
            # draining the in-flight set
            if self._stop_requested:
                new_tasks, intra = [], []
            else:
                ready = self._ready_brokers(options, in_flight, topo, cap=inter_cap)
                budget = max(
                    0,
                    cluster_cap - len(in_flight) - len(intra_in_flight),
                )
                new_tasks = planner.get_inter_broker_replica_movement_tasks(
                    ready, set(in_flight), max_total=budget
                )
                # intra-broker moves share the global movement budget:
                # whatever the inter-broker drain left of it this tick.
                # Copies still in flight consume their broker's slots
                # (num.concurrent.intra.broker.partition.movements caps
                # CONCURRENT copies per broker, not submissions per tick)
                intra_used: dict[int, int] = {}
                for _t, keys in intra_in_flight.values():
                    for (_tn, _pn, b) in keys:
                        intra_used[b] = intra_used.get(b, 0) + 1
                intra_cap = self._intra_cap(options)
                intra = planner.get_intra_broker_replica_movement_tasks(
                    {b: max(0, intra_cap - intra_used.get(b, 0)) for b in alive},
                    max_total=max(0, budget - len(new_tasks)),
                )
            if new_tasks:
                specs = []
                for t in new_tasks:
                    t.in_progress(now_ms())
                    key = self._partition_key(t.proposal)
                    in_flight[key] = t
                    specs.append(
                        ReassignmentSpec(
                            topic=key[0],
                            partition=key[1],
                            new_replicas=tuple(t.proposal.new_replicas),
                            data_to_move=t.proposal.inter_broker_data_to_move,
                        )
                    )
                self.admin.reassign_partitions(specs)
            for t in intra:
                t.in_progress(now_ms())
                tname, pnum = self._partition_key(t.proposal)
                self.admin.alter_replica_logdirs(
                    [
                        (tname, pnum, b, d_new)
                        for (b, _d_old, d_new) in t.proposal.disk_moves
                    ]
                )
                if track_intra:
                    intra_in_flight[t.execution_id] = (t, {
                        (tname, pnum, b): d_new
                        for (b, _d_old, d_new) in t.proposal.disk_moves
                    })
                else:
                    t.completed(now_ms())
                    carried_completions += 1
            # intra-broker copy progress (reference ExecutorAdminUtils
            # DescribeLogDirs future replicas): a task completes when none
            # of its (t, p, broker) copies are still in flight; long slow
            # copies alert like inter-broker moves
            if intra_in_flight:
                still = self.admin.in_progress_logdir_moves()
                verify = getattr(self.admin, "logdir_of", None)
                for eid, (t, keys) in list(intra_in_flight.items()):
                    pending = {}
                    for key3, disk in keys.items():
                        if key3 in still:
                            pending[key3] = disk
                            # observed pending again: the unverifiable
                            # bound is CONSECUTIVE ticks, so re-observation
                            # resets it (transient blips hours apart must
                            # not accumulate into a kill)
                            self._intra_unknown.pop(key3, None)
                            continue
                        if verify is None:
                            continue  # cannot verify: disappearance = done
                        # disappearance does NOT prove the copy landed (a
                        # broker restart aborts the future log) — check the
                        # replica's actual dir, like the inter-broker path
                        # re-verifies against the topology
                        actual = verify(*key3)
                        if actual == disk:
                            self._intra_unknown.pop(key3, None)
                            continue
                        if actual is None:
                            # unverifiable (e.g. broker unreachable): keep
                            # polling, but bounded — a partitioned broker
                            # must not hold the loop open until max_ticks
                            u = self._intra_unknown.get(key3, 0) + 1
                            self._intra_unknown[key3] = u
                            if u > options.max_intra_verify_failures:
                                t.kill(now_ms())
                                del intra_in_flight[eid]
                                pending = None
                                break
                            pending[key3] = disk
                            continue
                        n = self._reexecutions.get(key3, 0)
                        if n >= options.max_reexecution_attempts:
                            t.kill(now_ms())
                            del intra_in_flight[eid]
                            pending = None
                            break
                        self._reexecutions[key3] = n + 1
                        self.sensors.counter("executor.task-reexecuted").inc()
                        try:
                            self.admin.alter_replica_logdirs([(*key3, disk)])
                        except Exception:  # noqa: BLE001 — a failed resubmit
                            # must not abort the whole execution; the copy
                            # stays pending and the bounds above decide
                            pass
                        # a resubmitted copy starts a fresh consecutive
                        # unverifiable window
                        self._intra_unknown.pop(key3, None)
                        pending[key3] = disk
                    if pending is None:
                        continue
                    if not pending:
                        t.completed(now_ms())
                        del intra_in_flight[eid]
                        carried_completions += 1
                        continue
                    intra_in_flight[eid] = (t, pending)
                    self._maybe_alert_slow_task(
                        t,
                        t.proposal.intra_broker_data_to_move,
                        options.intra_broker_rate_alerting_mb_s,
                        options,
                        now_ms(),
                    )

            if (
                not in_flight
                and not intra_in_flight
                and not planner.remaining_inter_broker_moves
                and not planner.remaining_intra_broker_moves
            ):
                break
            ticks += 1
            if simulated:
                self.admin.tick(self._interval(options))
            else:
                time.sleep(self._interval(options))

        # --- phase 2: leadership movements ---
        if not self._stop_requested:
            self.state = ExecutorState.LEADER_MOVEMENT_TASK_IN_PROGRESS
            while not self._stop_requested:
                batch = planner.get_leadership_movement_tasks(
                    min(
                        self._leader_cap(options),
                        options.max_num_cluster_movements,
                    )
                )
                if not batch:
                    break
                specs = []
                for t in batch:
                    t.in_progress(now_ms())
                    tname, pnum = self._partition_key(t.proposal)
                    specs.append(
                        LeadershipSpec(
                            topic=tname,
                            partition=pnum,
                            preferred_leader=t.proposal.new_leader,
                        )
                    )
                self.admin.elect_leaders(specs)
                # confirm against the topology; moves not confirmed within
                # leader.movement.timeout.ms are DEAD (reference
                # ExecutorConfig leader.movement.timeout.ms + the executor's
                # leadership wait loop, Executor.java:1091-1136)
                pending = {self._partition_key(t.proposal): t for t in batch}
                deadline = now_ms() + int(options.leader_movement_timeout_s * 1000)
                while pending:
                    topo2 = self.admin.topology()
                    alive2 = topo2.alive_broker_ids()
                    parts = self._partitions_by_key(topo2)
                    for key, t in list(pending.items()):
                        target = t.proposal.new_leader
                        p = parts.get(key)
                        if p is not None and p.leader == target:
                            t.completed(now_ms())
                            del pending[key]
                        elif target not in alive2:
                            # target broker died — the election can never be
                            # confirmed: DEAD immediately, don't burn the
                            # timeout
                            t.kill(now_ms())
                            del pending[key]
                        elif p is None or target not in p.replicas:
                            # prerequisite replica placement never landed
                            # (e.g. its move task went DEAD) — cancel the
                            # dependent leadership move
                            t.aborting(now_ms())
                            t.aborted(now_ms())
                            del pending[key]
                    if not pending:
                        break
                    if self._stop_requested:
                        # stop mid-confirmation: unconfirmed moves are
                        # aborted, not left dangling
                        for t in pending.values():
                            t.aborting(now_ms())
                            t.aborted(now_ms())
                        pending.clear()
                        break
                    if now_ms() >= deadline:
                        for t in pending.values():
                            t.kill(now_ms())
                            self.sensors.counter(
                                "executor.leader-movement-timeout"
                            ).inc()
                        break
                    if simulated:
                        self.admin.tick(self._interval(options))
                        ticks += 1
                    else:
                        time.sleep(self._interval(options))

        # abort anything still pending after a stop
        for t in self.tracker.tasks(state=TaskState.PENDING):
            t.in_progress(now_ms())
            t.aborting(now_ms())
            t.aborted(now_ms())

        return self._result(ticks=ticks)

    @staticmethod
    def _partitions_by_key(topo) -> dict:
        """(topic, partition) -> PartitionInfo of a topology snapshot (the
        last of two rows with one key wins): the one pass over all
        partitions that a progress tick with a finished move, or a
        leadership batch's confirmation round, makes.  A landed move is
        checked on its row's replica set, which only that move's key
        needs built."""
        return {(p.topic, p.partition): p for p in topo.partitions}

    def _handle_stop(self, in_flight, now: int):
        """Graceful stop finishes nothing new; forced stop cancels in-flight
        reassignments (reference Executor.java:1145)."""
        if self._force_stop:
            self.admin.cancel_reassignments()
            for task in in_flight.values():
                task.aborting(now)
                task.aborted(now)
            in_flight.clear()

    def _ready_brokers(
        self, options: ExecutionOptions, in_flight, topo=None, cap: int | None = None
    ) -> dict[int, int]:
        if cap is None:
            cap = self._inter_cap(options)
        if topo is None:
            topo = self.admin.topology()
        alive = topo.alive_broker_ids()
        used: dict[int, int] = {}
        for task in in_flight.values():
            p = task.proposal
            for b in set(p.old_replicas) ^ set(p.new_replicas):
                used[b] = used.get(b, 0) + 1
        ready = {b: max(0, cap - used.get(b, 0)) for b in alive}
        # dead brokers do no replication work: moves off them are only
        # bounded by the destination's slots (replicas rebuild from alive
        # leaders — reference executes dead-broker evacuation uncapped on
        # the failed side)
        for b in topo.broker_ids():
            if b not in alive:
                ready[b] = 1_000_000
        return ready

    def _partition_key(self, proposal: ExecutionProposal) -> tuple[str, int]:
        """(topic name, partition number) for a proposal: the catalog maps
        the array model's global partition id; without one, proposal ids are
        taken at face value (fixture-built proposals).  Journal-recovered
        proposals carry their original keys (a fresh process has no catalog
        for a predecessor's plan)."""
        override = self._key_override.get((proposal.topic, proposal.partition))
        if override is not None:
            return override
        if self.catalog is not None:
            return self.catalog.partition_key(proposal.partition)
        return (
            self.topic_names.get(proposal.topic, str(proposal.topic)),
            proposal.partition,
        )

    # ------------------------------------------------------------------

    def executor_state(self) -> dict:
        """STATE endpoint payload (reference ExecutorState JSON)."""
        out = {
            "state": self.state.value,
            "numFinishedMovements": self.tracker.count(state=TaskState.COMPLETED),
            "numTotalMovements": len(self.tracker.tasks()),
            "finishedDataMovementMB": self.tracker.finished_data_bytes(),
            # per-type PENDING/IN_PROGRESS/ABORTING/ABORTED/DEAD/COMPLETED
            # breakdown (reference ExecutorState task-state sets)
            "taskStatus": self.tracker.status(),
            "numReexecutedTasks": sum(self._reexecutions.values()),
            "recentlyRemovedBrokers": sorted(self.removed_brokers),
            "recentlyDemotedBrokers": sorted(self.demoted_brokers),
            "numExecutionsStarted": self.num_executions_started,
            "numExecutionsStopped": self.num_executions_stopped,
            "triggeredUserTaskId": self._uuid,
            # operator-requested mid-execution overrides, if any (reference
            # ExecutorState requested*MovementConcurrency fields)
            "requestedConcurrency": self.requested_concurrency(),
        }
        adjuster = self._adjuster
        if adjuster is not None:
            out["adaptiveConcurrency"] = adjuster.state_json()
        recovery = self.recovery_info()
        if recovery is not None:
            out["recovery"] = recovery
        with self._lock:
            if self._fenced_abort:
                # the last execution aborted on a lost lease (fleet HA)
                out["fencedAbort"] = True
        return out
