"""QoS-aware device scheduler: overload protection for the shared card.

The port of the JAX package's fleet/scheduler.py.  Many clusters' control
cycles share one device; without arbitration a broker-failure re-anneal
queues FIFO behind every steady-state drift cycle, so the component that
exists to react to failures is the one starved by background load.  This
module arbitrates the engine dispatch path:

  * three WORK CLASSES: URGENT (detector fix pipelines: broker failure,
    EXECUTION_STUCK, lease-takeover re-anneals), INTERACTIVE (REST-path
    proposals / simulate / rightsize), BACKGROUND (streaming drift cycles,
    fleet batched scoring, speculative prewarm);
  * a DEADLINE per request from the per-cluster proposal-freshness SLO:
    BACKGROUND gets the full SLO, INTERACTIVE a quarter of it, URGENT one
    slice budget; grants are earliest-deadline-first within a class and
    misses are counted per class;
  * AGING so BACKGROUND never starves: a background ticket that has
    waited `aging_s` ranks with the interactive class, where its older
    deadline eventually wins the EDF tiebreak;
  * BOUNDED-WALL PREEMPTION: a granted non-urgent anneal runs SEGMENTED
    (analyzer/engine.py `segmented_execution`): the fused schedule runs in
    slices bounded by `slice_budget_s`, and the between-slices checkpoint
    pauses the holder whenever an URGENT ticket waits, so an urgent
    request's queue-to-dispatch wait is at most ONE slice of background
    work.  A paused run lets go of its engine for the pause
    (`SegmentContext.paused`: the engine stashes its state on the device
    and releases its run lock), so an urgent request on the same bucket
    runs on the same engine meanwhile;
  * a SHED/BROWNOUT ladder: past the queue-depth/deadline-miss threshold,
    BACKGROUND submissions shed first (counted, never silent), then
    INTERACTIVE admissions are rejected with a Retry-After computed from
    the queue's drain rate; URGENT is never shed.  Overload sustained past
    `brownout_after_s` switches background from shed to BROWNOUT: its
    re-anneals run with a reduced candidate width (`brownout_config`)
    instead of being skipped.  Each overload episode fires ONE
    `FLEET_OVERLOAD` alert-only anomaly through `anomaly_sink`.

No scheduler object means every dispatch runs unsegmented, as before.
`sensors` and `slo_registry` are optional, duck-typed as in the JAX
package; the port's sensor and SLO modules come with the service.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import enum
import logging
import threading
import time
from collections import deque

from cruise_control_tpu_torch.common.blackbox import (
    RECORDER as _BLACKBOX,
    blackbox_context,
)

log = logging.getLogger(__name__)


class WorkClass(enum.IntEnum):
    """Priority order: lower value is granted first (before aging)."""

    URGENT = 0
    INTERACTIVE = 1
    BACKGROUND = 2

    @property
    def label(self) -> str:
        return self.name.lower()


class BackgroundShedError(RuntimeError):
    """A BACKGROUND submission was shed by overload protection — the
    caller (controller cycle, fleet scoring, speculative prewarm) skips
    this cycle; the shed is already counted, never silent."""


class SchedulerOverloadError(RuntimeError):
    """INTERACTIVE admission rejected under severe overload — surfaces as
    429 with the carried Retry-After (server.py), exactly like the
    per-tenant admission cap."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


#: the ambient grant: set while a thread (or a supervisor worker running
#: with the caller's context copied in) executes under a scheduler slot.
#: Nested run() calls execute inline under the outer grant — an URGENT
#: fix pipeline's inner proposals() call must not deadlock waiting on
#: the slot its own pipeline holds.
_HELD: contextvars.ContextVar = contextvars.ContextVar(
    "device_scheduler_held", default=None
)

#: ambient work-class tag: a pipeline-level classification (the detector
#: tags its whole fix pipeline URGENT) that the device-adjacent sections
#: pick up when they acquire the slot.  Tagging instead of holding the
#: slot across the pipeline matters: a fix includes minutes of EXECUTOR
#: work that dispatches nothing — holding the device through it would
#: starve every other tenant for no reason.
_CLASS_TAG: contextvars.ContextVar = contextvars.ContextVar(
    "device_scheduler_class_tag", default=None
)


@contextlib.contextmanager
def tagged(work_class: WorkClass):
    """Tag the enclosed pipeline's device dispatches with (at least) this
    work class; a more urgent ambient tag always wins over the dispatch
    site's default (see `effective_class`)."""
    token = _CLASS_TAG.set(work_class)
    try:
        yield
    finally:
        _CLASS_TAG.reset(token)


def effective_class(default: WorkClass) -> WorkClass:
    """The dispatch site's class, upgraded by any more-urgent ambient
    pipeline tag (never downgraded: a BACKGROUND tag cannot demote an
    interactive request that happens to run inside it)."""
    tag = _CLASS_TAG.get()
    if tag is None:
        return default
    return tag if tag < default else default




@dataclasses.dataclass
class _Ticket:
    work_class: WorkClass
    cluster_id: str
    op: str
    enqueued: float
    deadline: float
    seq: int
    granted: bool = False
    #: a preempted holder waiting to resume: ranked after URGENT but
    #: before every queued ticket, so the paused anneal continues the
    #: moment the urgent work drains (its slot wait is already paid)
    resuming: bool = False
    #: the caller's run() has exited (fn returned OR raised — e.g. the
    #: DeviceSupervisor abandoning a timed-out dispatch while its worker
    #: sits paused in a checkpoint): the ticket must never be granted
    #: again, and a paused worker stops waiting for the slot
    cancelled: bool = False
    #: cumulative wall this ticket spent PAUSED at preemption
    #: checkpoints — read (cross-thread, via the scheduler's pause
    #: clock) by the DeviceSupervisor's bounded wait so
    #: scheduler-imposed pauses do not bill against the device-hang
    #: budget
    paused_s: float = 0.0
    #: clock stamp of a pause currently IN PROGRESS (None otherwise):
    #: the pause clock must include it, or a single pause longer than
    #: the remaining hang budget would still trip DeviceHangError —
    #: the exact failure the clock exists to prevent
    pause_started: float | None = None


class DeviceScheduler:
    """One per service instance (AnalyzerCore): owns the single device
    slot every engine dispatch runs under.  Thread-safe throughout; all
    waits ride one Condition."""

    #: rank of a preempted holder waiting to resume (between URGENT=0
    #: and INTERACTIVE=1)
    _RESUME_RANK = 0.5
    #: sliding window of recent grants feeding the deadline-miss ratio
    _MISS_WINDOW = 16

    def __init__(
        self,
        *,
        slice_budget_s: float = 1.0,
        freshness_slo_s: float = 60.0,
        aging_s: float = 30.0,
        shed_queue_depth: int = 8,
        brownout_after_s: float = 20.0,
        brownout_factor: float = 0.5,
        fast_path_enabled: bool = True,
        sensors=None,
        clock=time.monotonic,
        anomaly_sink=None,
    ):
        if slice_budget_s <= 0:
            raise ValueError(f"slice_budget_s must be > 0, got {slice_budget_s}")
        if not 0.0 < brownout_factor <= 1.0:
            raise ValueError(
                f"brownout_factor must be in (0, 1], got {brownout_factor}"
            )
        if shed_queue_depth < 1:
            raise ValueError(
                f"shed_queue_depth must be >= 1, got {shed_queue_depth}"
            )
        self.slice_budget_s = slice_budget_s
        self.freshness_slo_s = freshness_slo_s
        self.aging_s = aging_s
        self.shed_queue_depth = shed_queue_depth
        self.brownout_after_s = brownout_after_s
        self.brownout_factor = brownout_factor
        #: grant INTERACTIVE dispatches unsegmented when no other tenant
        #: is waiting (config fleet.scheduler.fast.path.enabled) — the
        #: streaming re-anneal's p99 path
        self.fast_path_enabled = fast_path_enabled
        self.sensors = sensors
        self.clock = clock
        #: anomaly callable (detector.AnomalyDetector.add_anomaly) the
        #: FLEET_OVERLOAD episode alert rides; the first facade built
        #: over the core claims it (service/facade.py)
        self.anomaly_sink = anomaly_sink
        #: SloRegistry (common/slo.py) fed one good/bad sample per URGENT
        #: grant — good when the queue-to-dispatch wait met the class
        #: deadline (one slice budget); claimed by the first facade over
        #: the core, exactly like the anomaly sink
        self.slo_registry = None
        self._cond = threading.Condition()
        self._waiting: list[_Ticket] = []
        self._holder: _Ticket | None = None
        self._seq = 0
        #: recent (granted) tickets' deadline-miss booleans
        self._recent_misses: deque[bool] = deque(maxlen=self._MISS_WINDOW)
        #: EWMA of grant->release hold walls (Retry-After estimation)
        self._hold_ewma_s: float | None = None
        #: overload episode state: an episode starts when overload is
        #: first observed and ends once the queue has drained below half
        #: the shed depth with no recent misses (hysteresis, so a queue
        #: hovering at the threshold is ONE episode, not a storm of them)
        self._episode_started: float | None = None
        self.stats = dict(
            sheds={c.label: 0 for c in WorkClass},
            deadline_misses={c.label: 0 for c in WorkClass},
            preemptions=0,
            overload_episodes=0,
            brownout_cycles=0,
            fast_path_grants=0,
            dispatches={c.label: 0 for c in WorkClass},
        )
        if sensors is not None:
            sensors.gauge("fleet.scheduler.queue-depth", self._queue_depth)
            sensors.gauge(
                "fleet.scheduler.brownout-active",
                lambda: 1.0 if self.brownout_active else 0.0,
            )

    # ------------------------------------------------------------ helpers

    def _queue_depth(self) -> int:
        with self._cond:
            return len(self._waiting)

    def deadline_for(
        self, work_class: WorkClass, *, freshness_slo_s: float | None = None
    ) -> float:
        """Relative deadline per class, derived from the (per-cluster)
        proposal-freshness SLO: BACKGROUND must land within the SLO,
        INTERACTIVE within a quarter of it (an operator is watching),
        URGENT within one slice budget (the preemption bound)."""
        slo = freshness_slo_s if freshness_slo_s is not None else self.freshness_slo_s
        if work_class is WorkClass.URGENT:
            return self.slice_budget_s
        if work_class is WorkClass.INTERACTIVE:
            return max(self.slice_budget_s, slo / 4.0)
        return max(self.slice_budget_s, slo)

    def _rank(self, t: _Ticket, now: float):
        if t.resuming:
            cls = self._RESUME_RANK
        elif (
            t.work_class is WorkClass.BACKGROUND
            and now - t.enqueued >= self.aging_s
        ):
            # aged background ranks WITH interactive: its older deadline
            # then wins the EDF tiebreak, so sustained interactive load
            # can delay but never starve it
            cls = float(WorkClass.INTERACTIVE)
        else:
            cls = float(t.work_class)
        return (cls, t.deadline, t.seq)

    def _grant_next_locked(self, now: float) -> None:
        if self._holder is not None or not self._waiting:
            return
        best = min(self._waiting, key=lambda t: self._rank(t, now))
        self._waiting.remove(best)
        best.granted = True
        self._holder = best
        self._cond.notify_all()

    # ---------------------------------------------------------- overload

    def _miss_ratio_locked(self) -> float:
        if len(self._recent_misses) < self._MISS_WINDOW // 2:
            return 0.0
        return sum(self._recent_misses) / len(self._recent_misses)

    def _overloaded_locked(self, now: float) -> bool:
        raw = (
            len(self._waiting) >= self.shed_queue_depth
            or self._miss_ratio_locked() >= 0.5
        )
        if raw:
            if self._episode_started is None:
                self._episode_started = now
                self.stats["overload_episodes"] += 1
                if self.sensors is not None:
                    self.sensors.counter(
                        "fleet.scheduler.overload-episodes"
                    ).inc()
                self._fire_overload_anomaly(now)
            return True
        # hysteresis: the episode ends only once the queue genuinely
        # drained, not on one lucky sample at the threshold
        if (
            self._episode_started is not None
            and len(self._waiting) <= self.shed_queue_depth // 2
            and self._miss_ratio_locked() < 0.5
        ):
            self._episode_started = None
        return self._episode_started is not None

    def _fire_overload_anomaly(self, now: float) -> None:
        """FLEET_OVERLOAD, exactly once per overload episode (alert-only
        — the fix IS this scheduler's shed/brownout ladder; operators
        hear that it engaged)."""
        sink = self.anomaly_sink
        if sink is None:
            return
        try:
            from cruise_control_tpu_torch.detector.anomalies import FleetOverload

            sink(FleetOverload(
                queue_depth=len(self._waiting),
                deadline_miss_ratio=round(self._miss_ratio_locked(), 3),
                episode=self.stats["overload_episodes"],
            ))
        except Exception:  # noqa: BLE001 — alerting must not block scheduling
            log.warning("FLEET_OVERLOAD anomaly delivery failed", exc_info=True)

    @property
    def brownout_active(self) -> bool:
        with self._cond:
            started = self._episode_started
            return (
                started is not None
                and self.clock() - started >= self.brownout_after_s
            )

    def brownout_config(self, cfg):
        """The browned-out twin of an OptimizerConfig: candidate width
        scaled by `brownout_factor` (floored so the engine keeps a working
        candidate split).  ONE quantized step per base config: the reduced
        config is a stable engine-cache key, so brownout costs at most one
        extra engine, and one capture, per bucket, not one per cycle."""
        f = self.brownout_factor
        self.stats["brownout_cycles"] += 1
        if self.sensors is not None:
            self.sensors.counter("fleet.scheduler.brownout-cycles").inc()
        return dataclasses.replace(
            cfg,
            num_candidates=max(64, int(cfg.num_candidates * f)),
            leadership_candidates=max(8, int(cfg.leadership_candidates * f)),
            swap_candidates=max(0, int(cfg.swap_candidates * f)),
        )

    # --------------------------------------------------------- admission

    def retry_after_s(self, *, default_s: float = 5.0) -> float:
        """Estimated time until the queue has room: depth x the recent
        mean hold wall; the config default when nothing has run yet."""
        with self._cond:
            depth = len(self._waiting) + (1 if self._holder is not None else 0)
            hold = self._hold_ewma_s
        if hold is None:
            return max(1.0, default_s)
        return float(min(300.0, max(1.0, depth * hold)))

    def _count_background_shed_locked(self) -> None:
        """ONE accounting site for background sheds (run()'s overload
        branch and voluntary shed_background callers): the stat and the
        sensor must never diverge."""
        self.stats["sheds"][WorkClass.BACKGROUND.label] += 1
        if self.sensors is not None:
            self.sensors.counter("fleet.scheduler.shed-total.background").inc()

    def should_shed_background(self) -> bool:
        """Whether a BACKGROUND submission made now would shed — the
        cheap pre-check callers with an expensive PRELUDE (the precompute
        loop's full model build) use to skip the work the dispatch would
        throw away.  Observing overload here starts the episode exactly
        like a real submission would."""
        with self._cond:
            now = self.clock()
            return self._overloaded_locked(now) and not self._brownout_locked(now)

    def shed_background(self, *, op: str = "") -> None:
        """Count one voluntarily shed BACKGROUND cycle (a caller that
        decided to skip work under overload/brownout — e.g. speculative
        prewarm, which must never add pressure during an episode).  Sheds
        are never silent: every skipped cycle lands in
        `fleet.scheduler.shed-total.background`."""
        with self._cond:
            self._count_background_shed_locked()
        log.debug("background dispatch %s shed", op or "?")

    def admit_interactive(
        self, *, cluster_id: str = "", default_retry_after_s: float = 5.0
    ) -> None:
        """The INTERACTIVE rung of the shed ladder, checked at REST
        admission BEFORE a user task is created: only SEVERE overload
        (queue at twice the background-shed depth) rejects, and the 429
        carries a drain-rate Retry-After.  URGENT work never passes
        through here — it can never be shed."""
        with self._cond:
            severe = len(self._waiting) >= 2 * self.shed_queue_depth
            if severe:
                self.stats["sheds"][WorkClass.INTERACTIVE.label] += 1
                if self.sensors is not None:
                    self.sensors.counter(
                        "fleet.scheduler.shed-total.interactive"
                    ).inc()
        if severe:
            ra = self.retry_after_s(default_s=default_retry_after_s)
            who = f" for cluster {cluster_id!r}" if cluster_id else ""
            raise SchedulerOverloadError(
                f"device scheduler overloaded ({self._queue_depth()} dispatches "
                f"queued); new work{who} rejected, retry in {ra:.0f}s",
                retry_after_s=ra,
            )

    # ------------------------------------------------------------- run

    def run(
        self,
        work_class: WorkClass,
        fn,
        *,
        cluster_id: str = "",
        op: str = "",
        freshness_slo_s: float | None = None,
        preemptible: bool | None = None,
    ):
        """Execute fn() holding the device slot, honoring class priority,
        deadlines, aging, preemption and the shed ladder.

        Runs INLINE on the caller's thread (the scheduler arbitrates, it
        does not own worker threads — a supervised dispatch still rides
        the DeviceSupervisor's bounded worker underneath).  Reentrant: a
        call made while this context already holds the slot executes
        immediately under the outer grant.  BACKGROUND submissions raise
        BackgroundShedError under overload (unless brownout is active, in
        which case they run — browned out by the caller via
        `brownout_config`).  Non-urgent grants execute under a
        SegmentContext so the engine's fused anneal runs preemptibly."""
        if _HELD.get() is not None:
            return fn()
        now = self.clock()
        with self._cond:
            overloaded = self._overloaded_locked(now)
            if (
                work_class is WorkClass.BACKGROUND
                and overloaded
                and not self._brownout_locked(now)
            ):
                self._count_background_shed_locked()
                raise BackgroundShedError(
                    f"background dispatch {op or '?'} shed under overload "
                    f"(queue depth {len(self._waiting)})"
                )
            ticket = _Ticket(
                work_class=work_class,
                cluster_id=cluster_id,
                op=op,
                enqueued=now,
                deadline=now + self.deadline_for(
                    work_class, freshness_slo_s=freshness_slo_s
                ),
                seq=self._seq,
            )
            self._seq += 1
            self._waiting.append(ticket)
            self._grant_next_locked(now)
            while not ticket.granted:
                self._cond.wait(0.05)
                self._grant_next_locked(self.clock())
            granted_at = self.clock()
            wait = max(0.0, granted_at - ticket.enqueued)
            missed = granted_at > ticket.deadline
            self._recent_misses.append(missed)
            self.stats["dispatches"][work_class.label] += 1
            if missed:
                self.stats["deadline_misses"][work_class.label] += 1
            # fast-path eligibility is decided UNDER the lock: granted
            # with nobody else queued means segmentation would buy no
            # responsiveness — there is no one to preempt for
            alone = not self._waiting
        cls = work_class.label
        if self.sensors is not None:
            self.sensors.timer(f"fleet.scheduler.wait-timer.{cls}").update(wait)
            if missed:
                self.sensors.counter(
                    f"fleet.scheduler.deadline-misses.{cls}"
                ).inc()
        if work_class is WorkClass.URGENT and self.slo_registry is not None:
            # the urgent queue-wait SLO: one sample per grant, good when
            # the wait landed inside the class deadline (one slice budget
            # — the preemption bound the scheduler promises)
            self.slo_registry.record("urgent-queue-wait", not missed)
        # black-box instant: the grant's class/wait/deadline verdict land
        # in the durable spool, and the context stamps them onto every
        # device record this grant dispatches (common/blackbox.py)
        if _BLACKBOX.enabled:
            _BLACKBOX.event(
                "sched-grant", work_class=cls, op=op, cluster=cluster_id,
                queue_wait_s=round(wait, 4), deadline_missed=missed,
            )
        if preemptible is None:
            preemptible = work_class is not WorkClass.URGENT
            if (
                preemptible
                and self.fast_path_enabled
                and work_class is WorkClass.INTERACTIVE
                and alone
            ):
                # fast-path grant: an INTERACTIVE dispatch granted with an
                # empty queue runs UNSEGMENTED — segmented mode's per-slice
                # blocking syncs exist to bound URGENT wait, and with no
                # other tenant waiting they only cut into the streaming
                # re-anneal's p99.  Callers that pass an explicit
                # `preemptible` keep exactly what they asked for.
                preemptible = False
                self.stats["fast_path_grants"] += 1
                if self.sensors is not None:
                    self.sensors.counter(
                        "fleet.scheduler.fast-path-grants"
                    ).inc()
        token = _HELD.set(ticket)
        try:
            with blackbox_context(
                work_class=cls, queue_wait_s=round(wait, 4)
            ):
                if preemptible and self.slice_budget_s > 0:
                    from cruise_control_tpu_torch.analyzer.engine import (
                        SegmentContext,
                        segmented_execution,
                    )
                    from cruise_control_tpu_torch.common.device_watchdog import (
                        pause_clock_scope,
                    )

                    ctx = SegmentContext(self.slice_budget_s)
                    ctx.checkpoint = lambda t=ticket, c=ctx: self._checkpoint(t, c)
                    # the supervisor's hang budget must exclude time WE
                    # pause this dispatch at preemption checkpoints —
                    # including a pause still in progress
                    with pause_clock_scope(
                        lambda t=ticket: self._ticket_pause_s(t)
                    ):
                        with segmented_execution(ctx):
                            return fn()
                return fn()
        finally:
            _HELD.reset(token)
            self._release(ticket, granted_at)

    def _brownout_locked(self, now: float) -> bool:
        started = self._episode_started
        return started is not None and now - started >= self.brownout_after_s

    def _release(self, ticket: _Ticket, granted_at: float) -> None:
        """End of a grant: run() exited (fn returned or RAISED).  The
        ticket may be the live holder, or — when the DeviceSupervisor
        abandoned a timed-out dispatch whose worker sits paused in a
        checkpoint — still queued at resume rank: it must be pulled from
        the queue and cancelled, or the zombie worker would later
        re-acquire the slot with nobody left to release it and wedge the
        scheduler forever (every later run() would wait on a holder that
        never clears)."""
        with self._cond:
            # hold wall EXCLUDES checkpoint pauses: the paused time is
            # the preempting urgent grant's hold, already recorded on its
            # own ticket — double-counting it would inflate the drain
            # estimate behind every Retry-After
            hold = max(0.0, self.clock() - granted_at - ticket.paused_s)
            self._hold_ewma_s = (
                hold if self._hold_ewma_s is None
                else 0.7 * self._hold_ewma_s + 0.3 * hold
            )
            ticket.cancelled = True
            if self._holder is ticket:
                self._holder = None
            elif ticket in self._waiting:
                self._waiting.remove(ticket)
            self._cond.notify_all()
            self._grant_next_locked(self.clock())

    def _checkpoint(self, ticket: _Ticket, ctx=None) -> None:
        """Between-slices preemption point (engine SegmentContext): when
        an URGENT ticket is waiting, the holder yields the slot HERE —
        the device is idle at a slice boundary — and blocks until
        re-granted at resume rank.  An urgent request therefore waits at
        most one slice of background wall, never a whole anneal.

        Before it yields the slot, the paused run lets go of its engine
        (`ctx.paused()`, the engine's hooks: its state stashed on the
        device, its run lock released), so an urgent request on the same
        engine never waits on the paused run; it takes the engine back
        once the pause ends.

        The pause wall accrues on `ticket.paused_s` so a supervisor's
        hang budget can exclude it (`_ticket_pause_s`), and a ticket
        cancelled while paused (its run() already exited) stops waiting:
        the abandoned worker finishes unslotted."""
        with self._cond:
            if self._holder is not ticket:
                return  # not the active holder (nested/stale checkpoint)
            if not any(
                t.work_class is WorkClass.URGENT for t in self._waiting
            ):
                return
            self.stats["preemptions"] += 1
            if self.sensors is not None:
                self.sensors.counter("fleet.scheduler.preemptions").inc()
        with ctx.paused() if ctx is not None else contextlib.nullcontext():
            with self._cond:
                self._holder = None
                ticket.granted = False
                ticket.resuming = True
                self._waiting.append(ticket)
                self._grant_next_locked(self.clock())
                ticket.pause_started = self.clock()
                while not ticket.granted and not ticket.cancelled:
                    self._cond.wait(0.05)
                    self._grant_next_locked(self.clock())
                ticket.paused_s += max(0.0, self.clock() - ticket.pause_started)
                ticket.pause_started = None

    def _ticket_pause_s(self, ticket: _Ticket) -> float:
        """Scheduler-imposed pause of one grant, INCLUDING a pause
        currently in progress — the DeviceSupervisor's hang budget reads
        this live (cond.wait releases the lock, so the read never blocks
        behind a paused checkpoint)."""
        with self._cond:
            extra = (
                max(0.0, self.clock() - ticket.pause_started)
                if ticket.pause_started is not None
                else 0.0
            )
            return ticket.paused_s + extra

    # ------------------------------------------------------------- state

    def state_json(self) -> dict:
        """The `/fleet` scheduler block."""
        with self._cond:
            waiting = list(self._waiting)
            holder = self._holder
            episode = self._episode_started
            now = self.clock()
            out = {
                "enabled": True,
                "queueDepth": len(waiting),
                "queuedByClass": {
                    c.label: sum(1 for t in waiting if t.work_class is c)
                    for c in WorkClass
                },
                "holder": (
                    {"class": holder.work_class.label, "op": holder.op,
                     "cluster": holder.cluster_id}
                    if holder is not None else None
                ),
                "sliceBudgetS": self.slice_budget_s,
                "freshnessSloS": self.freshness_slo_s,
                "overloaded": episode is not None,
                "brownoutActive": (
                    episode is not None
                    and now - episode >= self.brownout_after_s
                ),
                "shedTotal": dict(self.stats["sheds"]),
                "deadlineMisses": dict(self.stats["deadline_misses"]),
                "dispatches": dict(self.stats["dispatches"]),
                "preemptions": self.stats["preemptions"],
                "overloadEpisodes": self.stats["overload_episodes"],
                "brownoutCycles": self.stats["brownout_cycles"],
                "fastPathGrants": self.stats["fast_path_grants"],
            }
        if self.sensors is not None:
            out["waitSeconds"] = {
                c.label: self.sensors.timer(
                    f"fleet.scheduler.wait-timer.{c.label}"
                ).quantiles()
                for c in WorkClass
            }
        return out
