"""AnomalyDetector — priority queue + handler dispatch + state tracking.

Reference: detector/AnomalyDetector.java:47 (detectors wired :63-68,
startDetection():189, AnomalyHandlerTask:318 FIX/CHECK/IGNORE dispatch,
skip-and-backoff while the executor is busy), AnomalyDetectorState.java
(rolling per-type history, rates), AnomalyMetrics.java
(mean-time-between-anomalies, self-healing-enabled ratio).

Self-healing fixes dispatch through the SelfHealingActions protocol —
implemented by the service facade: goal violation -> rebalance, broker
failure -> remove_brokers, disk failure -> fix_offline_replicas, slow
brokers -> demote/remove (reference RebalanceRunnable/RemoveBrokersRunnable/
FixOfflineReplicasRunnable/DemoteBrokerRunnable self-healing constructors).
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import threading
import time
from collections import deque
from typing import Protocol

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    SlowBrokers,
    TopicReplicationFactorAnomaly,
)
from cruise_control_tpu_torch.detector.notifier import Action, AnomalyNotifier

log = logging.getLogger(__name__)


class SelfHealingActions(Protocol):
    """Fix entry points the service facade provides."""

    def rebalance(self, reason: str) -> bool:
        ...

    def remove_brokers(self, broker_ids: list[int], reason: str) -> bool:
        ...

    def demote_brokers(self, broker_ids: list[int], reason: str) -> bool:
        ...

    def fix_offline_replicas(self, reason: str) -> bool:
        ...

    def fix_topic_replication_factor(self, topics: dict[str, int], target_rf: int, reason: str) -> bool:
        ...

    @property
    def is_busy(self) -> bool:
        ...


@dataclasses.dataclass
class AnomalyRecord:
    anomaly: Anomaly
    status: str  # DETECTED / IGNORED / CHECKED / FIX_STARTED / FIX_FAILED_TO_START
    handled_ms: int


class AnomalyDetectorState:
    """Rolling anomaly history + self-healing metrics
    (reference detector/AnomalyDetectorState.java, AnomalyMetrics.java)."""

    def __init__(self, history_size: int = 50):
        self.recent: dict[AnomalyType, deque[AnomalyRecord]] = {
            t: deque(maxlen=history_size) for t in AnomalyType
        }
        self.ignored = 0
        self.fixed = 0
        self._detection_times: dict[AnomalyType, list[int]] = {t: [] for t in AnomalyType}

    def record(self, anomaly: Anomaly, status: str, now_ms: int):
        self.recent[anomaly.anomaly_type].append(AnomalyRecord(anomaly, status, now_ms))
        self._detection_times[anomaly.anomaly_type].append(now_ms)
        if status == "IGNORED":
            self.ignored += 1
        if status == "FIX_STARTED":
            self.fixed += 1

    def mean_time_between_anomalies_ms(self, anomaly_type: AnomalyType) -> float:
        """Reference MeanTimeBetweenAnomaliesMs."""
        times = self._detection_times[anomaly_type]
        if len(times) < 2:
            return 0.0
        return (times[-1] - times[0]) / (len(times) - 1)

    def to_json(self, notifier: AnomalyNotifier) -> dict:
        healing = notifier.self_healing_enabled()
        return {
            "selfHealingEnabled": [t.name for t, on in healing.items() if on],
            "selfHealingDisabled": [t.name for t, on in healing.items() if not on],
            "recentAnomalies": {
                t.name: [
                    {
                        "description": r.anomaly.description(),
                        "status": r.status,
                        "detectionMs": r.anomaly.detected_ms,
                    }
                    for r in self.recent[t]
                ]
                for t in AnomalyType
            },
            "meanTimeBetweenAnomaliesMs": {
                t.name: self.mean_time_between_anomalies_ms(t) for t in AnomalyType
            },
            "numSelfHealingStarted": self.fixed,
            "numIgnored": self.ignored,
        }


class AnomalyDetector:
    """Queue + dispatch (reference AnomalyDetector.java:47).

    Synchronous mode: call `register_detector(...)` then `run_once()` per
    detection round (deterministic for tests and for the service's
    scheduler).  `start(interval)` runs rounds on a daemon thread like the
    reference's scheduled executor.
    """

    def __init__(
        self,
        notifier: AnomalyNotifier,
        actions: SelfHealingActions,
        *,
        now_ms=None,
        sensors=None,
        history_size: int = 10,
        tracer=None,
    ):
        from cruise_control_tpu_torch.common.sensors import REGISTRY
        from cruise_control_tpu_torch.common.trace import TRACER

        self.notifier = notifier
        self.actions = actions
        # history_size: reference num.cached.recent.anomaly.states (default 10)
        self.state = AnomalyDetectorState(history_size=history_size)
        self.sensors = sensors if sensors is not None else REGISTRY
        #: flight recorder: each handled anomaly is a `detector.handle`
        #: ROOT span, and a FIX dispatch's whole pipeline (model build,
        #: optimize, execution) nests under it — the trace of a
        #: self-healing action reads exactly like a user request's
        self.tracer = tracer if tracer is not None else TRACER

        def _healing_ratio() -> float:
            enabled = notifier.self_healing_enabled()
            return sum(enabled.values()) / max(1, len(enabled))

        # reference AnomalyMetrics self-healing-enabled ratio sensor
        self.sensors.gauge("anomaly-detector.self-healing-enabled-ratio", _healing_ratio)
        self._queue: list[tuple[int, int, Anomaly]] = []  # (priority, seq, anomaly)
        self._seq = 0
        self._detectors: list = []  # (detect_fn, interval_s | None)
        self._next_due: list[float] = []  # monotonic deadline per detector
        self._now = now_ms or (lambda: int(time.time() * 1000))
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: re-check delays scheduled by CHECK actions: (due_ms, anomaly)
        self._delayed: list[tuple[int, int, Anomaly]] = []

    def register_detector(
        self,
        detect_fn,
        *,
        interval_s: float | None = None,
        error_backoff_s: float | None = None,
    ):
        """detect_fn() -> Anomaly | None (bound method of a detector).

        interval_s: per-detector cadence override (reference
        AnomalyDetectorConfig {goal.violation,metric.anomaly,disk.failure,
        topic.anomaly}.detection.interval.ms, :161-204); None means every
        scheduled round.  error_backoff_s: after a detector raises, it is
        not retried for this long (reference
        broker.failure.detection.backoff.ms)."""
        self._detectors.append((detect_fn, interval_s, error_backoff_s))
        self._next_due.append(0.0)

    def add_anomaly(self, anomaly: Anomaly):
        with self._lock:
            heapq.heappush(
                self._queue, (anomaly.anomaly_type.priority, self._seq, anomaly)
            )
            self._seq += 1

    # ------------------------------------------------------------------

    def run_once(self, *, respect_intervals: bool = False) -> list[AnomalyRecord]:
        """One detection + handling round.

        respect_intervals=True (the scheduled loop) skips detectors whose
        per-detector cadence has not elapsed; the default runs every
        detector — deterministic for tests and for forced rounds."""
        now = self._now()
        with self._lock:
            # re-enqueue due delayed checks
            due = [x for x in self._delayed if x[0] <= now]
            self._delayed = [x for x in self._delayed if x[0] > now]
            for _, _, anomaly in due:
                self.add_anomaly(anomaly)
        mono = time.monotonic()
        for i, (detect, interval_s, error_backoff_s) in enumerate(self._detectors):
            if respect_intervals and mono < self._next_due[i]:
                continue
            if respect_intervals:
                # only scheduled rounds advance the cadence clock — a forced
                # round must not postpone an already-due scheduled run
                self._next_due[i] = mono + (interval_s or 0.0)
            try:
                anomaly = detect()
            except Exception:  # noqa: BLE001 — a broken detector must not stop the loop
                if error_backoff_s:
                    self._next_due[i] = max(
                        self._next_due[i], mono + error_backoff_s
                    )
                continue
            if anomaly is not None:
                self.add_anomaly(anomaly)
        return self._drain()

    def _drain(self) -> list[AnomalyRecord]:
        handled = []
        while True:
            with self._lock:
                if not self._queue:
                    break
                _, _, anomaly = heapq.heappop(self._queue)
            handled.append(self._handle(anomaly))
        return handled

    def _handle(self, anomaly: Anomaly) -> AnomalyRecord:
        """Reference AnomalyHandlerTask:318."""
        with self.tracer.span(
            "detector.handle",
            component="detector",
            root=True,  # detector loop: never attach to a request context
            anomaly_type=anomaly.anomaly_type.name,
        ) as sp:
            rec = self._handle_traced(anomaly)
            sp.set(status=rec.status)
            return rec

    def _handle_traced(self, anomaly: Anomaly) -> AnomalyRecord:
        now = self._now()
        # only FIXABLE anomalies wait for the executor: an alert-only one
        # (EXECUTION_STUCK, OPTIMIZER_DEGRADED) never touches it, and
        # EXECUTION_STUCK in particular is raised DURING an execution —
        # parking it for busy re-checks would delay the operator alert
        # exactly while the wedged move is news
        if self.actions.is_busy and anomaly.fixable:
            # executor busy: re-check later (reference handleAnomalyInProgress);
            # NOT counted in the rate sensors — a busy-delayed anomaly cycling
            # through _handle is one event, not many
            with self._lock:
                self._delayed.append((now + 30_000, self._seq, anomaly))
                self._seq += 1
            rec = AnomalyRecord(anomaly, "CHECKED", now)
            self.state.record(anomaly, "CHECKED", now)
            return rec
        # per-type rate + mean-time-between-anomalies sensors (reference
        # detector/AnomalyMetrics.java, MeanTimeBetweenAnomaliesMs.java)
        self.sensors.meter(
            f"anomaly-detector.{anomaly.anomaly_type.name.lower()}.rate"
        ).mark()
        self.sensors.meter("anomaly-detector.mean-time-between-anomalies").mark()
        result = self.notifier.on_anomaly(anomaly)
        if result.action == Action.IGNORE:
            status = "IGNORED"
        elif result.action == Action.CHECK:
            with self._lock:
                self._delayed.append((now + result.delay_ms, self._seq, anomaly))
                self._seq += 1
            status = "CHECKED"
        else:
            started = self._fix(anomaly)
            status = "FIX_STARTED" if started else "FIX_FAILED_TO_START"
        self.state.record(anomaly, status, now)
        return AnomalyRecord(anomaly, status, now)

    def _fix(self, anomaly: Anomaly) -> bool:
        a = self.actions
        try:
            if isinstance(anomaly, GoalViolations):
                return a.rebalance(reason=anomaly.description())
            if isinstance(anomaly, BrokerFailures):
                return a.remove_brokers(
                    sorted(anomaly.failed_brokers), reason=anomaly.description()
                )
            if isinstance(anomaly, DiskFailures):
                return a.fix_offline_replicas(reason=anomaly.description())
            if isinstance(anomaly, SlowBrokers):
                ids = sorted(anomaly.slow_brokers)
                if anomaly.remove_slow_brokers:
                    return a.remove_brokers(ids, reason=anomaly.description())
                return a.demote_brokers(ids, reason=anomaly.description())
            if isinstance(anomaly, TopicReplicationFactorAnomaly):
                return a.fix_topic_replication_factor(
                    anomaly.bad_topics, anomaly.target_rf, reason=anomaly.description()
                )
        except Exception:  # noqa: BLE001 — fix failure is recorded, not fatal
            return False
        return False

    # ------------------------------------------------------------------

    def start(self, interval_s: float = 30.0):
        if self._thread is not None and self._thread.is_alive():
            # double-start guard: a retried facade start_up (e.g. fleet-HA
            # activation after a partial failure) must not leak a second
            # detection loop thread
            return
        # detectors without an explicit cadence run at the base interval;
        # the loop wakes often enough to honor the shortest cadence
        self._detectors = [
            (fn, i if i else interval_s, eb) for fn, i, eb in self._detectors
        ]
        tick = min([interval_s] + [i for _, i, _ in self._detectors])

        def loop():
            # individual detector exceptions are already contained inside
            # run_once; this catch covers the HANDLING side (notifier, fix
            # dispatch, state recording) — an exception escaping there used
            # to kill the thread silently and end anomaly detection for
            # the life of the process
            while not self._stop.wait(tick):
                try:
                    self.run_once(respect_intervals=True)
                except Exception:  # noqa: BLE001 — the loop must keep ticking
                    self.sensors.counter("detector.loop-failures").inc()
                    log.warning("anomaly detection round failed", exc_info=True)

        self._thread = threading.Thread(target=loop, daemon=True, name="anomaly-detector")
        self._thread.start()

    def shutdown(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def detector_state(self) -> dict:
        out = self.state.to_json(self.notifier)
        # why the last self-healing fix did not start, when the actions
        # implementation tracks it (service/facade.SelfHealingAdapter)
        info = getattr(self.actions, "fix_failure_info", None)
        if info:
            out["lastSelfHealingFixFailure"] = dict(info)
        return out
