"""User task management for async operations.

Reference: servlet/UserTaskManager.java (UUID per task, `User-Task-ID`
header, session -> task map, completed-task retention + periodic scan) and
servlet/handler/async/runnable/OperationFuture.java.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

from cruise_control_tpu_torch.service.progress import OperationProgress, Pending

USER_TASK_ID_HEADER = "User-Task-ID"


class TenantOverloadError(RuntimeError):
    """Per-cluster pending-task cap breached (fleet.tenant.max.pending.
    tasks) — surfaces as 429, never as a 500.  Raised by submit() under
    the manager lock so concurrent submissions can't race past the cap.

    `retry_after_s` (set by the server from the tenant queue's measured
    drain rate, falling back to `fleet.tenant.retry.after.s`) rides the
    429 response as a `Retry-After` header so clients back off for a
    meaningful interval instead of hammering."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class UserTask:
    task_id: str
    endpoint: str
    future: Future
    progress: OperationProgress
    created_ms: int  # wall clock, for display (StartMs in the task JSON)
    #: monotonic stamp of submission (wall-clock steps must not expire
    #: fresh tasks or immortalize old ones)
    created_mono: float = dataclasses.field(default_factory=time.monotonic)
    #: monotonic stamp of COMPLETION — retention counts from here, never
    #: from creation.  A rightsize search (or any async op) that runs
    #: longer than the retention window would otherwise expire the moment
    #: it finished, 404ing the very poll that was waiting on it.  Stamped
    #: by a future done-callback; None while the task is in execution
    #: (in-execution tasks are exempt from retention altogether).
    completed_mono: float | None = None
    request_url: str = ""
    #: requesting client identity (reference UserTaskInfo clientIdentity,
    #: filterable via USER_TASKS client_ids)
    client_id: str = ""
    #: flight-recorder trace id of the operation (empty when tracing is
    #: off) — the handle a client uses with GET /trace to replay the
    #: operation's span tree after (or while) it runs
    trace_id: str = ""
    #: fleet cluster this operation targets (empty in single-cluster
    #: deployments) — drives the per-tenant admission control and the
    #: USER_TASKS `clusters` filter
    cluster_id: str = ""

    @property
    def status(self) -> str:
        if self.future.cancelled():
            return "Cancelled"
        if self.future.done():
            return "Completed" if self.future.exception() is None else "CompletedWithError"
        return "Active"

    def to_json(self) -> dict:
        return {
            "UserTaskId": self.task_id,
            "RequestURL": self.request_url or self.endpoint,
            "ClientIdentity": self.client_id,
            "Status": self.status,
            "StartMs": self.created_ms,
            "TraceId": self.trace_id,
            "Cluster": self.cluster_id,
        }


class UserTaskManager:
    """Reference servlet/UserTaskManager.java."""

    def __init__(
        self,
        *,
        max_active_tasks: int = 25,
        max_cached_completed: int = 100,
        completed_retention_ms: int = 86_400_000,
        num_threads: int = 3,
        category_max_cached: dict[str, int] | None = None,
        category_retention_ms: dict[str, int] | None = None,
    ):
        """category_*: per-endpoint-category overrides keyed by the
        CruiseControlEndPoint type (KAFKA_MONITOR / CRUISE_CONTROL_MONITOR /
        KAFKA_ADMIN / CRUISE_CONTROL_ADMIN) — reference
        config/constants/UserTaskManagerConfig.java; unset categories fall
        back to the general cap/retention."""
        # reference AsyncKafkaCruiseControl uses 3 session threads
        self._pool = ThreadPoolExecutor(max_workers=num_threads, thread_name_prefix="user-task")
        self._tasks: dict[str, UserTask] = {}
        self._lock = threading.RLock()
        #: per-cluster recent task-completion stamps (monotonic) — the
        #: drain-rate observations Retry-After is computed from
        self._completions: dict[str, deque] = {}
        self.max_active_tasks = max_active_tasks
        self.max_cached_completed = max_cached_completed
        self.completed_retention_ms = completed_retention_ms
        self.category_max_cached = category_max_cached or {}
        self.category_retention_ms = category_retention_ms or {}

    def submit(self, endpoint: str, fn, *, request_url: str = "",
               task_id: str | None = None, client_id: str = "",
               trace_id: str = "", cluster_id: str = "",
               cluster_max_active: int = 0) -> UserTask:
        """Run fn(progress) on the session pool; returns the UserTask.

        cluster_max_active > 0 enforces the fleet's per-tenant admission
        cap (fleet.tenant.max.pending.tasks) HERE, under the same lock
        that creates the task — a check-then-submit at the caller would
        let two concurrent requests both read count == cap-1 and breach
        the cap the 429 exists to enforce."""
        with self._lock:
            active = sum(1 for t in self._tasks.values() if t.status == "Active")
            if active >= self.max_active_tasks:
                raise RuntimeError("too many active user tasks")
            if cluster_max_active and cluster_id:
                tenant_active = sum(
                    1 for t in self._tasks.values()
                    if t.cluster_id == cluster_id and t.status == "Active"
                )
                if tenant_active >= cluster_max_active:
                    raise TenantOverloadError(
                        f"cluster {cluster_id!r} already has "
                        f"{cluster_max_active} pending tasks "
                        "(fleet.tenant.max.pending.tasks); retry when "
                        "they drain"
                    )
            tid = task_id or str(uuid.uuid4())
            progress = OperationProgress()
            progress.add_step(Pending())
            future = self._pool.submit(fn, progress)
            task = UserTask(
                task_id=tid,
                endpoint=endpoint,
                future=future,
                progress=progress,
                created_ms=int(time.time() * 1000),
                request_url=request_url,
                client_id=client_id,
                trace_id=trace_id,
                cluster_id=cluster_id,
            )
            # completion stamp for retention: set the moment the operation
            # finishes, so the retention window starts when the RESULT
            # became available, not when the task was born.  The same
            # stamp feeds the per-cluster drain-rate window Retry-After
            # is computed from.
            future.add_done_callback(
                lambda f, t=task: self._on_done(t)
            )
            self._tasks[tid] = task
            self._maybe_evict()
            return task

    def _on_done(self, task: UserTask) -> None:
        task.completed_mono = time.monotonic()
        if task.cluster_id:
            with self._lock:
                self._completions.setdefault(
                    task.cluster_id, deque(maxlen=32)
                ).append(task.completed_mono)

    #: drain-rate observation window: completions older than this are
    #: not evidence about the CURRENT drain rate — a burst hours ago
    #: must not shape today's Retry-After (nor may an hour of trickle
    #: inflate it past what the now-idle pool would actually take)
    DRAIN_WINDOW_S = 300.0

    def retry_after_s(self, cluster_id: str, *, default_s: float = 5.0) -> float:
        """Estimated seconds until the tenant's queue has room, from its
        measured drain rate: pending tasks over completions/second in the
        recent window (DRAIN_WINDOW_S; older stamps are pruned as stale
        evidence).  Falls back to `default_s` (fleet.tenant.retry.after.s)
        when too little fresh history exists, and is clamped to [1, 300]
        so a stalled queue can't tell clients to come back next week."""
        now = time.monotonic()
        with self._lock:
            pending = sum(
                1 for t in self._tasks.values()
                if t.cluster_id == cluster_id and t.status == "Active"
            )
            stamps = [
                s for s in self._completions.get(cluster_id, ())
                if now - s <= self.DRAIN_WINDOW_S
            ]
        if len(stamps) >= 2 and stamps[-1] > stamps[0]:
            rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            est = max(1, pending) / max(rate, 1e-9)
            return float(min(300.0, max(1.0, est)))
        return float(min(300.0, max(1.0, default_s)))

    def get(self, task_id: str) -> UserTask | None:
        with self._lock:
            return self._tasks.get(task_id)

    def all_tasks(self) -> list[UserTask]:
        with self._lock:
            return list(self._tasks.values())

    def _category(self, task: UserTask) -> str | None:
        from cruise_control_tpu_torch.config.endpoints import ENDPOINT_TYPES

        return ENDPOINT_TYPES.get(task.endpoint)

    def _maybe_evict(self):
        now = time.monotonic()
        completed = [t for t in self._tasks.values() if t.status != "Active"]
        # a done-callback can race this scan by a hair (future done, stamp
        # not yet written): treat the stamp as "now" — never older
        for t in completed:
            if t.completed_mono is None:
                t.completed_mono = now
        completed.sort(key=lambda t: t.completed_mono)
        # retention by age-SINCE-COMPLETION then by count, with per-category
        # overrides (reference UserTaskManager scanner +
        # UserTaskManagerConfig); ages are monotonic so wall-clock steps
        # cannot mass-evict.  Counting from completion (not creation) keeps
        # a long-running async op — a rightsize search outlasting the
        # retention window — pollable for the full window after it finishes.
        for t in completed:
            cat = self._category(t)
            retention = self.category_retention_ms.get(cat, self.completed_retention_ms)
            if (now - t.completed_mono) * 1000.0 > retention:
                del self._tasks[t.task_id]
        for t in [t for t in completed if t.task_id in self._tasks]:
            cat = self._category(t)
            cap = self.category_max_cached.get(cat)
            if cap is not None:
                in_cat = [
                    x for x in self._tasks.values()
                    if x.status != "Active" and self._category(x) == cat
                ]
                if len(in_cat) > cap:
                    del self._tasks[t.task_id]
                    continue
            overflow = (
                len([x for x in self._tasks.values() if x.status != "Active"])
                > self.max_cached_completed
            )
            if overflow:
                del self._tasks[t.task_id]

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
