"""Durable execution journal — crash-safe record of everything the
executor does to the real cluster.

Reference: executor/Executor.java persists executor state (ongoing
execution, removed/demoted broker reservations) so a restarted process
can reconcile instead of stranding in-flight reassignments; here the
persistence is an append-only JSONL file (configurable via
`executor.journal.dir`) because there is no ZooKeeper to lean on.

Record stream per execution (one execution per file — `start_execution`
truncates, because a finished predecessor has nothing left to recover):

  {"t": "start", "uuid", "ms", "tasks": [...], "options": {...},
   "removed": {...}, "demoted": {...}}       execution begins
  {"t": "throttle_set", "rate", "topics"}    replication throttle applied
  {"t": "task", "id", "state", "ms"}         every task state transition
  {"t": "concurrency", "inter", "cluster"}   adaptive-cap change
  {"t": "reaped", "id", "mode", "ms"}        stuck-move reaper action
  {"t": "reservation", "removed", "demoted"} reservation map change
  {"t": "throttle_cleared"}                  throttle removed
  {"t": "finished", "ms", "result"}          execution completed cleanly

Writes are batched then flush+fsync'd (`executor.journal.fsync.batch.size`;
1 = every record is durable before the cluster mutation proceeds).  The
`start`, throttle, `reaped` and `finished` records always fsync — they are
the records recovery correctness depends on.  Replay tolerates a torn
final line (the crash happened mid-write): decoding stops at the first
malformed line and everything before it is trusted.  A zero-length file —
a crash between file creation and the fsync'd start record — means "no
unfinished execution", never an error.

Fencing (fleet HA, fleet/leases.py): with a `fence` attached, every
append first checks the lease (`Fence.check` raises `FencedError` for a
deposed holder — nothing is written) and stamps the live lease `epoch`
into the record.  Replay tracks a running high-water epoch: a record
whose epoch is BELOW an epoch already seen earlier in the file is a
zombie's late write that slipped in before its fence tripped, and is
ignored so it can never poison reconciliation.  Legitimate mixed epochs
(a takeover resuming its predecessor's execution appends at a higher
epoch) replay in full.

Retention: `start_execution` rotates a FINISHED predecessor into an
archive file (`<journal path>.<ms>.<id>.done`) instead of discarding
it, so the journal dir accumulates one file per terminal execution;
`prune_archives` (run during start-up reconciliation and after each
rotation, per `executor.journal.retention.{count,hours}`) deletes
terminal archives beyond the bounds and NEVER touches a file without a
`finished` record — an unfinished journal awaiting recovery is
sacrosanct.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import uuid as uuid_mod

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskState, TaskType

#: record types that must be durable the moment they are appended,
#: regardless of the fsync batch size
_CRITICAL = frozenset({"start", "throttle_set", "throttle_cleared", "reaped",
                       "finished"})


def proposal_to_journal(p: ExecutionProposal) -> dict:
    """Full round-trippable proposal encoding (the REST `to_json` drops
    fields recovery needs to re-submit a move)."""
    return {
        "partition": int(p.partition),
        "topic": int(p.topic),
        "old_leader": int(p.old_leader),
        "new_leader": int(p.new_leader),
        "old_replicas": [int(b) for b in p.old_replicas],
        "new_replicas": [int(b) for b in p.new_replicas],
        "disk_moves": [[int(b), int(o), int(n)] for (b, o, n) in p.disk_moves],
        "inter": float(p.inter_broker_data_to_move),
        "intra": float(p.intra_broker_data_to_move),
    }


def proposal_from_journal(d: dict) -> ExecutionProposal:
    return ExecutionProposal(
        partition=d["partition"],
        topic=d["topic"],
        old_leader=d["old_leader"],
        new_leader=d["new_leader"],
        old_replicas=tuple(d["old_replicas"]),
        new_replicas=tuple(d["new_replicas"]),
        disk_moves=tuple((b, o, n) for b, o, n in d.get("disk_moves", ())),
        inter_broker_data_to_move=d.get("inter", 0.0),
        intra_broker_data_to_move=d.get("intra", 0.0),
    )


def task_to_journal(task: ExecutionTask, key: tuple[str, int]) -> dict:
    return {
        "id": int(task.execution_id),
        "type": task.task_type.value,
        "key": [key[0], int(key[1])],
        "proposal": proposal_to_journal(task.proposal),
    }


def task_from_journal(d: dict) -> tuple[ExecutionTask, tuple[str, int]]:
    task = ExecutionTask(
        execution_id=d["id"],
        proposal=proposal_from_journal(d["proposal"]),
        task_type=TaskType(d["type"]),
    )
    return task, (d["key"][0], d["key"][1])


class ExecutionJournal:
    """Append-only JSONL journal with fsync'd batches.

    Thread-safe: the execution loop, the reaper and mid-execution admin
    calls may append concurrently.
    """

    def __init__(self, path: str, *, fsync_batch: int = 1, fence=None,
                 retention_count: int | None = None,
                 retention_hours: float | None = None):
        """fence: fleet/leases.py Fence (or None outside fleet HA) — every
        append checks it (FencedError for a deposed holder) and stamps its
        epoch into the record.  retention_count/retention_hours bound the
        archived terminal journals prune_archives() keeps."""
        self.path = os.path.abspath(os.path.expanduser(path))
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.fsync_batch = max(1, int(fsync_batch))
        self.fence = fence
        self.retention_count = retention_count
        self.retention_hours = retention_hours
        self._lock = threading.Lock()
        self._file = None  # opened lazily in append mode
        self._pending = 0
        self.records_written = 0
        self.fsyncs = 0

    # ------------------------------------------------------------- write

    def _ensure_open(self):
        if self._file is None:
            # appending after a crash-torn tail would glue the new record
            # onto the partial line and poison every record after it —
            # truncate back to the last fully-valid record first
            self._repair_torn_tail()
            self._file = open(self.path, "a", encoding="utf-8")  # noqa: SIM115

    def _repair_torn_tail(self):
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except OSError:
            return
        good = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn final line
            s = line.strip()
            if s:
                try:
                    rec = json.loads(s)
                except ValueError:
                    break
                if not isinstance(rec, dict) or "t" not in rec:
                    break
            good += len(line)
        if good < len(data):
            with open(self.path, "rb+") as f:
                f.truncate(good)

    def append(self, record: dict) -> None:
        if self.fence is not None:
            # the fence check happens BEFORE anything touches the file: a
            # deposed holder's append raises FencedError and writes nothing;
            # the live epoch is stamped so replay can spot any write that
            # still raced the handover (prefix high-water filter)
            record = dict(record, epoch=self.fence.check(op="journal.append"))
        line = json.dumps(record, separators=(",", ":"))
        with self._lock:
            self._ensure_open()
            self._file.write(line + "\n")
            self._pending += 1
            self.records_written += 1
            if self._pending >= self.fsync_batch or record.get("t") in _CRITICAL:
                self._fsync_locked()

    def _fsync_locked(self):
        self._file.flush()
        os.fsync(self._file.fileno())
        self._pending = 0
        self.fsyncs += 1

    def flush(self) -> None:
        with self._lock:
            if self._file is not None and self._pending:
                self._fsync_locked()

    def start_execution(self, record: dict) -> None:
        """Begin a new execution: rotate a cleanly-FINISHED predecessor
        into a terminal archive (`<path>.<ms>.<id>.done`, pruned by
        prune_archives), truncate otherwise (an unfinished predecessor was
        already reconciled), and durably write the start record before any
        cluster mutation happens."""
        if self.fence is not None:
            # fenced BEFORE the rotation/truncation: a deposed holder must
            # not destroy the journal the new holder will reconcile from
            self.fence.check(op="journal.start")
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            rotated = self._rotate_terminal_locked()
            self._file = open(self.path, "w", encoding="utf-8")  # noqa: SIM115
            self._pending = 0
        if rotated:
            # opportunistic retention at rotation time too: a long-lived
            # process running many executions must not accumulate archives
            # unboundedly between restarts
            try:
                self.prune_archives()
            except OSError:
                pass
        self.append(dict(record, t="start"))

    def _rotate_terminal_locked(self) -> bool:
        """Archive the previous journal file IF it recorded a finished
        execution; unfinished (reconciled) or empty predecessors are
        simply overwritten, exactly as before.  True if a file rotated."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except OSError:
            return False
        if not data or b'"t":"finished"' not in data:
            return False
        try:
            ms = int(os.path.getmtime(self.path) * 1000)
        except OSError:
            ms = 0
        archive = f"{self.path}.{ms}.{uuid_mod.uuid4().hex[:8]}.done"
        try:
            os.replace(self.path, archive)
        except OSError:
            return False  # rotation is best-effort; truncation proceeds
        return True

    def prune_archives(self, *, now_ms: int | None = None) -> int:
        """Delete terminal journal archives beyond
        `executor.journal.retention.{count,hours}`.  Runs during start-up
        reconciliation.  Only files that verifiably contain a `finished`
        record are ever removed — the live journal and anything unfinished
        (a journal awaiting recovery) are untouched.  Returns the number
        of files pruned."""
        import time as _time

        if self.retention_count is None and self.retention_hours is None:
            return 0
        d = os.path.dirname(self.path)
        base = os.path.basename(self.path) + "."
        archives: list[tuple[float, str]] = []
        try:
            names = os.listdir(d)
        except OSError:
            return 0
        for fn in names:
            if fn.startswith(base) and fn.endswith(".done"):
                p = os.path.join(d, fn)
                try:
                    archives.append((os.path.getmtime(p), p))
                except OSError:
                    continue
        archives.sort(reverse=True)  # newest first
        doomed: set[str] = set()
        if self.retention_count is not None:
            doomed.update(p for _m, p in archives[max(0, self.retention_count):])
        if self.retention_hours is not None:
            now_s = (now_ms / 1000.0) if now_ms is not None else _time.time()
            cutoff = now_s - self.retention_hours * 3600.0
            doomed.update(p for m, p in archives if m < cutoff)
        pruned = 0
        for p in doomed:
            try:
                with open(p, "rb") as f:
                    terminal = b'"t":"finished"' in f.read()
            except OSError:
                continue
            if not terminal:
                continue  # unfinished journals are never retention-pruned
            try:
                os.remove(p)
                pruned += 1
            except OSError:
                pass
        return pruned

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                if self._pending:
                    self._fsync_locked()
                self._file.close()
                self._file = None

    # -------------------------------------------------------------- read

    def replay(self) -> list[dict]:
        """Decode the journal, tolerating crash truncation: a torn final
        line (or any garbage after it) ends the replay; every record
        before it is returned.  A zero-length file (crash between file
        creation and the fsync'd start record) decodes to [].

        Fencing: records carry the writer's lease epoch (fleet HA).  A
        record whose epoch is BELOW the running high-water epoch of the
        records before it is a deposed holder's late write — dropped, so
        a zombie can never poison reconciliation.  Epoch-less records
        (single-instance deployments) always replay."""
        records: list[dict] = []
        high_water: int | None = None
        try:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break  # torn tail — trust only what decoded
                    if not isinstance(rec, dict) or "t" not in rec:
                        break
                    epoch = rec.get("epoch")
                    if isinstance(epoch, int):
                        if high_water is not None and epoch < high_water:
                            continue  # fenced below high water: zombie write
                        high_water = epoch
                    records.append(rec)
        except OSError:
            return []
        return records

    def unfinished_execution(self) -> "JournaledExecution | None":
        """The in-flight execution a crashed predecessor left behind, or
        None when the journal is absent, zero-length (created but never
        started), or cleanly finished."""
        records = self.replay()
        if not records or records[0].get("t") != "start":
            return None
        if any(r.get("t") == "finished" for r in records):
            return None
        return JournaledExecution.from_records(records)


@dataclasses.dataclass
class JournaledExecution:
    """Parsed view of an unfinished journal: the last-known state of every
    task plus the side effects (throttle, reservations) still standing."""

    uuid: str | None
    options: dict
    started_ms: int
    #: execution id -> (task at its last journaled state, partition key)
    tasks: dict[int, tuple[ExecutionTask, tuple[str, int]]]
    removed: dict[int, int]  # broker id -> reservation ms
    demoted: dict[int, int]
    throttle_active: bool
    throttled_topics: list[str]
    #: last journaled adaptive caps (None = never adjusted)
    adaptive: dict | None

    @staticmethod
    def from_records(records: list[dict]) -> "JournaledExecution":
        start = records[0]
        tasks: dict[int, tuple[ExecutionTask, tuple[str, int]]] = {}
        for td in start.get("tasks", ()):
            task, key = task_from_journal(td)
            tasks[task.execution_id] = (task, key)
        removed = {int(b): int(ms) for b, ms in start.get("removed", {}).items()}
        demoted = {int(b): int(ms) for b, ms in start.get("demoted", {}).items()}
        throttle_active = False
        throttled: list[str] = []
        adaptive = None
        for rec in records[1:]:
            t = rec.get("t")
            if t == "task":
                entry = tasks.get(rec.get("id"))
                if entry is None:
                    continue
                task, _key = entry
                # replay transitions WITHOUT the state machine's validity
                # check: the journal is the authority on what happened
                task.state = TaskState(rec["state"])
                if task.state == TaskState.IN_PROGRESS:
                    task.start_time_ms = rec.get("ms", -1)
                elif task.state in (TaskState.COMPLETED, TaskState.ABORTED,
                                    TaskState.DEAD):
                    task.end_time_ms = rec.get("ms", -1)
            elif t == "throttle_set":
                throttle_active = True
                throttled = list(rec.get("topics", ()))
            elif t == "throttle_cleared":
                throttle_active = False
                throttled = []
            elif t == "reservation":
                removed = {int(b): int(ms)
                           for b, ms in rec.get("removed", {}).items()}
                demoted = {int(b): int(ms)
                           for b, ms in rec.get("demoted", {}).items()}
            elif t == "concurrency":
                adaptive = {k: rec[k] for k in ("inter", "cluster") if k in rec}
        return JournaledExecution(
            uuid=start.get("uuid"),
            options=start.get("options", {}),
            started_ms=start.get("ms", 0),
            tasks=tasks,
            removed=removed,
            demoted=demoted,
            throttle_active=throttle_active,
            throttled_topics=throttled,
            adaptive=adaptive,
        )
