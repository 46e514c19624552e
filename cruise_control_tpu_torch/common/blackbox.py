"""Black-box telemetry: a crash/hang-durable on-disk dispatch spool.

The JAX package's common/blackbox.py, standard library only.  A process
hung inside a device run and killed from outside leaves no trace in its
memory; this recorder writes a line-JSONL record of every recorded
dispatch to an on-disk spool BEFORE the call can block, so a hang, a
kill -9 or an OOM-kill leaves a trail ending at the exact in-flight
dispatch ("engine slice 7 in flight for 93 s under a BACKGROUND grant"),
not a bare return code.

Spool mechanics:

  * one append-only JSONL file per process (`spool-<pid>.jsonl` inside
    the configured directory);
  * every record is `write()`+`flush()`ed synchronously before the
    dispatch proceeds, so process death of any flavor cannot lose it;
    fsync is batched (`fsync_batch` records);
  * a fixed-size ring: past `max_records` the active file rotates to
    `<name>.1` (one previous generation kept), so the spool runs forever
    in bounded space;
  * readers (`read_spool`) tolerate a torn final line.

Record grammar, one JSON object per line:

    {"t": <kind>, "ph": "B"|"E"|"I", "seq": n, "ms": wall_ms,
     "mono": monotonic_s, "pid": pid, "thread": name, ...context}

`ph` is the phase: "B"egin before a dispatch blocks, "E"nd after it
returns (ok/error verdict), "I"nstant for point events.  A "B" with no
matching "E" is an in-flight dispatch; `in_flight_from_records` pairs
them up.

Recording sites in the port (`blackbox_context` threads cross-layer
context, such as the work class and queue wait, down to the leaf
records):

  * analyzer/engine.py `_run_segmented`: kind "engine-slice", one Begin
    per slice launch with the slice index and round range, ended after
    the slice's blocking sync, so a hung segmented anneal names its
    slice;
  * fleet/scheduler.py grants: kind "sched-grant" instants with the work
    class, queue wait and deadline verdict.

Disabled until `configure(path)`: the disabled path is one predicate
check per dispatch and writes nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time

#: how many trailing records a diagnostic embed keeps (the dryrun
#: timeout verdict, /trace?blackbox=true) — enough to see the approach
#: to the hang, small enough to ride a JSON record
DEFAULT_TAIL_RECORDS = 40


# ----------------------------------------------------------------------
# cross-layer dispatch context
# ----------------------------------------------------------------------

_CONTEXT: contextvars.ContextVar = contextvars.ContextVar(
    "blackbox_context", default=None
)


@contextlib.contextmanager
def blackbox_context(**fields):
    """Merge `fields` into every record the enclosed code emits.

    The optimizer stamps bucket/config-fingerprint/parallel-mode here,
    the device scheduler stamps work class + queue wait — so the leaf
    "engine-slice"/"device-op" records carry the whole story without any
    layer knowing the others.  A contextvar, so it survives the
    DeviceSupervisor's copied-context worker hop exactly like the
    segmented-execution seam."""
    cur = _CONTEXT.get() or {}
    token = _CONTEXT.set({**cur, **fields})
    try:
        yield
    finally:
        _CONTEXT.reset(token)


def current_context() -> dict:
    return dict(_CONTEXT.get() or {})


# ----------------------------------------------------------------------
# recorder
# ----------------------------------------------------------------------


class BlackBoxRecorder:
    """Crash-durable dispatch recorder over one JSONL ring spool.

    Thread-safe; `enabled` is False until `configure(path)` — every
    recording site guards on it, so an unconfigured recorder costs one
    attribute read per dispatch and writes nothing (the pinned disabled
    path)."""

    def __init__(self, *, clock=time.monotonic, wall=time.time):
        self._lock = threading.Lock()
        self._clock = clock
        self._wall = wall
        self._f = None
        self.path: str | None = None
        self.enabled = False
        self.max_records = 2048
        self.fsync_batch = 32
        self._seq = 0
        self._written = 0
        self._active_records = 0
        self._since_fsync = 0
        self.write_errors = 0
        #: in-process view of open dispatches: seq -> begin record
        self._open: dict[int, dict] = {}

    # -- lifecycle ------------------------------------------------------

    def configure(
        self,
        path: str | None,
        *,
        max_records: int = 2048,
        fsync_batch: int = 32,
    ) -> None:
        """Point the recorder at a spool file (None disables + closes).

        Idempotent on the same path — N fleet facades over one core all
        configure the same process-wide recorder.  An unwritable spool
        location (read-only mount, permission denial) leaves the
        recorder DISABLED with a warning: default-on telemetry must
        never prevent the service it observes from booting."""
        with self._lock:
            if path == self.path and (self._f is not None or path is None):
                self.max_records = max_records
                self.fsync_batch = fsync_batch
                return
            self._close_locked()
            self.path = path
            self.enabled = path is not None
            self.max_records = max_records
            self.fsync_batch = fsync_batch
            self._active_records = 0
            self._since_fsync = 0
            self._open.clear()
            if path is not None:
                try:
                    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                    # append: a restart shares the ring with its
                    # predecessor's records until rotation ages them out
                    self._f = open(path, "a", encoding="utf-8")
                    self._prune_dead_spools_locked(path)
                except OSError:
                    import logging

                    self.write_errors += 1
                    self.enabled = False
                    self.path = None
                    logging.getLogger(__name__).warning(
                        "black-box spool %s is unwritable; recorder "
                        "disabled", path, exc_info=True,
                    )

    @staticmethod
    def _prune_dead_spools_locked(path: str) -> None:
        """Delete sibling spool files of pids that no longer exist — the
        per-file ring bounds ONE process's disk, this bounds the
        directory across restarts ('bounded disk forever' must hold on a
        service restarted daily under a new pid).  Best-effort: a live
        post-mortem reader racing the prune just re-lists."""
        spool_dir = os.path.dirname(path) or "."
        try:
            names = os.listdir(spool_dir)
        except OSError:
            return
        for name in names:
            if not (name.startswith("spool-") and ".jsonl" in name):
                continue
            full = os.path.join(spool_dir, name)
            if full == path or full == path + ".1":
                continue
            try:
                pid = int(name[len("spool-"):].split(".jsonl")[0])
            except ValueError:
                continue
            try:
                os.kill(pid, 0)  # liveness probe, signal 0 sends nothing
            except ProcessLookupError:
                try:
                    os.unlink(full)
                except OSError:
                    pass
            except OSError:
                pass  # e.g. EPERM: pid exists under another uid — keep

    def close(self) -> None:
        with self._lock:
            self._close_locked()
            self.enabled = False
            self.path = None

    def _close_locked(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    # -- writing --------------------------------------------------------

    def _emit_locked(self, rec: dict, *, durable: bool = False) -> None:
        f = self._f
        if f is None:
            return
        try:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            # flush ALWAYS: the bytes must reach the kernel before the
            # dispatch can block — surviving process death is the whole
            # point.  fsync (power-loss durability) is batched.
            f.flush()
            self._written += 1
            self._active_records += 1
            self._since_fsync += 1
            if durable or self._since_fsync >= self.fsync_batch:
                os.fsync(f.fileno())
                self._since_fsync = 0
            if self._active_records >= self.max_records:
                self._rotate_locked()
        except (OSError, ValueError):
            # a full/yanked disk must degrade the telemetry, never the
            # dispatch it observes
            self.write_errors += 1

    def _rotate_locked(self) -> None:
        self._close_locked()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            self.write_errors += 1
        try:
            self._f = open(self.path, "w", encoding="utf-8")
        except OSError:
            self.write_errors += 1
        self._active_records = 0
        # re-emit still-OPEN Begin records into the new generation: a
        # long-hung dispatch must survive any number of rotations driven
        # by healthy traffic, or the post-mortem would be empty for
        # precisely the long-hang case the spool exists for (readers
        # dedup by (pid, seq), so the copy is harmless once the original
        # generation ages out)
        if self._f is not None and self._open:
            try:
                for rec in self._open.values():
                    self._f.write(
                        json.dumps(rec, separators=(",", ":")) + "\n"
                    )
                    self._active_records += 1
                    self._written += 1
                self._f.flush()
            except (OSError, ValueError):
                self.write_errors += 1

    def _base(self, kind: str, ph: str, seq: int) -> dict:
        return {
            "t": kind,
            "ph": ph,
            "seq": seq,
            "ms": int(self._wall() * 1000),
            "mono": round(self._clock(), 6),
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
        }

    def begin(self, kind: str, **fields) -> int:
        """Write the Begin record of one dispatch — BEFORE it can block —
        and return its seq for the matching `end`.  0 when disabled."""
        if not self.enabled:
            return 0
        ctx = _CONTEXT.get()
        with self._lock:
            self._seq += 1
            seq = self._seq
            rec = self._base(kind, "B", seq)
            if ctx:
                rec.update(ctx)
            rec.update(fields)
            self._emit_locked(rec)
            self._open[seq] = rec
        return seq

    def end(self, seq: int, *, ok: bool = True, **fields) -> None:
        if not self.enabled or seq == 0:
            return
        with self._lock:
            opened = self._open.pop(seq, None)
            rec = self._base(opened["t"] if opened else "?", "E", seq)
            rec["ok"] = bool(ok)
            if opened is not None:
                rec["wall_s"] = round(self._clock() - opened["mono"], 6)
            rec.update(fields)
            self._emit_locked(rec, durable=not ok)

    def event(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        ctx = _CONTEXT.get()
        with self._lock:
            self._seq += 1
            rec = self._base(kind, "I", self._seq)
            if ctx:
                rec.update(ctx)
            rec.update(fields)
            self._emit_locked(rec)

    @contextlib.contextmanager
    def record(self, kind: str, **fields):
        """begin/end pair around one dispatch; an exception lands in the
        End record (ok=False) and propagates — only a dispatch that never
        returns (hang, process death) leaves the Begin in flight."""
        seq = self.begin(kind, **fields)
        try:
            yield seq
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            self.end(seq, ok=False, error=repr(e))
            raise
        else:
            self.end(seq)

    # -- reading --------------------------------------------------------

    def in_flight(self) -> list[dict]:
        """Open dispatches of THIS process, oldest first, with live age."""
        with self._lock:
            open_recs = [dict(r) for r in self._open.values()]
            now = self._clock()
        for r in open_recs:
            r["in_flight_s"] = round(now - r["mono"], 3)
        return sorted(open_recs, key=lambda r: r["seq"])

    def tail(self, n: int = DEFAULT_TAIL_RECORDS) -> list[dict]:
        """Last n records re-read from disk (both ring generations)."""
        if self.path is None:
            return []
        return read_spool(self.path, last_n=n)

    def state_json(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "path": self.path,
                "recordsWritten": self._written,
                "activeRecords": self._active_records,
                "maxRecords": self.max_records,
                "writeErrors": self.write_errors,
                "openDispatches": len(self._open),
            }


#: process-wide recorder every recording site consults; disabled (one
#: predicate per dispatch, zero writes) until `configure`
RECORDER = BlackBoxRecorder()


# ----------------------------------------------------------------------
# cross-process reading (post-mortem / parent-of-child)
# ----------------------------------------------------------------------


def _read_file(path: str) -> list[dict]:
    records: list[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    # torn tail: the writer died mid-line — everything
                    # before it is trusted, nothing after it exists
                    break
    except OSError:
        return records
    return records


def read_spool(path: str, *, last_n: int | None = None) -> list[dict]:
    """Parse a spool file — or every `spool-*.jsonl` under a directory —
    oldest record first, tolerating a torn final line.  For a file, the
    previous ring generation (`<path>.1`) is read first so the tail spans
    a rotation."""
    records: list[dict] = []
    if os.path.isdir(path):
        names = sorted(
            n for n in os.listdir(path)
            if n.startswith("spool-") and ".jsonl" in n
        )
        # read .1 generations before their active twin
        for name in sorted(names, key=lambda n: (n.replace(".1", ""), n.endswith(".1") is False)):
            records.extend(_read_file(os.path.join(path, name)))
        records.sort(key=lambda r: (r.get("pid", 0), r.get("seq", 0)))
    else:
        if os.path.exists(path + ".1"):
            records.extend(_read_file(path + ".1"))
        records.extend(_read_file(path))
    if last_n is not None and len(records) > last_n:
        records = records[-last_n:]
    return records


def in_flight_from_records(
    records: list[dict], *, now_ms: int | None = None
) -> list[dict]:
    """Begin records with no matching End — the dispatches a (possibly
    dead) process was inside when the spool went quiet.  Pairs by
    (pid, seq); `in_flight_s` is measured against the spool's LAST
    record on the writer's own monotonic clock, and `wall_age_s`
    (when `now_ms` is given) against the READER's wall clock — the
    dead child's monotonic clock died with it, but parent and child
    share the machine's wall time."""
    opens: dict[tuple, dict] = {}
    last_mono_by_pid: dict[int, float] = {}
    for r in records:
        key = (r.get("pid"), r.get("seq"))
        ph = r.get("ph")
        if ph == "B":
            opens[key] = r
        elif ph == "E":
            opens.pop(key, None)
        if "mono" in r:
            pid = r.get("pid")
            last_mono_by_pid[pid] = max(
                last_mono_by_pid.get(pid, 0.0), r["mono"]
            )
    out = []
    for r in opens.values():
        r = dict(r)
        last = last_mono_by_pid.get(r.get("pid"), r.get("mono", 0.0))
        r["in_flight_s"] = round(max(0.0, last - r.get("mono", last)), 3)
        if now_ms is not None and "ms" in r:
            r["wall_age_s"] = round(max(0.0, (now_ms - r["ms"]) / 1000.0), 3)
        out.append(r)
    return sorted(out, key=lambda r: (r.get("pid", 0), r.get("seq", 0)))


def spool_verdict(path: str, *, last_n: int = DEFAULT_TAIL_RECORDS) -> dict:
    """The structured post-mortem block diagnostic surfaces embed: the
    spool tail + the dispatches still in flight when it ends.  Mesh
    dispatches record their width (`mesh_shape`/`n_devices`, stamped by
    the mesh engine's `_blackbox_fields` through the device_op seam), and
    the verdict surfaces the widest one in flight as `mesh_in_flight` so
    a timeout kill names the mesh width, not just the op.  Never raises —
    an unreadable/absent spool is an empty verdict, because this runs
    inside failure paths."""
    try:
        records = read_spool(path, last_n=None)
    except Exception:  # noqa: BLE001 — diagnosis must not mask the failure
        records = []
    in_flight = in_flight_from_records(
        records, now_ms=int(time.time() * 1000)
    )
    verdict = {"records": records[-last_n:], "in_flight": in_flight}
    mesh = [r for r in in_flight if r.get("n_devices") or r.get("mesh_shape")]
    if mesh:
        widest = max(mesh, key=lambda r: int(r.get("n_devices") or 0))
        verdict["mesh_in_flight"] = {
            k: widest.get(k)
            for k in ("kind", "op", "mesh_shape", "n_devices", "in_flight_s")
            if widest.get(k) is not None
        }
    return verdict
