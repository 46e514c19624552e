"""Durable decision ledger — the proposal→outcome→calibration corpus.

ROADMAP item 3's learned-policy flywheel needs labeled data: (decision
features, search trajectory, realized outcome) triples.  Today nothing
durable records WHY the engine chose a plan or whether the cluster
actually improved after executing it — spans evict from ring buffers,
`OptimizerResult.history` dies with the process, and the executor
journal archives record task transitions, not goal quality.  The ledger
is that corpus as a first-class observability layer, and — as a side
effect — the operator's "explain this rebalance / did it help" surface
(`GET /explain`, `cccli explain`).

Storage: an append-only JSONL file (crash semantics shared with
executor/journal.py — torn tails are repaired before appending and end
replay; every append is flushed+fsync'd, which is cheap at
decision rate).  Fleet deployments namespace one ledger per cluster
under the journal dir.  Record stream:

  {"t": "decision", "id", "ms", "trace_id", "source", ...}   one per
      published proposal: model generation, bucket + config fingerprint,
      work class, per-goal pre/post scores, predicted post-move
      per-broker load summary, per-move features, convergence summary
  {"t": "outcome", "id", "ms", ...}       joined at execution completion
      (duration, completed/aborted/dead, fenced aborts, reaper actions)
  {"t": "calibration", "id", "ms", ...}   predicted vs measured per-goal
      scores and per-broker load prediction error, after the executed
      moves land and the next complete metric window rolls

Rotation/retention (like the executor journal): once the live file holds
`rotate_records` decisions it rotates into a terminal archive
(`<path>.<ms>.<id>.done`) — but NEVER while any decision in it still
awaits its outcome (an execution in flight); `prune_archives`
(config `analyzer.ledger.retention.{count,hours}`) deletes archives
beyond the bounds and skips any archive holding a pending-outcome
decision.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid as uuid_mod

import numpy as np
import torch

log = logging.getLogger(__name__)

#: live-file decision count past which record_decision rotates the file
#: into a terminal archive (pending-outcome decisions block rotation)
DEFAULT_ROTATE_RECORDS = 256


class DecisionLedger:
    """Append-only, crash-tolerant JSONL store of decision → outcome →
    calibration records.  Thread-safe: the proposal path, the executor's
    finish hook, and the calibration loop append concurrently."""

    def __init__(self, path: str, *, retention_count: int | None = None,
                 retention_hours: float | None = None,
                 rotate_records: int = DEFAULT_ROTATE_RECORDS,
                 sensors=None, clock=None):
        self.path = os.path.abspath(os.path.expanduser(path))
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.retention_count = retention_count
        self.retention_hours = retention_hours
        self.rotate_records = max(1, int(rotate_records))
        self.sensors = sensors
        self._clock = clock or (lambda: int(time.time() * 1000))
        self._lock = threading.Lock()
        self._file = None
        #: decision ids whose execution is in flight (begin_outcome called,
        #: record_outcome not yet) — rotation and pruning must never strand
        #: or destroy the half-written episode
        self._pending: set[str] = set()
        #: decision ids present in the LIVE file (rebuilt from replay on
        #: first open; bounds the rotation decision)
        self._live_ids: set[str] = set()
        self._scanned = False
        self.records_written = 0
        self.write_errors = 0

    # ------------------------------------------------------------- write

    def _ensure_open_locked(self):
        if self._file is None:
            self._repair_torn_tail()
            if not self._scanned:
                # rebuild the live-file decision id set once per process —
                # rotation bookkeeping must survive restarts
                self._live_ids = {
                    r["id"] for r in self._replay_file(self.path)
                    if r.get("t") == "decision" and r.get("id")
                }
                self._scanned = True
            self._file = open(self.path, "a", encoding="utf-8")  # noqa: SIM115

    def _repair_torn_tail(self):
        """Truncate back to the last fully-valid record before appending:
        gluing a new record onto a crash-torn partial line would poison
        every record after it (executor/journal.py semantics)."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except OSError:
            return
        good = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break
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

    def _append_locked(self, record: dict) -> None:
        self._ensure_open_locked()
        self._file.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._file.flush()
        os.fsync(self._file.fileno())
        self.records_written += 1

    def _append(self, record: dict, counter: str) -> bool:
        try:
            with self._lock:
                self._append_locked(record)
        except OSError:
            self.write_errors += 1
            if self.sensors is not None:
                self.sensors.counter("analyzer.ledger.write-errors").inc()
            log.warning("decision-ledger append failed", exc_info=True)
            return False
        if self.sensors is not None:
            self.sensors.counter(counter).inc()
        return True

    def record_decision(self, decision: dict) -> str:
        """Append one `decision` record; returns its ledger id (minted
        here unless the caller supplied one).  May rotate a full live
        file into a terminal archive first — never while a decision in
        it still awaits its outcome."""
        did = decision.get("id") or uuid_mod.uuid4().hex[:16]
        self._maybe_rotate()
        rec = dict(decision, t="decision", id=did)
        rec.setdefault("ms", self._clock())
        if self._append(rec, "analyzer.ledger.decisions"):
            with self._lock:
                self._live_ids.add(did)
        return did

    def begin_outcome(self, decision_id: str) -> None:
        """Mark a decision's execution as in flight: until record_outcome
        lands, the file holding it will neither rotate nor be pruned."""
        with self._lock:
            self._pending.add(decision_id)

    def record_outcome(self, decision_id: str, outcome: dict) -> None:
        rec = dict(outcome, t="outcome", id=decision_id)
        rec.setdefault("ms", self._clock())
        self._append(rec, "analyzer.ledger.outcomes")
        with self._lock:
            self._pending.discard(decision_id)

    def record_calibration(self, decision_id: str, calibration: dict) -> None:
        rec = dict(calibration, t="calibration", id=decision_id)
        rec.setdefault("ms", self._clock())
        self._append(rec, "analyzer.ledger.calibrations")

    def pending_outcomes(self) -> set[str]:
        with self._lock:
            return set(self._pending)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # --------------------------------------------------- rotation/retention

    def _maybe_rotate(self) -> None:
        """Rotate the live file into a terminal archive once it holds
        `rotate_records` decisions — unless any of them still awaits its
        outcome (the episode must stay joinable in one file)."""
        with self._lock:
            if len(self._live_ids) < self.rotate_records:
                return
            if self._pending & self._live_ids:
                return  # an execution is in flight: never strand its join
            if self._file is not None:
                self._file.close()
                self._file = None
            archive = (
                f"{self.path}.{self._clock()}.{uuid_mod.uuid4().hex[:8]}.done"
            )
            try:
                os.replace(self.path, archive)
            except OSError:
                return  # rotation is best-effort; appends continue
            self._live_ids = set()
        try:
            self.prune_archives()
        except OSError:
            pass

    def _archives(self) -> list[tuple[float, str]]:
        d = os.path.dirname(self.path)
        base = os.path.basename(self.path) + "."
        out: list[tuple[float, str]] = []
        try:
            names = os.listdir(d)
        except OSError:
            return out
        for fn in names:
            if fn.startswith(base) and fn.endswith(".done"):
                p = os.path.join(d, fn)
                try:
                    out.append((os.path.getmtime(p), p))
                except OSError:
                    continue
        out.sort(reverse=True)  # newest first
        return out

    def prune_archives(self, *, now_ms: int | None = None) -> int:
        """Delete ledger archives beyond
        `analyzer.ledger.retention.{count,hours}`.  An archive holding a
        decision whose outcome is still pending is NEVER pruned — the
        in-flight episode's features must survive until its outcome (and
        calibration) can be joined."""
        if self.retention_count is None and self.retention_hours is None:
            return 0
        archives = self._archives()
        doomed: set[str] = set()
        if self.retention_count is not None:
            doomed.update(p for _m, p in archives[max(0, self.retention_count):])
        if self.retention_hours is not None:
            now_s = (now_ms / 1000.0) if now_ms is not None else time.time()
            cutoff = now_s - self.retention_hours * 3600.0
            doomed.update(p for m, p in archives if m < cutoff)
        pending = self.pending_outcomes()
        pruned = 0
        for p in doomed:
            if pending:
                ids = {
                    r.get("id") for r in self._replay_file(p)
                    if r.get("t") == "decision"
                }
                if ids & pending:
                    continue  # a pending episode lives here: sacrosanct
            try:
                os.remove(p)
                pruned += 1
            except OSError:
                pass
        return pruned

    # -------------------------------------------------------------- read

    @staticmethod
    def _replay_file(path: str) -> list[dict]:
        """Decode one ledger file, tolerating crash truncation: a torn
        final line (or garbage after it) ends the replay; everything
        before it is trusted."""
        records: list[dict] = []
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break
                    if not isinstance(rec, dict) or "t" not in rec:
                        break
                    records.append(rec)
        except OSError:
            return []
        return records

    def replay(self) -> list[dict]:
        """All records, oldest archive first then the live file."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
        out: list[dict] = []
        for _m, p in reversed(self._archives()):
            out.extend(self._replay_file(p))
        out.extend(self._replay_file(self.path))
        return out

    def _join_newest_first(self, stop):
        """Walk the ledger newest file first (live file, then archives
        newest→oldest), yielding joined episodes in newest-decision-first
        order; `stop(episodes)` short-circuits the walk so a /ledger page
        or an /explain lookup never parses 32 archives it does not need.
        Joins are safe under early termination: outcome/calibration
        records can only live in the SAME file as their decision or a
        NEWER one (append-only time order), so by the time a decision is
        seen its joins have already been collected."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
        joins: dict[str, dict] = {}
        episodes: list[dict] = []
        files = [self.path] + [p for _m, p in self._archives()]
        for path in files:
            # records within a file are oldest-first; walking them in
            # REVERSE means every outcome/calibration is collected before
            # its decision is reached (joins never trail their decision in
            # a newer position), and decisions emerge newest-first
            for rec in reversed(self._replay_file(path)):
                did = rec.get("id")
                if not did:
                    continue
                t = rec.get("t")
                if t == "decision":
                    entry = {"decision": rec, "outcome": None,
                             "calibration": None}
                    entry.update(joins.pop(did, {}))
                    episodes.append(entry)
                elif t in ("outcome", "calibration"):
                    joins.setdefault(did, {})[t] = rec
            if stop(episodes):
                break
        return episodes

    def entries(self, *, limit: int = 50) -> list[dict]:
        """Joined episodes, newest decision first:
        {"decision": ..., "outcome": ...|None, "calibration": ...|None}."""
        limit = max(0, int(limit))
        episodes = self._join_newest_first(lambda eps: len(eps) >= limit)
        return episodes[:limit]

    def find(self, *, decision_id: str | None = None,
             trace_id: str | None = None) -> dict | None:
        """The joined episode matching a ledger decision id or a
        flight-recorder trace id; None when nothing matches."""

        def match(entry) -> bool:
            d = entry["decision"]
            if decision_id is not None and d.get("id") == decision_id:
                return True
            return bool(trace_id) and d.get("trace_id") == trace_id

        episodes = self._join_newest_first(
            lambda eps: any(match(e) for e in eps)
        )
        for entry in episodes:
            if match(entry):
                return entry
        return None

    def state_json(self) -> dict:
        with self._lock:
            pending = len(self._pending)
            live = len(self._live_ids)
        return {
            "path": self.path,
            "recordsWritten": self.records_written,
            "writeErrors": self.write_errors,
            "liveDecisions": live,
            "pendingOutcomes": pending,
            "archives": len(self._archives()),
        }


# ----------------------------------------------------------------------
# decision-record construction (shared by the facade and the bench)
# ----------------------------------------------------------------------

#: device-to-host transfers the record functions made (one a record built
#: from a result on the card, none from a result on the CPU)
TRANSFERS = 0

_STATS_ROWS = ("avg", "max", "min", "std")


def host_arrays(named: dict) -> dict:
    """numpy copies of `named`'s arrays and tensors, under the same keys.
    Tensors off the CPU come to the host in one transfer: flattened into
    one f64 buffer on their device (f32 and int32 values are exact in
    f64), one blocking copy into pinned memory, then back to each one's
    dtype and shape.  Host arrays and CPU tensors cost no transfer."""
    global TRANSFERS
    out, dev = {}, {}
    for k, v in named.items():
        if isinstance(v, torch.Tensor):
            if v.device.type == "cpu":
                out[k] = v.numpy()
            else:
                dev[k] = v
        else:
            out[k] = np.asarray(v)
    if dev:
        flat = torch.cat([v.reshape(-1).to(torch.float64) for v in dev.values()])
        host = torch.empty(flat.shape, dtype=torch.float64, pin_memory=True)
        host.copy_(flat)
        TRANSFERS += 1
        at, h = 0, host.numpy()
        for k, v in dev.items():
            n = v.numel()
            dtype = torch.empty((), dtype=v.dtype).numpy().dtype
            out[k] = h[at: at + n].astype(dtype).reshape(tuple(v.shape))
            at += n
    return out


def _f(x, nd: int = 6):
    return round(float(x), nd)


def _stats_named(stats) -> dict:
    return {f"stats.{f}": getattr(stats, f) for f in _STATS_ROWS}


def load_summary(stats, *, host: dict | None = None) -> dict:
    """Compact per-broker load summary from a models/stats.ClusterStats:
    per-resource mean/max/min/std utilization over alive brokers — the
    decision record's PREDICTED post-move load, and the calibration
    record's measured twin.  Stats on the card come in one transfer;
    `host`, the arrays build_decision_record gathered, saves it."""
    from cruise_control_tpu_torch.common.resources import Resource

    if host is None:
        host = host_arrays(_stats_named(stats))
    names = [Resource(i).name for i in range(4)]
    out: dict = {}
    for field in _STATS_ROWS:
        row = np.asarray(host[f"stats.{field}"], np.float64)
        out[field] = {n: _f(v) for n, v in zip(names, row)}
    return out


def load_summary_error(predicted: dict, measured: dict) -> dict:
    """Per-broker load prediction error between two load_summary dicts:
    absolute error per (statistic, resource) + the headline max absolute
    error over the mean-utilization row (the calibration gauge)."""
    out: dict = {}
    worst = 0.0
    for field in ("avg", "max", "std"):
        p, m = predicted.get(field), measured.get(field)
        if not isinstance(p, dict) or not isinstance(m, dict):
            continue
        row = {
            k: _f(abs(float(m[k]) - float(p[k])))
            for k in p
            if k in m
        }
        out[field] = row
        if field == "avg" and row:
            worst = max(row.values())
    out["maxAbsAvgError"] = _f(worst)
    return out


def _move_rows(proposals, top: int):
    """The `top` highest-data proposal rows without materializing the
    whole set (ProposalSet stays columnar)."""
    n = len(proposals)
    if n == 0:
        return []
    if hasattr(proposals, "top_by_data"):
        return proposals.top_by_data(min(top, n))
    rows = sorted(
        list(proposals), key=lambda p: -p.inter_broker_data_to_move
    )
    return rows[: min(top, n)]


def _move_named(result, prior_table) -> dict:
    named = {"racks": result.state_before.broker_rack}
    w = None if prior_table is None else getattr(prior_table, "weights", None)
    if w is not None:
        named["prior"] = w
    return named


def move_features(result, *, prior_table=None, top: int = 20,
                  host: dict | None = None) -> list[dict]:
    """Per-move feature rows of the decision record: topic, source/dest
    brokers, data to move, leadership change, rack change, and the
    learned prior's contribution to the chosen destinations — the
    featurization ROADMAP item 3's trained policy consumes.  Bounded to
    the `top` moves by data so a 100k-move plan stays a record, not a
    dump.  The broker racks (and a prior's weights) on the card come in
    one transfer; `host`, the arrays build_decision_record gathered, saves
    it."""
    if host is None:
        host = host_arrays(_move_named(result, prior_table))
    racks = host["racks"]
    weights = host["prior"].astype(np.float64) if "prior" in host else None
    out = []
    for p in _move_rows(result.proposals, top):
        old, new = set(p.old_replicas), set(p.new_replicas)
        added = sorted(new - old)
        removed = sorted(old - new)
        row = {
            "partition": int(p.partition),
            "topic": int(p.topic),
            "sources": [int(b) for b in removed],
            "destinations": [int(b) for b in added],
            "dataMB": _f(p.inter_broker_data_to_move, 3),
            "leadershipChange": bool(p.old_leader != p.new_leader),
            "rackChange": bool(
                {int(racks[b]) for b in added if b < racks.size}
                != {int(racks[b]) for b in removed if b < racks.size}
            ),
        }
        if weights is not None and added:
            t = int(p.topic)
            if 0 <= t < weights.shape[0]:
                row["priorWeight"] = _f(
                    sum(
                        float(weights[t, b])
                        for b in added
                        if 0 <= b < weights.shape[1]
                    )
                )
        out.append(row)
    return out


def build_decision_record(
    result,
    *,
    source: str,
    trace_id: str = "",
    cluster_id: str = "",
    generation=None,
    work_class: str = "",
    config_fingerprint: str = "",
    prior_table=None,
    calibration_eligible: bool = True,
    top_moves: int = 20,
) -> dict:
    """One `decision` record from an OptimizerResult — everything the
    flywheel (and /explain) needs to know about WHY this plan was chosen:
    identity (trace id, generation, bucket, config fingerprint, work
    class), per-goal pre/post scores, the predicted post-move per-broker
    load summary, per-move features, and the engine's convergence
    summary (OptimizerConfig.diagnostics)."""
    timing = next((h for h in result.history if h.get("timing")), {})
    # what the record reads of a result on the card, in one transfer
    host = host_arrays({
        "violations_before": result.violations_before,
        "violations_after": result.violations_after,
        **_stats_named(result.stats_after),
        **_move_named(result, prior_table),
    })
    gen = None
    if generation is not None:
        gen = {
            "metadata": int(getattr(generation, "metadata_generation", -1)),
            "load": int(getattr(generation, "load_generation", -1)),
        }
    rec = {
        "trace_id": trace_id,
        "cluster": cluster_id,
        "source": source,
        "workClass": work_class,
        "generation": gen,
        "bucket": timing.get("bucket"),
        "configFingerprint": config_fingerprint,
        "degraded": bool(result.degraded),
        "goals": {
            "names": list(result.goal_names),
            "violationsBefore": [
                _f(v) for v in host["violations_before"]
            ],
            "violationsAfter": [
                _f(v) for v in host["violations_after"]
            ],
            "objectiveBefore": _f(result.objective_before),
            "objectiveAfter": _f(result.objective_after),
            "balancednessBefore": _f(result.balancedness_before, 3),
            "balancednessAfter": _f(result.balancedness_after, 3),
        },
        "predictedLoad": load_summary(result.stats_after, host=host),
        "numReplicaMovements": result.num_inter_broker_moves,
        "numLeaderMovements": result.num_leadership_moves,
        "dataToMoveMB": _f(result.data_to_move, 3),
        "moves": move_features(result, prior_table=prior_table, top=top_moves, host=host),
        "convergence": timing.get("convergence"),
        "wallSeconds": _f(result.wall_seconds),
        "calibrationEligible": bool(calibration_eligible),
    }
    return rec
