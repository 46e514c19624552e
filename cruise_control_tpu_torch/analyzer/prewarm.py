"""Boot prewarm manifest: the active shape buckets, recorded to disk.

The JAX package's analyzer/prewarm.py, manifest half.  On every engine
build or rebind the long-lived optimizer records its active working set
(`PrewarmStore.note`): the bucketed shape with its max_rf (the one axis of
the engine's buffers the shape alone does not fix), the full
OptimizerConfig, the parallel mode and an environment fingerprint (torch
and CUDA versions, the goal chain, the constraint and a digest of the
port's engine, model and kernel sources).  Entries are merged on write
(read-modify-write under a file lock, deduplicated by bucket, config and
fingerprint), so several optimizers or processes over one directory union
their working sets.  A restarted process claims the manifest's entries
(`claim_boot_entries`) and hands each to `GoalOptimizer.prewarm`, so the
active buckets' graphs are captured on the warm pool before the first
request needs them.

The JAX package's second half, AOT-serialized programs (`_AotHandle`,
`aot_handle`), has no counterpart: a CUDA graph holds device addresses of
one process and cannot be serialized.  The port's on-disk artifact is the
kernel build cache, whose libraries are keyed by a hash of their sources
and flags (kernels/_build.py) and are reused across restarts; a prewarm
captures its graphs anew in each process and loads nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
import threading
import time

log = logging.getLogger(__name__)

#: manifest layout version; a bump invalidates old files
VERSION = 1

#: throttle for recency-only manifest rewrites (a rebind storm must not
#: turn into a write storm; new entries always write immediately)
_TOUCH_WRITE_INTERVAL_S = 60.0

_BUCKET_FIELDS = ("R", "B", "P", "topics", "racks", "hosts", "disks", "max_rf")


def bucket_key(shape) -> str:
    """A bucket's name: the same format the optimizer's capture
    attribution and the capture accounting use, so their rows join."""
    return f"R{shape.R}.B{shape.B}.P{shape.P}.T{shape.num_topics}"


def _bucket_dict(shape, max_rf: int) -> dict:
    return {
        "R": int(shape.num_replicas),
        "B": int(shape.num_brokers),
        "P": int(shape.num_partitions),
        "topics": int(shape.num_topics),
        "racks": int(shape.num_racks),
        "hosts": int(shape.num_hosts),
        "disks": int(shape.max_disks_per_broker),
        "max_rf": int(max_rf),
    }


def _shape_from_dict(b: dict):
    from cruise_control_tpu_torch.models.state import ClusterShape

    return ClusterShape(
        num_replicas=int(b["R"]),
        num_brokers=int(b["B"]),
        num_partitions=int(b["P"]),
        num_topics=int(b["topics"]),
        num_racks=int(b["racks"]),
        num_hosts=int(b["hosts"]),
        max_disks_per_broker=int(b["disks"]),
    )


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


_source_digest_cache: str | None = None


def _source_digest() -> str:
    """Digest of the sources that define what an engine captures: the
    port's analyzer/, models/ and kernels/ (its Python and its CUDA
    sources, csrc/ included), by relative path and content, in a fixed
    order."""
    global _source_digest_cache
    if _source_digest_cache is not None:
        return _source_digest_cache
    h = hashlib.sha256()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for sub in ("analyzer", "models", "kernels"):
        root = os.path.join(pkg, sub)
        for dirpath, dirs, files in os.walk(root):
            dirs.sort()  # readdir order is the filesystem's
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for fn in sorted(files):
                if not fn.endswith((".py", ".cu", ".cuh")):
                    continue
                path = os.path.join(dirpath, fn)
                with open(path, "rb") as f:
                    h.update(os.path.relpath(path, pkg).encode() + b"\0")
                    h.update(f.read())
    _source_digest_cache = h.hexdigest()[:16]
    return _source_digest_cache


def environment_fingerprint(chain, constraint) -> str:
    """The identity of everything an engine's graphs depend on besides the
    OptimizerConfig (which each entry carries): the goal chain (names and
    weights), the constraint, torch's and CUDA's versions and the source
    digest.  A process under another chain, constraint, runtime or code
    skips the entries."""
    import torch

    names = ",".join(g.name for g in chain.goals)
    weights = ",".join(repr(float(w)) for w in chain.weights)
    return _sha(f"v{VERSION}|torch {torch.__version__}|cuda {torch.version.cuda}"
                f"|{_source_digest()}|{names}|{weights}|{constraint!r}")


def _config_dict(config) -> dict:
    return dataclasses.asdict(config)


def _config_from_dict(d: dict):
    """OptimizerConfig back from its JSON form; raises on unknown fields (a
    manifest written by a later version is skipped, not half-applied)."""
    from cruise_control_tpu_torch.analyzer.engine import OptimizerConfig

    return OptimizerConfig(**d)


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class PrewarmStore:
    """One durable manifest per deployment, shared by the optimizers that
    record into it (the JAX package's PrewarmStore without its AOT
    artifacts)."""

    def __init__(self, directory: str, *, chain, constraint, max_entries: int = 6):
        self.directory = os.path.expanduser(directory)
        self.env_fp = environment_fingerprint(chain, constraint)
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        #: in-memory view of our entries, key -> entry dict
        self._entries: dict[str, dict] = {}
        self._last_write = 0.0
        self._boot_claimed = False

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, "prewarm-manifest.json")

    @staticmethod
    def _entry_key(entry: dict) -> str:
        ident = json.dumps(
            [
                entry["env_fp"],
                [entry["bucket"][f] for f in _BUCKET_FIELDS],
                sorted(entry["config"].items()),
                entry["parallel_mode"],
            ],
            default=str,
        )
        return _sha(ident)

    def note(self, shape, max_rf: int, config, *, parallel_mode: str = "single") -> None:
        """Record one (bucket, config) as active; merge and persist.  New
        entries write through at once; recency-only touches at most once a
        minute.  A failed write is logged: the manifest is an
        optimization of the next boot, never of this run."""
        entry = {
            "env_fp": self.env_fp,
            "bucket": _bucket_dict(shape, max_rf),
            "config": _config_dict(config),
            "parallel_mode": str(parallel_mode),
            "last_used_ms": int(time.time() * 1000),
            "uses": 1,
        }
        key = self._entry_key(entry)
        with self._lock:
            known = key in self._entries
            if known:
                entry["uses"] = int(self._entries[key].get("uses", 0)) + 1
            self._entries[key] = entry
            now = time.monotonic()
            if known and now - self._last_write < _TOUCH_WRITE_INTERVAL_S:
                return
            self._last_write = now
            try:
                self._write_merged_locked()
            except OSError:
                log.warning("prewarm manifest write failed", exc_info=True)

    def _read_file(self) -> dict[str, dict]:
        try:
            with open(self.manifest_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict) or doc.get("version") != VERSION:
            return {}
        out = {}
        for e in doc.get("entries", ()):
            try:
                out[self._entry_key(e)] = e
            except (KeyError, TypeError, AttributeError):  # one bad row skips itself
                continue
        return out

    def _write_merged_locked(self) -> None:
        """Merge our entries over the file (another process may have written
        since) and write it atomically, the most recent max_entries first.
        The read-modify-write holds an OS file lock on a sibling .lock file,
        so two processes cannot drop each other's entries."""
        import fcntl

        os.makedirs(self.directory, exist_ok=True)
        with open(self.manifest_path + ".lock", "a") as lock_f:
            fcntl.flock(lock_f.fileno(), fcntl.LOCK_EX)
            merged = self._read_file()
            for k, e in self._entries.items():
                old = merged.get(k)
                if old is not None:
                    e = dict(e)
                    e["uses"] = max(int(e.get("uses", 1)), int(old.get("uses", 1)))
                    e["last_used_ms"] = max(int(e.get("last_used_ms", 0)),
                                            int(old.get("last_used_ms", 0)))
                merged[k] = e
            rows = sorted(merged.values(),
                          key=lambda e: -int(e.get("last_used_ms", 0)))[: self.max_entries]
            _atomic_write(self.manifest_path,
                          json.dumps({"version": VERSION, "entries": rows}, indent=1).encode())

    def claim_boot_entries(self) -> list[dict]:
        """The manifest's entries of this environment, most recent first
        (the active bucket leads), claimed at most once per store."""
        with self._lock:
            if self._boot_claimed:
                return []
            self._boot_claimed = True
        rows = [e for e in self._read_file().values() if e.get("env_fp") == self.env_fp]
        rows.sort(key=lambda e: -int(e.get("last_used_ms", 0)))
        return rows[: self.max_entries]

    @staticmethod
    def entry_engine_inputs(entry: dict):
        """(ClusterShape, max_rf, OptimizerConfig, parallel_mode) of a
        manifest row; raises on a malformed or foreign row (the caller
        skips it)."""
        return (
            _shape_from_dict(entry["bucket"]),
            int(entry["bucket"]["max_rf"]),
            _config_from_dict(entry["config"]),
            str(entry["parallel_mode"]),
        )

    def manifest_bucket_keys(self) -> list[str]:
        """bucket_key() of the file's entries of this environment."""
        return [bucket_key(_shape_from_dict(e["bucket"])) for e in self._read_file().values()
                if e.get("env_fp") == self.env_fp]

    def drain(self, timeout_s: float = 120.0) -> bool:
        """Nothing of the port's store runs in the background (it exports
        no artifact): True at once.  Kept for the JAX package's callers."""
        return True
