"""What the process compiled and captured since it started, per bucket.

The JAX package's common/compilation_cache.py points JAX at a persistent
XLA compilation cache and reports, after boot, how many executables were
reloaded from disk and how many compiled fresh.  The port compiles no
program at run time: its only on-disk artifact is the kernel build cache
(kernels/_build.py `BUILD_DIR`), CUDA libraries keyed by a hash of their
sources and flags, which a restart reuses as they are.  What a process
pays per shape bucket instead is the capture of an engine's CUDA graphs,
which cannot be stored on disk.  This module counts those captures per
bucket and by where they ran (`record_engine_capture`: "request" on a
run's path, "prewarm" on the warm pool), and `boot_report` gives them
beside the kernel libraries reused and built.  A segmented run's slice
graph is instantiated over an engine's captured graphs and captures
nothing; its instantiations are counted apart (`record_slice_graph`), so
the capture counts of a bucket stay what its captures were.
"""

from __future__ import annotations

import os
import threading

from cruise_control_tpu_torch.kernels import _build

_enabled = False
#: library files in the build directory when the cache was enabled
_boot_entries: set[str] | None = None
_cache_dir: str | None = None

#: per-bucket engine captures since the process started: bucket key ->
#: {"request": captures on a run's path, "prewarm": on the warm pool}
_capture_lock = threading.Lock()
_engine_captures: dict[str, dict[str, int]] = {}
#: per-bucket slice-graph instantiations since the process started
_slice_graphs: dict[str, int] = {}

SOURCES = ("request", "prewarm")


def record_engine_capture(bucket: str, *, source: str) -> None:
    """Count one capture of an engine's graphs for `bucket`; `source` is
    "request" (a run waited for it) or "prewarm" (the warm pool's)."""
    if source not in SOURCES:
        raise ValueError(f"capture source must be one of {SOURCES}, got {source!r}")
    with _capture_lock:
        row = _engine_captures.setdefault(bucket, {k: 0 for k in SOURCES})
        row[source] += 1


def record_slice_graph(bucket: str) -> None:
    """Count one instantiation of a segmented run's slice graph for
    `bucket` (analyzer/engine.py `_slice_graph`): no capture."""
    with _capture_lock:
        _slice_graphs[bucket] = _slice_graphs.get(bucket, 0) + 1


def engine_capture_counts() -> dict[str, dict[str, int]]:
    with _capture_lock:
        return {k: dict(v) for k, v in _engine_captures.items()}


def slice_graph_counts() -> dict[str, int]:
    with _capture_lock:
        return dict(_slice_graphs)


def reset_engine_capture_counts() -> None:
    """Test seam: the accounting is per process otherwise."""
    with _capture_lock:
        _engine_captures.clear()
        _slice_graphs.clear()


def _scan(cache_dir: str) -> tuple[set[str], int]:
    """(file names, total bytes) in the directory now; tolerant of files
    that come and go while it looks."""
    entries: set[str] = set()
    total = 0
    try:
        for root, _dirs, files in os.walk(cache_dir):
            for fn in files:
                path = os.path.join(root, fn)
                entries.add(os.path.relpath(path, cache_dir))
                try:
                    total += os.path.getsize(path)
                except OSError:
                    pass
    except OSError:
        pass
    return entries, total


def enable_persistent_cache(cache_dir: str | None = None) -> str | None:
    """Take the boot inventory of the kernel build directory (`cache_dir`
    when given, else kernels/_build.py's BUILD_DIR), which `boot_report`
    later diffs against.  Idempotent; returns the directory.  There is no
    compiled-program cache to switch on beyond that directory: the kernel
    libraries already persist there, keyed by their sources, and CUDA
    graphs are captured in each process."""
    global _enabled, _boot_entries, _cache_dir
    if _enabled:
        return _cache_dir
    cache_dir = os.path.expanduser(cache_dir) if cache_dir else str(_build.BUILD_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    _boot_entries, _ = _scan(cache_dir)
    _cache_dir = cache_dir
    _enabled = True
    return cache_dir


def boot_report() -> dict | None:
    """The build directory since boot (files at enable time, files now,
    bytes), the kernel libraries this process reused and built, and the
    engine captures per bucket and source, and the slice graphs
    instantiated per bucket.  None before
    `enable_persistent_cache`."""
    if not _enabled or _cache_dir is None or _boot_entries is None:
        return None
    now, total = _scan(_cache_dir)
    return {
        "dir": _cache_dir,
        "entriesAtBoot": len(_boot_entries),
        "newEntries": len(now - _boot_entries),
        "entries": len(now),
        "bytes": total,
        "librariesReused": sorted(_build.REUSED),
        "librariesBuilt": sorted(_build.BUILT),
        "engineCaptures": engine_capture_counts(),
        "sliceGraphs": slice_graph_counts(),
    }
