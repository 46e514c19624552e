"""Device profiling hooks: memory gauges and an opt-in profiler trace.

The JAX package's common/profiling.py on PyTorch's CUDA allocator:

  * `register_device_gauges(sensors)` publishes the caching allocator's
    bytes in use, the cards' memory and the allocator's live blocks (the
    JAX package's sensor names, summed over the visible cards), the bytes
    in use per card as a labelled collector, and a peak tracker per
    (bucket, card) that a caller feeds after its runs
    (`PeakLiveBytesTracker.record`).  `sensors` is any registry with
    `gauge(name, fn)` and `collector(name, fn)`; nothing here imports one.
  * `profiler_trace(dump_dir)` wraps a block in `torch.profiler` and writes
    a Chrome trace of it into `dump_dir`.

On a process without a CUDA device the gauges read 0 and the collectors
are empty, as the JAX package's read on its host CPU: an observability
reading, never a route the program takes.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

log = logging.getLogger(__name__)


def _cuda_devices() -> range:
    import torch

    return range(torch.cuda.device_count()) if torch.cuda.is_available() else range(0)


def _memory_stat(field: str) -> float:
    """A `torch.cuda.memory_stats` field summed over the visible cards; 0.0
    without one."""
    import torch

    return float(sum(torch.cuda.memory_stats(d).get(field, 0) for d in _cuda_devices()))


def _memory_limit() -> float:
    """The visible cards' memory, summed; 0.0 without one."""
    import torch

    return float(sum(torch.cuda.get_device_properties(d).total_memory for d in _cuda_devices()))


def _per_device_memory() -> list[tuple[dict, float]]:
    import torch

    return [({"device": str(d), "platform": "gpu"}, float(torch.cuda.memory_allocated(d)))
            for d in _cuda_devices()]


def per_device_live_bytes() -> dict:
    """Bytes the caching allocator holds in live tensors per card right
    now (`torch.cuda.memory_allocated`), keyed by device index; {} without
    a card."""
    import torch

    return {d: float(torch.cuda.memory_allocated(d)) for d in _cuda_devices()}


class PeakLiveBytesTracker:
    """Max-over-time live bytes per (bucket, card): `record(bucket)` samples
    `per_device_live_bytes` into the bucket's cells; `values()` is the
    labelled collector's callback."""

    def __init__(self):
        self._peaks: dict = {}

    def record(self, bucket: str) -> None:
        for dev, val in per_device_live_bytes().items():
            key = (str(bucket), str(dev))
            if val > self._peaks.get(key, 0.0):
                self._peaks[key] = val

    def values(self) -> list:
        return [({"bucket": b, "device": d}, v) for (b, d), v in sorted(self._peaks.items())]


def register_device_gauges(sensors) -> PeakLiveBytesTracker:
    """Install the device-memory sensors on `sensors`; returns the peak
    tracker for the caller to feed."""
    sensors.gauge("tpu.device.memory-in-use-bytes",
                  lambda: _memory_stat("allocated_bytes.all.current"))
    sensors.gauge("tpu.device.memory-limit-bytes", _memory_limit)
    sensors.gauge("tpu.device.live-buffers", lambda: _memory_stat("active.all.current"))
    sensors.collector("tpu.device.memory-by-device", _per_device_memory)
    tracker = PeakLiveBytesTracker()
    sensors.collector("tpu.device.peak-live-bytes-by-bucket", tracker.values)
    return tracker


@contextlib.contextmanager
def profiler_trace(dump_dir: str | None):
    """Trace the block with `torch.profiler` (CPU and, where there is a
    card, CUDA activity) and write its Chrome trace to
    `dump_dir/trace-<ms>.json`; a no-op when `dump_dir` is empty.  Yields
    the profiler (None when off).

    A profiler that fails to start or to write its trace (an unwritable
    directory) never fails the block it observes, as in the JAX package:
    the block then runs unprofiled, and the failure is logged."""
    if not dump_dir:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        os.makedirs(dump_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception:  # noqa: BLE001 — profiling is best-effort
        log.warning("profiler did not start; the block runs unprofiled", exc_info=True)
        yield None
        return
    try:
        yield prof
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(dump_dir, f"trace-{int(time.time() * 1000)}.json"))
        except Exception:  # noqa: BLE001 — profiling is best-effort
            log.warning("profiler trace not written", exc_info=True)
