"""The device trace of a traced run, reduced to what the metrics read.

torch.profiler (CUPTI) records the traced part of the window: every
kernel, copy and set on the card, kernels inside CUDA graphs included,
and the host's operations with the harness's own spans
(`torch.profiler.record_function("bench.<stage>")`).  The reduction:

  busy_s        the union of the device intervals and of the host's blocking
                waits on the card (see below): the seconds in which some
                operation ran on the card, waits counted busy
  recorded_busy_s  the union of the device intervals alone
  ops           per device operation name: total seconds and launches
  idle_gaps     the device's idle time between its first and last
                operation in the traced part, summed by the innermost host
                span or operation open at each gap's middle (what the host
                was doing while the card waited)

A trace with no device operation is an error, never an idle share of 100%
or a roofline of 0: a profiler session that recorded nothing cannot say
what the card did.

CUPTI on the H100 records a conditional loop graph's body kernels far
fewer times than they run (of a proposal's 8 rounds of candidates
launches, one round's appear, back to back, late in the anneal), so the
device intervals alone leave most of an anneal out.  While the host is blocked in a synchronisation with the
card, the card is running the work queued before it, so those waits
(`BLOCKING`) count as busy too; a wait on a card that has finished
returns at once and adds nothing; a wait on a graph that idles between
its nodes counts that idle time as busy.  A kernel's time per launch is
read from the launches recorded, each a real one; `sample_in_requests`
says where in a request the recorded launches lie and what each took.
"""

from __future__ import annotations

import bisect
import dataclasses


#: host calls that block until the card has run the work queued before them
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


class EmptyTrace(RuntimeError):
    """The profiler recorded no operation on the device."""


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    recorded_busy_s: float
    ops: dict          # name -> [seconds, launches]
    idle_gaps: dict    # host label -> seconds
    intervals: list    # (start us, end us, name) of each device operation
    spans: list        # (start us, end us, name) of each harness span

    def kernel(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        `pattern` as a word (templated kernels appear under several names)."""
        import re

        rx = re.compile(rf"\b{re.escape(pattern)}\b")
        s = n = 0
        for name, (sec, cnt) in self.ops.items():
            if rx.search(name):
                s += sec
                n += cnt
        return s, n

    def sample_in_requests(self, pattern: str, span: str) -> dict | None:
        """Which launches of `pattern` the profiler recorded within the
        `span` spans (a request each): the requests holding any, the
        launches a request, the mean offset of a request's first recorded
        launch from its start and the mean extent from its first to its
        last (ms), and the mean time a launch of the first and second half
        of each request's recorded launches (us)."""
        import re

        rx = re.compile(rf"\b{re.escape(pattern)}\b")
        spans = sorted((s, e) for s, e, n in self.spans if n == span)
        starts = [s for s, _ in spans]
        by_req: dict = {}
        for s, e, name in self.intervals:
            k = bisect.bisect_right(starts, s) - 1
            if rx.search(name) and k >= 0 and s <= spans[k][1]:
                by_req.setdefault(k, []).append((s, e - s))
        if not by_req:
            return None
        n, offset, extent, first, second = len(by_req), 0.0, 0.0, [], []
        for k, launches in by_req.items():
            launches.sort()
            offset += (launches[0][0] - spans[k][0]) / n
            extent += (launches[-1][0] - launches[0][0]) / n
            half = len(launches) // 2
            first += [d for _, d in launches[:half]]
            second += [d for _, d in launches[half:]]
        mean = lambda x: sum(x) / len(x) if x else None  # noqa: E731
        return dict(requests=n, launches_per_request=sum(map(len, by_req.values())) / n,
                    offset_ms=offset * 1e-3, extent_ms=extent * 1e-3,
                    first_half_us=mean(first), second_half_us=mean(second))


def start():
    """A running profiler session over the host and the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    return prof


def stop(prof) -> None:
    """End the session once the card has finished what was sent to it."""
    import torch

    torch.cuda.synchronize()
    prof.stop()


def _events(prof):
    """(start us, end us, name, on the device, a span's annotation) of each
    event of the session's raw results."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        yield (s, s + e.duration_ns() / 1e3, e.name(), e.device_type() == DeviceType.CUDA,
               e.is_user_annotation())


def reduce(prof) -> DeviceTrace:
    """The reduction of a stopped session's events.  A span's annotation
    on the device timeline (`record_function` marks the device work of its
    range) is no device operation and is left out."""
    dev, host = [], []
    for start, end, name, on_device, annotation in _events(prof):
        if end <= start:
            continue
        if on_device:
            if not annotation and not name.startswith("bench."):
                dev.append((start, end, name))
        else:
            host.append((start, end, name))
    if not dev:
        raise EmptyTrace("the profiler recorded no device operation in the traced window")
    ops: dict = {}
    for s, e, name in dev:
        rec = ops.setdefault(name, [0.0, 0])
        rec[0] += (e - s) * 1e-6
        rec[1] += 1
    busy, gaps = _union(sorted(dev + [h for h in host if h[2] in BLOCKING]))
    recorded, _ = _union(sorted(dev))
    spans = [h for h in host if h[2].startswith("bench.")]
    return DeviceTrace(busy_s=busy * 1e-6, recorded_busy_s=recorded * 1e-6, ops=ops,
                       idle_gaps=_label(gaps, host), intervals=dev, spans=spans)


def _union(intervals) -> tuple[float, list]:
    """(the length of the union of sorted intervals, the gaps between its
    pieces)."""
    busy, gaps = 0.0, []
    cur_s, cur_e = intervals[0][0], intervals[0][1]
    for s, e, _ in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, gaps


def _label(gaps, host) -> dict:
    """Idle seconds by the innermost host event open at each gap's middle:
    a sweep over the host events in start order with a stack of the open
    ones (the latest-starting open event is the innermost)."""
    host.sort(key=lambda x: (x[0], -x[1]))
    starts = [h[0] for h in host]
    out: dict = {}
    stack: list = []
    k = 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        hi = bisect.bisect_right(starts, mid)
        while k < hi:
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = "host.untraced"
        for ev in reversed(stack):
            if ev[1] >= mid:
                label = ev[2]
                break
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-6
    return out
