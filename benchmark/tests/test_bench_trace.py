"""The trace's reduction: the union of the device intervals, the spans'
annotations left out, idle gaps by what the host was doing, and no
reading at all from a session that recorded nothing on the device."""

import types

import pytest
from torch.autograd import DeviceType

from harness import trace


class _Event:
    def __init__(self, start_us, end_us, name, device=False, annotation=False):
        self._s, self._e, self._n = start_us, end_us, name
        self._d = DeviceType.CUDA if device else DeviceType.CPU
        self._a = annotation

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int((self._e - self._s) * 1e3)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_busy_ops_and_gaps():
    ev = [
        _Event(0, 100, "bench.optimize"), _Event(10, 40, "aten::copy_"),
        _Event(0, 100, "bench.optimize", device=True, annotation=True),
        _Event(5, 15, "kern_a", device=True), _Event(12, 20, "kern_b", device=True),
        _Event(30, 35, "kern_a", device=True), _Event(60, 70, "kern_a", device=True),
    ]
    t = trace.reduce(_prof(ev))
    assert t.busy_s == pytest.approx(30e-6)   # [5, 20] + [30, 35] + [60, 70]
    assert t.ops == {"kern_a": [pytest.approx(25e-6), 3], "kern_b": [pytest.approx(8e-6), 1]}
    assert t.kernel("kern_a") == (pytest.approx(25e-6), 3)
    # the gap [20, 30] falls inside aten::copy_, [35, 60] only inside the span
    assert t.idle_gaps == {"aten::copy_": pytest.approx(10e-6),
                           "bench.optimize": pytest.approx(25e-6)}


def test_no_device_operation_is_an_error():
    ev = [_Event(0, 100, "bench.optimize"),
          _Event(0, 100, "bench.optimize", device=True, annotation=True)]
    with pytest.raises(trace.EmptyTrace):
        trace.reduce(_prof(ev))


def test_a_blocking_wait_counts_as_busy():
    """The card runs the queued work while the host waits on it, whether
    or not the profiler recorded those kernels."""
    ev = [
        _Event(0, 100, "bench.optimize"), _Event(36, 58, "cudaStreamSynchronize"),
        _Event(5, 20, "kern_a", device=True), _Event(60, 70, "kern_a", device=True),
    ]
    t = trace.reduce(_prof(ev))
    assert t.busy_s == pytest.approx((15 + 22 + 10) * 1e-6)
    assert t.idle_gaps == {"bench.optimize": pytest.approx((16 + 2) * 1e-6)}


def test_recorded_busy_leaves_the_waits_out():
    ev = [
        _Event(0, 100, "bench.optimize"), _Event(36, 58, "cudaStreamSynchronize"),
        _Event(5, 20, "kern_a", device=True), _Event(60, 70, "kern_a", device=True),
    ]
    assert trace.reduce(_prof(ev)).recorded_busy_s == pytest.approx(25e-6)


def test_sample_in_requests_places_each_launch_in_its_request():
    ev = [
        _Event(0, 100, "bench.optimize"), _Event(200, 300, "bench.optimize"),
        _Event(5, 7, "candidates_kernel<1>", device=True),
        _Event(30, 34, "candidates_kernel<1>", device=True),
        _Event(210, 212, "candidates_kernel<1>", device=True),
        _Event(250, 256, "candidates_kernel<1>", device=True),
        _Event(60, 70, "apply_moves_kernel", device=True),
        _Event(150, 160, "candidates_kernel<1>", device=True),   # outside any request
    ]
    t = trace.reduce(_prof(ev))
    got = t.sample_in_requests("candidates_kernel", "bench.optimize")
    assert got == dict(requests=2, launches_per_request=2.0,
                       offset_ms=pytest.approx(7.5e-3), extent_ms=pytest.approx(32.5e-3),
                       first_half_us=pytest.approx(2.0), second_half_us=pytest.approx(5.0))
    assert t.sample_in_requests("select_survivors", "bench.optimize") is None
