"""group_by_broker — rows grouped by segment: counts, starts and a stable order.

Replaces: the O(R) half of `_plan_build` (cruise_control_tpu/analyzer/
engine.py:1597): `segment_sum(ones, seg)[:B]`, the exclusive cumsum of those
counts, and `jnp.argsort(seg)` (stable); and, on the card, the sort that
`index_put_(accumulate=True)` ran inside the aggregates (models/
aggregates.py), which `refresh_aggregates` now walks instead.

Two entries: `group_by_broker` takes the segment ids; `group_placement`
takes a placement (broker ids and the valid mask) and computes the segment
of each row itself (`placement_segments`), so the engine runs no op before
the kernel.

Bound on the card: latency — every row's segment is read twice and its id
written once (~4.5 MB at 500k rows, about a microsecond of HBM time); the
passes' chain is what costs.  Design (csrc/group.cu): one cooperative
launch of a stable counting sort — per-warp histograms in shared memory,
a prefix per bin over the blocks (one warp a bin), the bins' starts scanned
by every block, then every warp scattering its rows in order, lanes of one
bin ranked by `__match_any_sync`.  No comparison sort, no float, no global
atomic.  Its scratch (bins x blocks ints) comes with the grouping
(`Grouping.empty`), so a call allocates nothing.

The plain version is `torch.bincount` and `torch.argsort(stable=True)`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build

_FNS = None
#: shared memory the kernel's bin tables may take (csrc/group.cu kSmemMax):
#: at least one warp's table and the block's base, 4 B a bin each
SMEM_MAX = 200 * 1024
#: the most segments (bins less the sentinel) the kernel takes
MAX_SEGMENTS = SMEM_MAX // 8 - 1


@dataclasses.dataclass(frozen=True)
class Grouping:
    """Rows grouped by segment: rows of segment s are
    order[start[s] : start[s] + count[s]], in row order; rows of the
    sentinel segment (padding) come after every real segment's.  `hist` is
    the kernel's scratch on CUDA, None on the CPU: build a grouping with
    `Grouping.empty`."""

    count: torch.Tensor  # i32[n_seg]
    start: torch.Tensor  # i32[n_seg]
    order: torch.Tensor  # i32[N]
    hist: torch.Tensor | None = None  # i32[(n_seg + 1) * blocks], CUDA

    @staticmethod
    def empty(n_rows: int, n_seg: int, device) -> "Grouping":
        device = torch.device(device)

        def e(n):
            return torch.empty(n, dtype=torch.int32, device=device)

        hist = e(hist_size(n_rows, n_seg, device)) if device.type == "cuda" else None
        return Grouping(count=e(n_seg), start=e(n_seg), order=e(n_rows), hist=hist)


def placement_segments(broker: torch.Tensor, valid: torch.Tensor, n_seg: int) -> torch.Tensor:
    """i32[N]: a valid row's broker, n_seg (the sentinel) for padding and
    for a broker id outside [0, n_seg)."""
    inside = valid & (broker >= 0) & (broker < n_seg)
    return torch.where(inside, broker, n_seg).to(torch.int32)


def group_plain(seg: torch.Tensor, n_seg: int, out: Grouping) -> Grouping:
    seg = torch.where((seg >= 0) & (seg <= n_seg), seg, n_seg)
    cnt = torch.bincount(seg.long(), minlength=n_seg + 1)[:n_seg]
    out.count.copy_(cnt)
    out.start.copy_(torch.cumsum(cnt, 0) - cnt)
    out.order.copy_(torch.argsort(seg, stable=True))
    return out


class _Args(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("seg", "broker", "valid", "hist", "count", "start",
                                                 "order")]
                + [(f, ctypes.c_int) for f in ("n", "nbins", "rows_per_warp")])


def _fns():
    global _FNS
    if _FNS is None:
        lib = _build.library("group")
        geo, run = lib.cc_group_geometry, lib.cc_group_by_broker
        geo.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        run.argtypes = [_Args, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        geo.restype = run.restype = ctypes.c_int
        _FNS = geo, run
    return _FNS


@functools.lru_cache(maxsize=None)
def _geometry(n: int, nbins: int, device_index: int) -> tuple[int, int, int]:
    """(blocks, warps a block, rows a warp) of the launch for n rows and
    nbins bins on the device."""
    if not 1 <= nbins <= MAX_SEGMENTS + 1:
        raise ValueError(f"group_by_broker: {nbins - 1} segments exceed the kernel's "
                         f"{MAX_SEGMENTS} (its per-warp tables must fit shared memory)")
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        _build.check(_fns()[0](n, nbins, out), "group_by_broker (geometry)")
    return out[0], out[1], out[2]


def hist_size(n_rows: int, n_seg: int, device) -> int:
    """Ints of the kernel's scratch for n_rows rows and n_seg segments."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return (n_seg + 1) * _geometry(n_rows, n_seg + 1, index)[0]


def _check_out(out: Grouping, n: int, n_seg: int) -> None:
    for name, t, shape in (("count", out.count, (n_seg,)), ("start", out.start, (n_seg,)),
                           ("order", out.order, (n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"group_by_broker: {name} must be contiguous int32{list(shape)}")


def _launch(args: dict, n: int, n_seg: int, out: Grouping, device) -> Grouping:
    _check_out(out, n, n_seg)
    index = device.index if device.index is not None else torch.cuda.current_device()
    blocks, warps, rows_per_warp = _geometry(n, n_seg + 1, index)
    hist = out.hist
    if hist is None or hist.numel() != (n_seg + 1) * blocks or hist.dtype != torch.int32:
        raise ValueError(f"group_by_broker: the grouping lacks the kernel's scratch for {n} rows "
                         f"and {n_seg} segments; build it with Grouping.empty")
    a = _Args(hist=hist.data_ptr(), count=out.count.data_ptr(), start=out.start.data_ptr(),
              order=out.order.data_ptr(), n=n, nbins=n_seg + 1, rows_per_warp=rows_per_warp, **args)
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_fns()[1](a, blocks, warps, stream), "group_by_broker")
    kernels.count("group_by_broker")
    return out


def _rows(name: str, t: torch.Tensor, dtype, n: int) -> int:
    if t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"group_by_broker: {name} must be contiguous {dtype}[{n}], "
                         f"got {t.dtype}{list(t.shape)}")
    return t.data_ptr()


def group_by_broker(seg: torch.Tensor, n_seg: int, out: Grouping | None = None) -> Grouping:
    """Group rows by `seg` (each in [0, n_seg], n_seg the padding
    sentinel; an id outside that range counts as the sentinel's): the
    kernel for CUDA tensors, the plain version for CPU tensors.  Writes
    into `out` when given."""
    n = int(seg.shape[0])
    if out is None:
        out = Grouping.empty(n, n_seg, seg.device)
    if kernels.route(seg, out.order) == "cpu":
        return group_plain(seg, n_seg, out)
    return _launch(dict(seg=_rows("seg", seg, torch.int32, n)), n, n_seg, out, seg.device)


def group_placement(broker: torch.Tensor, valid: torch.Tensor, n_seg: int,
                    out: Grouping | None = None) -> Grouping:
    """The rows of a placement grouped by broker: `group_by_broker` of
    `placement_segments(broker, valid, n_seg)`, the segments computed
    inside the kernel on CUDA."""
    n = int(broker.shape[0])
    if out is None:
        out = Grouping.empty(n, n_seg, broker.device)
    if kernels.route(broker, valid, out.order) == "cpu":
        return group_plain(placement_segments(broker, valid, n_seg), n_seg, out)
    args = dict(broker=_rows("broker", broker, torch.int32, n), valid=_rows("valid", valid, torch.bool, n))
    return _launch(args, n, n_seg, out, broker.device)
