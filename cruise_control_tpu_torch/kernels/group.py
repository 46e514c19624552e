"""group_by_broker — rows grouped by segment: counts, starts and a stable order.

Replaces: the O(R) half of `_plan_build` (cruise_control_tpu/analyzer/
engine.py:1597): `segment_sum(ones, seg)[:B]`, the exclusive cumsum of those
counts, and `jnp.argsort(seg)` (stable); and, on the card, the sort that
`index_put_(accumulate=True)` ran inside the aggregates (models/
aggregates.py), which `refresh_aggregates` now walks instead.

Bound on the card: bytes — every row's segment id is read twice and its id
written once (~6 MB at 500k rows), a few microseconds of HBM time; the
four passes' launches dominate.  Design (csrc/group.cu): a stable counting
sort — per-chunk histograms in shared memory, a prefix per bin over the
chunks, a prefix over the bins, then one warp per chunk scattering its rows
in order, lanes of one bin ranked by `__match_any_sync`.  No comparison
sort, no float.

The plain version is `torch.bincount` and `torch.argsort(stable=True)`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build

_FN = None
#: rows per chunk of the histogram and scatter passes (csrc/group.cu kChunk)
CHUNK = 2048
#: shared memory a block may take for its bins (below the card's 227 KB)
SMEM_MAX = 200 * 1024


@dataclasses.dataclass(frozen=True)
class Grouping:
    """Rows grouped by segment: rows of segment s are
    order[start[s] : start[s] + count[s]], in row order; rows of the
    sentinel segment (padding) come after every real segment's."""

    count: torch.Tensor  # i32[n_seg]
    start: torch.Tensor  # i32[n_seg]
    order: torch.Tensor  # i32[N]

    @staticmethod
    def empty(n_rows: int, n_seg: int, device) -> "Grouping":
        def e(n):
            return torch.empty(n, dtype=torch.int32, device=device)

        return Grouping(count=e(n_seg), start=e(n_seg), order=e(n_rows))


def group_plain(seg: torch.Tensor, n_seg: int, out: Grouping) -> Grouping:
    cnt = torch.bincount(seg.long(), minlength=n_seg + 1)[:n_seg]
    out.count.copy_(cnt)
    out.start.copy_(torch.cumsum(cnt, 0) - cnt)
    out.order.copy_(torch.argsort(seg, stable=True))
    return out


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("group").cc_group_by_broker
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def group_cuda(seg: torch.Tensor, n_seg: int, out: Grouping) -> Grouping:
    n = int(seg.shape[0])
    nbins = n_seg + 1
    if seg.dtype != torch.int32 or not seg.is_contiguous():
        raise ValueError(f"group_by_broker: seg must be contiguous int32, got {seg.dtype}")
    if 4 * nbins > SMEM_MAX:
        raise ValueError(f"group_by_broker: {nbins} segments exceed the kernel's shared memory")
    for name, t, shape in (("count", out.count, (n_seg,)), ("start", out.start, (n_seg,)),
                           ("order", out.order, (n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"group_by_broker: {name} must be contiguous int32{list(shape)}")
    nchunks = (n + CHUNK - 1) // CHUNK
    scratch = torch.empty(nchunks * nbins + 2 * nbins, dtype=torch.int32, device=seg.device)
    hist, total, start = scratch[: nchunks * nbins], scratch[nchunks * nbins:][:nbins], scratch[-nbins:]
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    status = _fn()(seg.data_ptr(), n, nbins, hist.data_ptr(), total.data_ptr(), start.data_ptr(),
                   out.order.data_ptr(), stream)
    _build.check(status, "group_by_broker")
    kernels.LAUNCHES["group_by_broker"] += 1
    out.count.copy_(total[:n_seg])
    out.start.copy_(start[:n_seg])
    return out


def group_by_broker(seg: torch.Tensor, n_seg: int, out: Grouping | None = None) -> Grouping:
    """Group rows by `seg` (each in [0, n_seg], n_seg the padding
    sentinel): the kernel for CUDA tensors, the plain version for CPU
    tensors.  Writes into `out` when given."""
    if out is None:
        out = Grouping.empty(int(seg.shape[0]), n_seg, seg.device)
    if kernels.route(seg, out.order) == "cpu":
        return group_plain(seg, n_seg, out)
    return group_cuda(seg, n_seg, out)
