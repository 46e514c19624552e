"""select_survivors — conflict resolution of the accepted candidates.

Replaces: `Engine._select` (cruise_control_tpu/analyzer/engine.py:2643),
the stable double `argsort` of the deltas plus a `segment_min` of the ranks
over B + P segments.  A candidate survives when it is accepted and is the
best-ranked accepted candidate at its src broker, its dst broker and each
of its (one or two) partitions; rank is the stable order of (delta, index).

Bound on the card: bytes — each candidate reads ~25 bytes and does four
8-byte atomics; the B + P = ~200k segment minima are cleared and read once.
Design: no sort.  A packed 64-bit key, (order-preserving bits of delta) <<
32 | index, orders candidates exactly as the stable argsort does (-0.0 is
folded onto +0.0 first, since argsort ranks them equal), so pass 1 takes
an `atomicMin` of the key into each of a candidate's segments and pass 2
keeps the candidates whose key is every one of their segments' minimum.
Rejected candidates never touch a segment: every accepted delta ranks
ahead of the +inf that rejection assigns in the reference.

The plain version computes the same packed keys in int64 and takes the
segment minima with `scatter_reduce`.
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build

_FN = None


def packed_keys(delta: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as the stable argsort of delta orders candidates
    (a signed twin of the kernel's unsigned keys: the same order)."""
    d = torch.where(delta == 0, torch.zeros_like(delta), delta)  # -0.0 -> +0.0
    bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    idx = torch.arange(delta.shape[0], dtype=torch.int64, device=delta.device)
    return (ordered - (1 << 31)) * (1 << 32) + idx


def select_plain(accept, delta, src, dst, part1, part2, num_brokers: int, num_parts: int):
    B, P = num_brokers, num_parts
    key = packed_keys(delta)
    seg = torch.stack([src.long(), dst.long(), B + part1.long(), B + part2.long()])  # [4, K]
    n_seg = B + P
    ok = accept[None, :] & (seg >= 0) & (seg < n_seg)
    segmin = torch.full((n_seg,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                        device=delta.device)
    key4 = key[None, :].expand_as(seg)
    segmin.scatter_reduce_(0, seg[ok], key4[ok], reduce="amin")
    mins = segmin[seg.clamp(0, n_seg - 1)]
    return accept & (mins == key[None, :]).all(0)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("select").cc_select_survivors
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def select_buffers(K: int, num_brokers: int, num_parts: int, device) -> tuple:
    """(segment minima i64[B + P], survivors bool[K]), reusable across calls."""
    return (torch.empty(num_brokers + num_parts, dtype=torch.int64, device=device),
            torch.empty(K, dtype=torch.bool, device=device))


def select_cuda(accept, delta, src, dst, part1, part2, num_brokers: int, num_parts: int,
                bufs: tuple | None = None):
    K = int(delta.shape[0])
    for name, t, dt in (
        ("accept", accept, torch.bool), ("delta", delta, torch.float32),
        ("src", src, torch.int32), ("dst", dst, torch.int32),
        ("part1", part1, torch.int32), ("part2", part2, torch.int32),
    ):
        if t.dtype != dt or tuple(t.shape) != (K,) or not t.is_contiguous():
            raise ValueError(f"select_survivors: {name} must be contiguous {dt}[{K}]")
    segmin, survive = bufs if bufs is not None else select_buffers(K, num_brokers, num_parts,
                                                                   delta.device)
    if K == 0:
        return survive
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    status = _fn()(
        K, num_brokers, num_parts,
        *[t.data_ptr() for t in (accept, delta, src, dst, part1, part2, segmin, survive)],
        stream,
    )
    _build.check(status, "select_survivors")
    kernels.LAUNCHES["select_survivors"] += 1
    return survive


def select_survivors(accept, delta, src, dst, part1, part2, *, num_brokers: int,
                     num_parts: int, bufs: tuple | None = None) -> torch.Tensor:
    """bool[K] survivors (engine.py:2643 `_select`): the kernel for CUDA
    tensors, into `bufs` (`select_buffers`) when given, the plain version
    for CPU tensors."""
    if kernels.route(accept, delta, src, dst, part1, part2) == "cpu":
        return select_plain(accept, delta, src, dst, part1, part2, num_brokers, num_parts)
    return select_cuda(accept, delta, src, dst, part1, part2, num_brokers, num_parts, bufs)
