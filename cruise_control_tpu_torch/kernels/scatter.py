"""scatter_loads — a metric window's new per-replica loads into the live tables.

Replaces: models/whatif.py `_make_scatter_partition_loads`
(cruise_control_tpu/models/whatif.py:393) and the scatter at the head of
`Engine._cycle_impl` (cruise_control_tpu/analyzer/engine.py:3446-3448):
`ll.at[rows].set(new_ll, mode="drop")` and the same for the follower
table.  For i < n, row rows[i] of the f32[R, 4] leader and follower load
tables takes row i of `new_ll` / `new_fl`; a row in [-R, 0) counts from
the end, as a JAX index does, and any other row outside [0, R) (the
sentinel R pads a window) is dropped.  Rows of one window are unique (each
replica of a changed partition appears once); duplicate rows have no
defined winner, as in JAX.

Bound on the card: bytes, 68 B a row (the row index, two new rows read, two
rows written).  Design (csrc/scatter.cu): the count `n` is read from
device memory and the rows from a staging buffer of fixed capacity, so one
launch shape serves every window width and the launch sits in the
streaming cycle's captured graph, replayed window after window without a
recapture (a width-sized `index_copy_` would need a graph per width).  A
fixed grid walks the n rows, one row a thread, 16-byte loads and stores.

The plain version is a masked `index_put_` over the first n rows.
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("scatter").cc_scatter_loads
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(ll, fl, rows, new_ll, new_fl, n) -> tuple[int, int]:
    """(R, capacity) of a call's operands, or ValueError."""
    R, cap = int(ll.shape[0]), int(rows.shape[0])
    want = (("ll", ll, torch.float32, (R, 4)), ("fl", fl, torch.float32, (R, 4)),
            ("rows", rows, torch.int32, (cap,)), ("new_ll", new_ll, torch.float32, (cap, 4)),
            ("new_fl", new_fl, torch.float32, (cap, 4)), ("n", n, torch.int32, (1,)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"scatter_loads: {name} must be contiguous {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)} contiguous={t.is_contiguous()}")
    return R, cap


def scatter_loads_plain(ll, fl, rows, new_ll, new_fl, n) -> None:
    """The scatter as PyTorch ops, in place: the first n rows (n clamped to
    [0, capacity]), rows in [-R, 0) from the end, the others outside
    [0, R) dropped."""
    R, cap = _check(ll, fl, rows, new_ll, new_fl, n)
    k = min(max(int(n[0]), 0), cap)
    r = rows[:k].long()
    r = torch.where(r < 0, r + R, r)
    keep = (r >= 0) & (r < R)
    ll.index_put_((r[keep],), new_ll[:k][keep])
    fl.index_put_((r[keep],), new_fl[:k][keep])


def scatter_loads(ll, fl, rows, new_ll, new_fl, n) -> None:
    """Scatter row i < n of `new_ll` / `new_fl` into row rows[i] of `ll` /
    `fl` (f32[R, 4]), in place.  `rows` i32[cap] and the new rows
    f32[cap, 4] are a staging buffer of capacity `cap`; `n` is an i32[1]
    tensor, read on the device by the kernel.  The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if kernels.route(ll, fl, rows, new_ll, new_fl, n) == "cpu":
        return scatter_loads_plain(ll, fl, rows, new_ll, new_fl, n)
    R, cap = _check(ll, fl, rows, new_ll, new_fl, n)
    for name, t in (("ll", ll), ("fl", fl), ("new_ll", new_ll), ("new_fl", new_fl)):
        if t.data_ptr() % 16:
            raise ValueError(f"scatter_loads: {name}'s rows must be aligned to 16 bytes")
    if cap == 0:
        return None
    stream = torch.cuda.current_stream(ll.device).cuda_stream
    status = _fn()(ll.data_ptr(), fl.data_ptr(), rows.data_ptr(), new_ll.data_ptr(),
                   new_fl.data_ptr(), n.data_ptr(), R, cap, stream)
    _build.check(status, "scatter_loads")
    kernels.count("scatter_loads")
    return None
