"""threefry_uniform — the anneal's draw stream.

Replaces: `jax.random.uniform` under `split`/`fold_in` keys and the engine's
`_uniform_idx` (cruise_control_tpu/analyzer/engine.py:958; draws at
:1815-1830, :1852, :2185, :2362, :2679), bit for bit with jax 0.9's
`jax_threefry_partitionable=True`.

Bound on the card: the 4 bytes written per draw; the hash is ~80 integer
operations per draw, far below the ALU rate, so a draw of K=16384 values
is a few microseconds of launch.  Design: one thread per draw, no shared
memory, the key passed by value; the float tail uses round-to-nearest
intrinsics so no multiply-add contraction changes a bit.

The plain version runs the same hash on int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_FN = None


def threefry2x32(k0: int, k1: int, x0, x1):
    """threefry2x32 of counter words (x0, x1) under key (k0, k1): Python
    integers, or int64 tensors holding uint32 values."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def unit_floats_plain(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) of the partitionable threefry stream."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], i >> 32, i & MASK32)
    fbits = ((y0 ^ y1) >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniform_plain(key, n, minval, maxval, device) -> torch.Tensor:
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    u = unit_floats_plain(key, n, device)
    return torch.clamp(u * float(span) + float(lo), min=float(lo))


def uniform_idx_plain(key, n, bound, device) -> torch.Tensor:
    """min(int(u * bound), bound - 1) of n draws; `bound` an int or a 0-d
    i32 tensor (a generation's count, read on the device)."""
    u = unit_floats_plain(key, n, device)
    if isinstance(bound, torch.Tensor):
        idx = (u * bound.to(torch.float32)).to(torch.int32)
        return torch.minimum(idx, bound - 1)
    idx = (u * float(np.float32(bound))).to(torch.int32)
    return torch.clamp(idx, max=bound - 1)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("threefry").cc_threefry_uniform
        fn.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(key, n, minval, span, bound, out_f, out_i, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    status = _fn()(
        key[0], key[1], n, minval, span, bound,
        out_f.data_ptr() if out_f is not None else None,
        out_i.data_ptr() if out_i is not None else None,
        stream,
    )
    _build.check(status, "threefry_uniform")
    kernels.count("threefry_uniform")


def uniform(key, n: int, *, minval: float = 0.0, maxval: float = 1.0, device) -> torch.Tensor:
    """f32[n] = jax.random.uniform(key, (n,), minval=minval, maxval=maxval)."""
    device = torch.device(device)
    if device.type == "cpu":
        return uniform_plain(key, n, minval, maxval, device)
    if device.type != "cuda":
        raise ValueError(f"threefry_uniform runs on CUDA or the CPU, not {device}")
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    out = torch.empty(n, dtype=torch.float32, device=device)
    _launch(key, n, float(lo), float(span), 0, out, None, device)
    return out


def uniform_idx(key, n: int, bound: int, *, device) -> torch.Tensor:
    """i32[n] = min(int(uniform(key, (n,)) * bound), bound - 1), bound >= 1."""
    if bound < 1:
        raise ValueError(f"uniform_idx needs bound >= 1, got {bound}")
    device = torch.device(device)
    if device.type == "cpu":
        return uniform_idx_plain(key, n, bound, device)
    if device.type != "cuda":
        raise ValueError(f"threefry_uniform runs on CUDA or the CPU, not {device}")
    out = torch.empty(n, dtype=torch.int32, device=device)
    _launch(key, n, 0.0, 1.0, bound, None, out, device)
    return out
