"""step_globals — the anneal step's frozen global scalars.

Replaces: `Engine._globals` (cruise_control_tpu/analyzer/engine.py:1623)
and its packing for the candidates kernel: masked sums over the brokers
(total load, replica, leader and leader-bytes-in totals, the tiebreak's
utilization sums, disk load) and over topic x broker (per-topic averages).

Bound on the card: latency.  The inputs are B broker rows and the T x B
topic counts (~2.2 MB at the north star), ~0.7 us of HBM time; the rest
is fixed latency.  Design (csrc/step_globals.cu): one launch, in
thread-block clusters.  The first cluster's 8 blocks sum the broker rows,
each thread a fixed slice in order, then fixed shuffle and pairwise trees;
each block pushes its partials into block 0's shared memory (distributed
shared memory) and, after one cluster barrier, block 0 adds them in a
fixed tree, so the result is the same bits run after run.  Every other
block sums one topic row with 16-byte loads, in integers.  n_alive, which
a model generation sets, is read from the engine's generation block
(`move_delta.Generation`) on the device, not passed by value.  The kernel's
sums run in another order than PyTorch's, so the two agree to f32
rounding.  (On the CPU the plain version adds the disk load in the
reference's order; the intra-broker disk deltas divide by it.)

The output is one f32 vector laid out as `LAYOUT`: its first 23 floats
(the total disk load last) are the vector the candidates kernel reads,
then come the T per-topic averages.  `unpack` gives the named views the objective terms
read.  The plain version is the reference's sums as PyTorch ops.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build
from cruise_control_tpu_torch.kernels import move_delta as md

_FN = None
#: (name, length) in the order of the output vector (csrc/step_globals.cu)
LAYOUT = (
    ("avg_pct", 4), ("total_load", 4), ("pct_sum", 4), ("pct_sumsq", 4),
    ("avg_count", 1), ("total_count", 1), ("avg_lcount", 1), ("total_lcount", 1),
    ("avg_lbin", 1), ("total_lbin", 1), ("total_disk_load", 1),
)
#: floats before the per-topic averages, all of which the candidates kernel reads
HEAD = sum(n for _, n in LAYOUT)
KERNEL_VEC = HEAD


def size(num_topics: int) -> int:
    return HEAD + num_topics


def unpack(buf: torch.Tensor) -> dict:
    """Named views of a globals vector: 4-vectors, 0-d scalars, "topic_avg"
    [T] and "vec", the candidates kernel's f32[23]."""
    g, at = {}, 0
    for name, n in LAYOUT:
        g[name] = buf[at: at + n] if n > 1 else buf[at]
        at += n
    g["topic_avg"] = buf[HEAD:]
    g["vec"] = buf[:KERNEL_VEC]
    return g


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The sum of x's elements in f32.  On the CPU element after element in
    row-major order, as the reference adds them (PyTorch's CPU sum of more
    than a few elements adds in vector lanes, which rounds differently);
    on CUDA PyTorch's sum."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.cumsum(x.reshape(-1).numpy(), dtype=np.float32)[-1:]).reshape(())
    return x.sum()


def globals_plain(sx, carry, out: torch.Tensor) -> dict:
    st = sx.state
    am = sx.alive
    load = torch.where(am[:, None], carry.broker_load, 0.0)
    total_load = load.sum(0)
    total_count = torch.where(am, carry.broker_replica_count, 0).sum().to(torch.float32)
    total_lcount = torch.where(am, carry.broker_leader_count, 0).sum().to(torch.float32)
    total_lbin = torch.where(am, carry.broker_leader_bytes_in, 0.0).sum()
    topic_total = torch.where(am[None, :], carry.broker_topic_count, 0).sum(1)
    dmask = st.disk_alive & am[:, None]
    total_disk_load = _sum_f32(torch.where(dmask, carry.disk_load, 0.0))
    pct = torch.where(am[:, None], carry.broker_load / (st.broker_capacity + 1e-12), 0.0)
    vals = dict(
        avg_pct=total_load / sx.total_cap,
        total_load=total_load,
        pct_sum=pct.sum(0),
        pct_sumsq=(pct * pct).sum(0),
        avg_count=md.div(total_count, sx.gen, "n_alive"),
        total_count=torch.clamp(total_count, min=1.0),
        avg_lcount=md.div(total_lcount, sx.gen, "n_alive"),
        total_lcount=torch.clamp(total_lcount, min=1.0),
        avg_lbin=md.div(total_lbin, sx.gen, "n_alive"),
        total_lbin=total_lbin + 1e-12,
        total_disk_load=total_disk_load + 1e-12,
    )
    g = unpack(out)
    for name, _ in LAYOUT:
        g[name].copy_(vals[name])
    g["topic_avg"].copy_(md.div(topic_total.to(torch.float32), sx.gen, "n_alive"))
    return g


class _In(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "alive", "broker_load", "capacity", "rcount", "lcount", "lbin", "topic_count",
        "disk_alive", "disk_load", "total_cap", "gen",
    )]


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("step_globals").cc_step_globals
        fn.argtypes = [_In, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _ptr(name, t, dtype, shape) -> int:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"step_globals: {name} must be contiguous {dtype}{list(shape)}, "
                         f"got {t.dtype}{list(t.shape)}")
    if len(shape) == 2 and shape[1] == 4 and t.data_ptr() % 16:
        raise ValueError(f"step_globals: {name} rows must be 16-byte aligned")
    return t.data_ptr()


def globals_cuda(sx, carry, out: torch.Tensor) -> dict:
    st = sx.state
    s = st.shape
    B, T, D = s.B, s.num_topics, s.max_disks_per_broker
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    c_in = _In(
        alive=_ptr("alive", sx.alive, b8, (B,)),
        broker_load=_ptr("broker_load", carry.broker_load, f32, (B, 4)),
        capacity=_ptr("broker_capacity", st.broker_capacity, f32, (B, 4)),
        rcount=_ptr("broker_replica_count", carry.broker_replica_count, i32, (B,)),
        lcount=_ptr("broker_leader_count", carry.broker_leader_count, i32, (B,)),
        lbin=_ptr("broker_leader_bytes_in", carry.broker_leader_bytes_in, f32, (B,)),
        topic_count=_ptr("broker_topic_count", carry.broker_topic_count, i32, (T, B)),
        disk_alive=_ptr("disk_alive", st.disk_alive, b8, (B, D)),
        disk_load=_ptr("disk_load", carry.disk_load, f32, (B, D)),
        total_cap=_ptr("total_cap", sx.total_cap, f32, (4,)),
        gen=_ptr("gen", sx.gen.words, i32, (md.GEN_WORDS,)),
    )
    buf = _ptr("out", out, f32, (size(T),))
    stream = torch.cuda.current_stream(out.device).cuda_stream
    status = _fn()(c_in, B, T, D, buf, stream)
    _build.check(status, "step_globals")
    kernels.count("step_globals")
    return unpack(out)


def step_globals(sx, carry, out: torch.Tensor | None = None) -> dict:
    """The step's globals of `carry` written into `out` (f32[size(T)],
    allocated when None), returned as `unpack(out)`: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if out is None:
        out = torch.empty(size(sx.state.shape.num_topics), dtype=torch.float32,
                          device=carry.broker_load.device)
    if kernels.route(carry.broker_load, sx.alive, out) == "cpu":
        return globals_plain(sx, carry, out)
    return globals_cuda(sx, carry, out)
