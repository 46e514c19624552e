"""refresh_aggregates — every per-broker aggregate of a placement, and host load.

Replaces: `compute_aggregates` and `host_load` (cruise_control_tpu/models/
aggregates.py:56, :117) as the engine's `_refresh_impl` (cruise_control_tpu/
analyzer/engine.py:1433) runs them between rounds: broker load [B, 4],
replica and leader counts, potential NW-out, leader bytes-in, the topic x
broker and partition x rack replica counts, disk load [B, D] and host load
[H, 4].

Bound on the card: bytes — each replica row is read once (~33 B) and the
partition x rack table (P x racks ints) written once: ~65 MB, ~20 us at
the north star.  Design (csrc/refresh.cu): one cooperative launch.  Over
`group_by_broker`'s order, a warp a broker gathers its rows a tile at a
time with all lanes, stages their addends in shared memory, and one lane
per accumulator adds them in row order, so every float is bit for bit the
plain version's (`index_add_` adds in row order on the CPU, and
`index_put_`'s accumulation does on CUDA); a block of eight brokers counts
their topics in shared memory and writes its columns of the topic x
broker table; the partition x rack table is written a partition row at a
time, whole, from the partitions' member table (`ClusterState.members`); after
a grid-wide barrier one thread per host adds its brokers' rows in broker
order.  Every output cell is written once; no clear, no global atomic.

The plain version is the reference's segment sums, written into the
outputs in place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import _build
from cruise_control_tpu_torch.kernels.group import Grouping, group_by_broker, group_placement

if TYPE_CHECKING:
    from cruise_control_tpu_torch.models.state import ClusterState

_FNS = None
#: the most members a partition may have in the kernel's member table
MAX_MEMBERS = 16
_NW_IN, _NW_OUT, _DISK = int(Resource.NW_IN), int(Resource.NW_OUT), int(Resource.DISK)
#: the broker aggregates the kernel writes, in BrokerAggregates' order
AGG_FIELDS = ("broker_load", "broker_replica_count", "broker_leader_count",
              "broker_potential_nw_out", "broker_leader_bytes_in", "broker_topic_count",
              "part_rack_count", "disk_load")


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of `data` rows per segment id in [0, num_segments); ids must lie in
    that range (callers route padding to a sentinel segment they slice off).

    On the CPU each segment adds its rows in row order, as the reference's
    scatter does (`index_add_`).  On CUDA, whose `index_add_` adds floats
    with atomics in no fixed order, floats go through `index_put_`'s
    accumulation, which sorts by segment and is the same run after run:
    rows of several columns add in row order, but a one-column segment's
    rows add in a tree.  The engine's aggregates do not come from here on
    CUDA (refresh_aggregates adds in row order); the goal chain's host
    sums do."""
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    if data.is_cuda and data.is_floating_point():
        return out.index_put_((segment_ids.long(),), data, accumulate=True)
    return out.index_add_(0, segment_ids, data)


@dataclasses.dataclass(frozen=True)
class HostGroups:
    """Brokers grouped by host for the host pass: seg i32[B] is the host of
    a valid broker and H for the rest; `group` is its grouping."""

    seg: torch.Tensor
    group: Grouping

    @staticmethod
    def of(broker_valid: torch.Tensor, broker_host: torch.Tensor, num_hosts: int,
           out: "HostGroups | None" = None) -> "HostGroups":
        """The grouping of a cluster's brokers; with `out`, written into its
        tensors in place (an engine's fixed buffers) and `out` returned."""
        seg = torch.where(broker_valid, broker_host, num_hosts).to(torch.int32)
        if out is None:
            seg = seg.contiguous()
            return HostGroups(seg=seg, group=group_by_broker(seg, num_hosts))
        out.seg.copy_(seg)
        group_by_broker(out.seg, num_hosts, out=out.group)
        return out


def refresh_plain(st: ClusterState, replica_broker, replica_is_leader, replica_disk, out: dict,
                  hosts: HostGroups | None, brokers: bool = True) -> dict:
    s = st.shape
    B, P, T, nr, D = s.B, s.P, s.num_topics, s.num_racks, s.max_disks_per_broker
    if brokers:
        valid = st.replica_valid
        seg = torch.where(replica_broker >= 0, replica_broker, B)
        lead = replica_is_leader[:, None]
        load = torch.where(valid[:, None], torch.where(lead, st.replica_load_leader,
                                                       st.replica_load_follower), 0.0)
        ones = valid.to(torch.int32)
        out["broker_load"].copy_(segment_sum(load, seg, B + 1)[:B])
        out["broker_replica_count"].copy_(segment_sum(ones, seg, B + 1)[:B])
        leaders = (replica_is_leader & valid).to(torch.int32)
        out["broker_leader_count"].copy_(segment_sum(leaders, seg, B + 1)[:B])
        pot = torch.where(valid, st.replica_load_leader[:, _NW_OUT], 0.0)
        out["broker_potential_nw_out"].copy_(segment_sum(pot, seg, B + 1)[:B])
        lead_in = torch.where(replica_is_leader & valid, st.replica_load_leader[:, _NW_IN], 0.0)
        out["broker_leader_bytes_in"].copy_(segment_sum(lead_in, seg, B + 1)[:B])
        topic_seg = torch.where(valid, st.replica_topic * B + replica_broker, T * B)
        out["broker_topic_count"].copy_(
            segment_sum(ones, topic_seg, T * B + 1)[: T * B].reshape(T, B))
        rack = st.broker_rack[replica_broker]
        pr_seg = torch.where(valid, st.replica_partition * nr + rack, P * nr)
        out["part_rack_count"].copy_(
            segment_sum(ones, pr_seg, P * nr + 1)[: P * nr].reshape(P, nr))
        disk_seg = torch.where(valid, replica_broker * D + replica_disk, B * D)
        out["disk_load"].copy_(segment_sum(
            torch.where(valid, load[:, _DISK], 0.0), disk_seg, B * D + 1)[: B * D].reshape(B, D))
    if hosts is not None:
        H = s.num_hosts
        out["host_load"].copy_(segment_sum(out["broker_load"], hosts.seg, H + 1)[:H])
    return out


class _Dims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("R", "B", "T", "P", "racks", "D", "H", "M")]


class _In(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "order", "start", "count", "is_leader", "replica_disk", "load_leader", "load_follower",
        "topic", "replica_broker", "members", "broker_rack", "host_order", "host_start", "host_count",
    )]


class _Out(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "broker_load", "rcount", "lcount", "pot", "lbin", "topic_count", "part_rack_count",
        "disk_load", "host_load",
    )]


def _fns():
    global _FNS
    if _FNS is None:
        lib = _build.library("refresh")
        geo, run = lib.cc_refresh_geometry, lib.cc_refresh_aggregates
        geo.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        run.argtypes = [_Dims, _In, _Out, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        geo.restype = run.restype = ctypes.c_int
        _FNS = geo, run
    return _FNS


@functools.lru_cache(maxsize=None)
def _blocks(T: int, M: int, device_index: int) -> int:
    """The most blocks resident at once with T topics and M members a
    partition (the launch's grid bound)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(_fns()[0](T, M, ctypes.byref(out)), "refresh_aggregates (geometry)")
    if out.value < 1:
        raise ValueError(f"refresh_aggregates: {T} topics and {M} members a partition exceed "
                         f"the kernel's shared memory")
    return out.value


def _ptr(name, t, dtype, shape) -> int:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"refresh_aggregates: {name} must be contiguous {dtype}{list(shape)}, "
                         f"got {t.dtype}{list(t.shape)}")
    if ((len(shape) == 2 and shape[1] == 4) or name == "part_rack_count") and t.data_ptr() % 16:
        raise ValueError(f"refresh_aggregates: {name} must be 16-byte aligned")
    return t.data_ptr()


def refresh_cuda(st: ClusterState, replica_broker, replica_is_leader, replica_disk, out: dict,
                 hosts: HostGroups | None, group: Grouping | None, brokers: bool = True,
                 members: torch.Tensor | None = None) -> dict:
    s = st.shape
    R, B, T, P, nr, D, H = s.R, s.B, s.num_topics, s.P, s.num_racks, s.max_disks_per_broker, s.num_hosts
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    M = 0
    if D > 32:
        raise ValueError(f"refresh_aggregates: {D} disks a broker exceed the kernel's 32 lanes")
    if brokers:
        if group is None:
            group = group_placement(replica_broker, st.replica_valid, B)
        if members is None:
            members = st.members
        M = int(members.shape[1]) if members.dim() == 2 else -1
        if not 1 <= M <= MAX_MEMBERS:
            raise ValueError(f"refresh_aggregates: the member table must be i32[P, 1..{MAX_MEMBERS}], "
                             f"got {list(members.shape)}")
        c_in = dict(
            order=_ptr("order", group.order, i32, (R,)), start=_ptr("start", group.start, i32, (B,)),
            count=_ptr("count", group.count, i32, (B,)),
            is_leader=_ptr("replica_is_leader", replica_is_leader, b8, (R,)),
            replica_disk=_ptr("replica_disk", replica_disk, i32, (R,)),
            load_leader=_ptr("load_leader", st.replica_load_leader, f32, (R, 4)),
            load_follower=_ptr("load_follower", st.replica_load_follower, f32, (R, 4)),
            topic=_ptr("replica_topic", st.replica_topic, i32, (R,)),
            replica_broker=_ptr("replica_broker", replica_broker, i32, (R,)),
            members=_ptr("members", members, i32, (P, M)),
            broker_rack=_ptr("broker_rack", st.broker_rack, i32, (B,)),
        )
        c_out = dict(
            rcount=_ptr("broker_replica_count", out["broker_replica_count"], i32, (B,)),
            lcount=_ptr("broker_leader_count", out["broker_leader_count"], i32, (B,)),
            pot=_ptr("broker_potential_nw_out", out["broker_potential_nw_out"], f32, (B,)),
            lbin=_ptr("broker_leader_bytes_in", out["broker_leader_bytes_in"], f32, (B,)),
            topic_count=_ptr("broker_topic_count", out["broker_topic_count"], i32, (T, B)),
            part_rack_count=_ptr("part_rack_count", out["part_rack_count"], i32, (P, nr)),
            disk_load=_ptr("disk_load", out["disk_load"], f32, (B, D)),
        )
    else:
        c_in, c_out = {}, {}
    dev = out["broker_load"].device
    c_out["broker_load"] = _ptr("broker_load", out["broker_load"], f32, (B, 4))
    if hosts is not None:
        hg = hosts.group
        c_in.update(host_order=_ptr("host_order", hg.order, i32, (B,)),
                    host_start=_ptr("host_start", hg.start, i32, (H,)),
                    host_count=_ptr("host_count", hg.count, i32, (H,)))
        c_out["host_load"] = _ptr("host_load", out["host_load"], f32, (H, 4))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks = _blocks(T if brokers else 0, M, index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _fns()[1](_Dims(R, B, T, P, nr, D, H, M), _In(**c_in), _Out(**c_out), int(brokers), blocks,
                       stream)
    _build.check(status, "refresh_aggregates")
    kernels.count("refresh_aggregates")
    return out


def refresh_aggregates(st: ClusterState, replica_broker, replica_is_leader, replica_disk, out: dict,
                       *, hosts: HostGroups | None = None, group: Grouping | None = None,
                       brokers: bool = True, members: torch.Tensor | None = None) -> dict:
    """Write the aggregates of the placement (replica_broker,
    replica_is_leader, replica_disk) of `st`'s cluster into `out` (the
    AGG_FIELDS when `brokers`, and "host_load" from out["broker_load"] when
    `hosts` is given): the kernel for CUDA tensors, over `group` (the
    placement's grouping by broker, computed when None) and `members` (the
    cluster's member table; `st.members` when None), the plain version for
    CPU tensors."""
    given = [] if members is None else [members]
    if kernels.route(replica_broker, out["broker_load"], st.replica_valid, *given) == "cpu":
        return refresh_plain(st, replica_broker, replica_is_leader, replica_disk, out, hosts, brokers)
    return refresh_cuda(st, replica_broker, replica_is_leader, replica_disk, out, hosts, group,
                        brokers, members)
