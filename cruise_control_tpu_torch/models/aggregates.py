"""Broker-level aggregate views of a ClusterState.

Every O(replicas) walk the reference performs inside goal hot loops
(reference: model/Broker.java trackedSortedReplicas) becomes one segment sum
here.  Aggregates are computed once per optimizer round and updated
incrementally by move deltas in between, so a candidate costs O(1) gathers.

Segment sums add into a buffer with one sentinel row past the end:
padding rows are routed there and sliced off, so no index ever leaves the
buffer.
"""

from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.models.state import ClusterState


@dataclasses.dataclass(frozen=True)
class BrokerAggregates:
    """Per-broker reductions that every goal scores against.

    part_rack_count is the dense [P, num_racks] replica count used by the
    rack-awareness goal (reference analyzer/goals/RackAwareGoal.java:43).
    """

    broker_load: torch.Tensor  # f32[B, NUM_RESOURCES]
    broker_replica_count: torch.Tensor  # i32[B]
    broker_leader_count: torch.Tensor  # i32[B]
    broker_potential_nw_out: torch.Tensor  # f32[B]
    broker_leader_bytes_in: torch.Tensor  # f32[B] NW_IN served by leaders only
    broker_topic_count: torch.Tensor  # i32[T, B]
    part_rack_count: torch.Tensor  # i32[P, num_racks]
    disk_load: torch.Tensor  # f32[B, D]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of `data` rows per segment id in [0, num_segments); ids must lie in
    that range (callers route padding to a sentinel segment they slice off).

    Each segment adds its rows in row order, as the reference's scatter
    does: `index_add_` on the CPU; on CUDA, whose `index_add_` adds floats
    with atomics in no fixed order, `index_put_`'s accumulation, which adds
    a segment's rows in row order after a stable sort by segment.  So a
    seed gives the same aggregates, and the same anneal, run after run."""
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    if data.is_cuda and data.is_floating_point():
        return out.index_put_((segment_ids.long(),), data, accumulate=True)
    return out.index_add_(0, segment_ids, data)


def compute_aggregates(state: ClusterState) -> BrokerAggregates:
    s = state.shape
    B, P = s.B, s.P
    seg = state.broker_segment_ids()  # [R], padding -> B overflow bucket
    valid = state.replica_valid

    load = state.replica_load  # [R, 4], already masked by valid
    broker_load = segment_sum(load, seg, B + 1)[:B]

    ones = valid.to(torch.int32)
    broker_replica_count = segment_sum(ones, seg, B + 1)[:B]

    leaders = (state.replica_is_leader & valid).to(torch.int32)
    broker_leader_count = segment_sum(leaders, seg, B + 1)[:B]

    pot = torch.where(valid, state.replica_load_leader[:, Resource.NW_OUT], 0.0)
    broker_potential_nw_out = segment_sum(pot, seg, B + 1)[:B]

    lead_in = torch.where(
        state.replica_is_leader & valid, state.replica_load_leader[:, Resource.NW_IN], 0.0
    )
    broker_leader_bytes_in = segment_sum(lead_in, seg, B + 1)[:B]

    T = s.num_topics
    topic_seg = torch.where(valid, state.replica_topic * B + state.replica_broker, T * B)
    broker_topic_count = segment_sum(ones, topic_seg, T * B + 1)[: T * B].reshape(T, B)

    rack = state.broker_rack[state.replica_broker]  # [R]
    nr = s.num_racks
    pr_seg = torch.where(valid, state.replica_partition * nr + rack, P * nr)
    part_rack_count = segment_sum(ones, pr_seg, P * nr + 1)[: P * nr].reshape(P, nr)

    D = s.max_disks_per_broker
    disk_seg = torch.where(valid, state.replica_broker * D + state.replica_disk, B * D)
    disk_load = segment_sum(
        torch.where(valid, load[:, Resource.DISK], 0.0), disk_seg, B * D + 1
    )[: B * D].reshape(B, D)

    return BrokerAggregates(
        broker_load=broker_load,
        broker_replica_count=broker_replica_count,
        broker_leader_count=broker_leader_count,
        broker_potential_nw_out=broker_potential_nw_out,
        broker_leader_bytes_in=broker_leader_bytes_in,
        broker_topic_count=broker_topic_count,
        part_rack_count=part_rack_count,
        disk_load=disk_load,
    )


def host_load(state: ClusterState, agg: BrokerAggregates) -> torch.Tensor:
    """f32[num_hosts, 4] — host-level utilization (CPU/NW are host resources,
    reference common/Resource.java:19-26, model/Host.java)."""
    H = state.shape.num_hosts
    return segment_sum(
        torch.where(state.broker_valid[:, None], agg.broker_load, 0.0),
        torch.where(state.broker_valid, state.broker_host, H),
        H + 1,
    )[:H]
