"""Broker-level aggregate views of a ClusterState.

Every O(replicas) walk the reference performs inside goal hot loops
(reference: model/Broker.java trackedSortedReplicas) becomes one segment sum
here.  Aggregates are computed once per optimizer round and updated
incrementally by move deltas in between, so a candidate costs O(1) gathers.

Segment sums add into a buffer with one sentinel row past the end:
padding rows are routed there and sliced off, so no index ever leaves the
buffer.  On CUDA the aggregates come from two kernels
(kernels/group.py, kernels/refresh.py): the replica rows grouped by broker,
then every aggregate of a broker summed over its rows in row order; on the
CPU from the segment sums (the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.kernels.refresh import (
    AGG_FIELDS,
    HostGroups,
    refresh_aggregates,
    segment_sum,
)
from cruise_control_tpu_torch.models.state import ClusterState

__all__ = ["BrokerAggregates", "compute_aggregates", "empty_aggregates", "host_load", "segment_sum"]


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


def empty_aggregates(state: ClusterState) -> dict:
    """Uninitialized aggregate tensors of the state's shape, by field."""
    s = state.shape
    B, D = s.B, s.max_disks_per_broker
    f32, i32 = torch.float32, torch.int32
    shapes = dict(
        broker_load=((B, 4), f32), broker_replica_count=((B,), i32), broker_leader_count=((B,), i32),
        broker_potential_nw_out=((B,), f32), broker_leader_bytes_in=((B,), f32),
        broker_topic_count=((s.num_topics, B), i32), part_rack_count=((s.P, s.num_racks), i32),
        disk_load=((B, D), f32),
    )
    return {f: torch.empty(shape, dtype=dt, device=state.device) for f, (shape, dt) in shapes.items()}


def compute_aggregates(state: ClusterState, members: torch.Tensor | None = None) -> BrokerAggregates:
    """The state's aggregates.  `members` is the cluster's member table,
    which the card's kernel counts partition x rack cells from;
    `state.members` (built once per state) when None."""
    out = refresh_aggregates(state, state.replica_broker, state.replica_is_leader,
                             state.replica_disk, empty_aggregates(state), members=members)
    return BrokerAggregates(**{f: out[f] for f in AGG_FIELDS})


def host_load(state: ClusterState, agg: BrokerAggregates) -> torch.Tensor:
    """f32[num_hosts, 4] — host-level utilization (CPU/NW are host resources,
    reference common/Resource.java:19-26, model/Host.java)."""
    H = state.shape.num_hosts
    out = dict(broker_load=agg.broker_load.contiguous(),
               host_load=torch.empty((H, 4), dtype=torch.float32, device=state.device))
    hosts = HostGroups.of(state.broker_valid, state.broker_host, H)
    refresh_aggregates(state, state.replica_broker, state.replica_is_leader, state.replica_disk, out,
                       hosts=hosts, brokers=False)
    return out["host_load"]
