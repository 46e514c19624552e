"""Topology goals: rack-awareness and intra-broker disk goals.

Reference: analyzer/goals/RackAwareGoal.java:43,
IntraBrokerDiskCapacityGoal.java, IntraBrokerDiskUsageDistributionGoal.java.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.goals.base import Goal, count_rows, relu
from cruise_control_tpu_torch.analyzer.goals.distribution import _band_violation
from cruise_control_tpu_torch.common.collectives import gsum
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.models.aggregates import BrokerAggregates
from cruise_control_tpu_torch.models.state import ClusterState


class RackAwareGoal(Goal):
    """No two replicas of a partition on the same rack
    (reference analyzer/goals/RackAwareGoal.java:43).

    Violation counts excess same-rack co-placements: the sum over
    (partition, rack) cells of max(0, count - 1), normalized by the replica
    count.
    """

    name = "RackAwareGoal"
    hard = True

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        excess = relu((agg.part_rack_count - 1).to(torch.float32))
        n_valid = count_rows(state.replica_valid) + 1e-12
        return gsum(excess) / n_valid


class IntraBrokerDiskCapacityGoal(Goal):
    """Per-logdir disk utilization under capacity threshold (JBOD)
    (reference analyzer/goals/IntraBrokerDiskCapacityGoal.java)."""

    name = "IntraBrokerDiskCapacityGoal"
    hard = True

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        thresh = constraint.capacity_threshold[int(Resource.DISK)]
        mask = state.disk_alive & (state.broker_valid & state.broker_alive)[:, None]
        cap = torch.where(mask, state.disk_capacity, 0.0)
        load = torch.where(mask, agg.disk_load, 0.0)
        scale = cap.sum() + 1e-12
        # load landing on a dead logdir is itself a violation
        dead_load = torch.where(~mask, agg.disk_load, 0.0)
        return (relu(load - thresh * cap).sum() + dead_load.sum()) / scale


class IntraBrokerDiskUsageDistributionGoal(Goal):
    """Balance utilization across a broker's logdirs
    (reference analyzer/goals/IntraBrokerDiskUsageDistributionGoal.java)."""

    name = "IntraBrokerDiskUsageDistributionGoal"
    hard = False

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        t = constraint.balance_threshold[int(Resource.DISK)]
        mask = state.disk_alive & (state.broker_valid & state.broker_alive)[:, None]
        cap = torch.where(mask, state.disk_capacity, 0.0)
        load = torch.where(mask, agg.disk_load, 0.0)
        # per-broker average utilization percentage across its alive disks
        b_load = load.sum(dim=1, keepdim=True)
        b_cap = cap.sum(dim=1, keepdim=True)
        avg_pct = b_load / (b_cap + 1e-12)
        upper = avg_pct * t * cap
        lower = avg_pct * max(0.0, 2.0 - t) * cap
        return _band_violation(load, mask, upper, lower, load.sum())
