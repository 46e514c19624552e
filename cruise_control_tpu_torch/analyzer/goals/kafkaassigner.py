"""Kafka-assigner compatibility mode goals.

Reference: analyzer/kafkaassigner/KafkaAssignerEvenRackAwareGoal.java:41
(rack-aware placement that also spreads each replica position evenly over
brokers) and KafkaAssignerDiskUsageDistributionGoal.java:46 (disk balance).
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.goals.base import Goal, alive_mask, count_rows, relu
from cruise_control_tpu_torch.common.collectives import gsegment_sum, gsum
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.models.aggregates import BrokerAggregates
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.models.stats import exact_sqrt


class KafkaAssignerEvenRackAwareGoal(Goal):
    """Rack awareness + even per-position replica spread: (a) same-rack
    excess co-placement and (b) per-position broker-count imbalance beyond
    ceil(avg)."""

    name = "KafkaAssignerEvenRackAwareGoal"
    hard = True

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        # (a) rack-awareness term, identical to RackAwareGoal
        excess = relu((agg.part_rack_count - 1).to(torch.float32))
        n_valid = count_rows(state.replica_valid) + 1e-12
        out = gsum(excess) / n_valid

        # (b) per-position evenness: count replicas at position q per broker
        B = state.shape.B
        max_pos = 8  # positions above this are negligible tails
        pos = torch.clamp(state.replica_pos, max=max_pos - 1)
        seg = torch.where(
            state.replica_valid, pos * B + state.broker_segment_ids(), max_pos * B
        )
        counts = gsegment_sum(
            state.replica_valid.to(torch.int32), seg, max_pos * B + 1
        )[: max_pos * B].reshape(max_pos, B)
        mask = alive_mask(state)
        counts = torch.where(mask[None, :], counts, 0).to(torch.float32)
        n_alive = torch.clamp(mask.sum(), min=1)
        avg = counts.sum(dim=1, keepdim=True) / n_alive  # [max_pos, 1]
        over = relu(counts - torch.ceil(avg))
        return out + torch.where(mask[None, :], over, 0.0).sum() / n_valid


class KafkaAssignerDiskUsageDistributionGoal(Goal):
    """Disk utilization percentage within threshold of the mean
    (reference analyzer/kafkaassigner/KafkaAssignerDiskUsageDistributionGoal.java:46)."""

    name = "KafkaAssignerDiskUsageDistributionGoal"
    hard = False

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        r = int(Resource.DISK)
        t = constraint.balance_threshold[r]
        mask = alive_mask(state)
        pct = agg.broker_load[:, r] / (state.broker_capacity[:, r] + 1e-12)
        n = torch.clamp(mask.sum(), min=1)
        mean = torch.where(mask, pct, 0.0).sum() / n
        dev = t - 1.0  # threshold multiplier -> absolute pct deviation band
        over = relu(torch.where(mask, pct - (mean + dev), 0.0))
        under = relu(torch.where(mask, (mean - dev) - pct, 0.0))
        return (over + under).sum() / torch.clamp(mean * n, min=1e-9)

    def score(self, state: ClusterState, agg: BrokerAggregates, constraint):
        r = int(Resource.DISK)
        mask = alive_mask(state)
        pct = agg.broker_load[:, r] / (state.broker_capacity[:, r] + 1e-12)
        n = torch.clamp(mask.sum(), min=1)
        mean = torch.where(mask, pct, 0.0).sum() / n
        d = pct - mean
        var = torch.where(mask, d * d, 0.0).sum() / n
        return exact_sqrt(var) / (mean + 1e-12)
