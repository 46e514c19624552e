"""Hard capacity goals.

Reference: analyzer/goals/CapacityGoal.java:42 and its four subclasses,
ReplicaCapacityGoal.java, PotentialNwOutGoal.java.

Violations are dimensionless: excess utilization divided by total alive
capacity for that resource.  Host resources (CPU, NW) are checked at host
granularity when a host has more than one broker, broker granularity
otherwise (reference CapacityGoal host/broker split).
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.goals.base import Goal, alive_mask, count_rows, relu
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.models.aggregates import BrokerAggregates, segment_sum
from cruise_control_tpu_torch.models.state import ClusterState


class CapacityGoal(Goal):
    """Broker/host utilization below capacity * capacity_threshold for one resource."""

    hard = True

    def __init__(self, resource: Resource):
        self.resource = resource
        self.name = {
            Resource.CPU: "CpuCapacityGoal",
            Resource.NW_IN: "NetworkInboundCapacityGoal",
            Resource.NW_OUT: "NetworkOutboundCapacityGoal",
            Resource.DISK: "DiskCapacityGoal",
        }[resource]

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        r = int(self.resource)
        thresh = constraint.capacity_threshold[r]
        mask = alive_mask(state)
        cap = torch.where(mask, state.broker_capacity[:, r], 0.0)
        load = torch.where(mask, agg.broker_load[:, r], 0.0)
        scale = cap.sum() + 1e-12

        broker_excess = relu(load - thresh * cap)
        if self.resource.is_host_resource:
            H = state.shape.num_hosts
            hseg = torch.where(state.broker_valid, state.broker_host, H)
            brokers_per_host = segment_sum(mask.to(torch.int32), hseg, H + 1)[:H]
            h_load = segment_sum(load, hseg, H + 1)[:H]
            h_cap = segment_sum(cap, hseg, H + 1)[:H]
            host_excess = relu(h_load - thresh * h_cap)
            multi = brokers_per_host > 1
            # host granularity where hosts aggregate several brokers,
            # broker granularity otherwise (single-broker hosts coincide)
            host_term = torch.where(multi, host_excess, 0.0).sum()
            per_host_single = segment_sum(broker_excess, hseg, H + 1)[:H]
            broker_term = torch.where(~multi, per_host_single, 0.0).sum()
            return (host_term + broker_term) / scale
        return broker_excess.sum() / scale


class ReplicaCapacityGoal(Goal):
    """<= max.replicas.per.broker on every alive broker
    (reference analyzer/goals/ReplicaCapacityGoal.java)."""

    name = "ReplicaCapacityGoal"
    hard = True

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        mask = alive_mask(state)
        count = torch.where(mask, agg.broker_replica_count, 0)
        excess = relu((count - constraint.max_replicas_per_broker).to(torch.float32))
        n_valid = count_rows(state.replica_valid) + 1e-12
        return excess.sum() / n_valid


class PotentialNwOutGoal(Goal):
    """Potential (all-leader) NW-out under capacity threshold
    (reference analyzer/goals/PotentialNwOutGoal.java)."""

    name = "PotentialNwOutGoal"
    hard = False

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        r = int(Resource.NW_OUT)
        thresh = constraint.capacity_threshold[r]
        mask = alive_mask(state)
        cap = torch.where(mask, state.broker_capacity[:, r], 0.0)
        pot = torch.where(mask, agg.broker_potential_nw_out, 0.0)
        scale = cap.sum() + 1e-12
        return relu(pot - thresh * cap).sum() / scale


class OfflineReplicaGoal(Goal):
    """No replica may remain on a dead broker or dead logdir (the implicit
    hard requirement of the reference's verifier check BROKEN_BROKERS,
    analyzer/OptimizationVerifier.java).  Normalized by replica count."""

    name = "OfflineReplicaGoal"
    hard = True

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        dead_broker = ~state.broker_alive[state.replica_broker]
        dead_disk = ~state.disk_alive[state.replica_broker, state.replica_disk]
        bad = state.replica_valid & (dead_broker | dead_disk)
        n_valid = count_rows(state.replica_valid) + 1e-12
        return count_rows(bad) / n_valid
