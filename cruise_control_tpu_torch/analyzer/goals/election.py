"""PreferredLeaderElectionGoal (reference analyzer/goals/PreferredLeaderElectionGoal.java).

Leadership should sit on the preferred (pos == 0) replica of each partition
whenever that replica is on a healthy broker.  Violation = fraction of
partitions led by a non-preferred replica while the preferred one is
eligible.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.common.collectives import global_rows, gsum
from cruise_control_tpu_torch.models.aggregates import BrokerAggregates
from cruise_control_tpu_torch.models.state import ClusterState


class PreferredLeaderElectionGoal(Goal):
    name = "PreferredLeaderElectionGoal"
    hard = False

    def violation(self, state: ClusterState, agg: BrokerAggregates, constraint):
        preferred = state.replica_pos == 0
        eligible = state.broker_alive[state.replica_broker] & ~state.replica_offline
        # partition is violated if its preferred replica is eligible but not leader
        bad = state.replica_valid & preferred & eligible & ~state.replica_is_leader
        return gsum(bad).to(torch.float32) / max(global_rows(state.shape.P), 1)
