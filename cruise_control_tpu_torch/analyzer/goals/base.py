"""Goal interface (reference analyzer/goals/Goal.java:38).

A goal is two pure functions over tensor state:

  violation(state, agg, constraint) -> f32 scalar tensor
      Total amount by which the goal is violated; 0 means satisfied.  For
      hard goals a feasibility constraint the optimizer must drive to zero;
      for soft goals the primary objective term.

  score(state, agg, constraint) -> f32 scalar tensor
      Continuous badness (utilization dispersion) minimized as a
      tiebreaker once violations are gone.

Goals are stateless and registered under the reference's names.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.common.collectives import gsum
from cruise_control_tpu_torch.config.balancing import BalancingConstraint
from cruise_control_tpu_torch.models.aggregates import BrokerAggregates
from cruise_control_tpu_torch.models.state import ClusterState


class Goal:
    """Base goal: zero violation, zero score."""

    #: registry name; matches the reference's class name where one exists
    name: str = "Goal"
    #: hard goals gate feasibility (reference Goal.isHardGoal)
    hard: bool = False

    def violation(
        self, state: ClusterState, agg: BrokerAggregates, constraint: BalancingConstraint
    ) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=state.device)

    def score(
        self, state: ClusterState, agg: BrokerAggregates, constraint: BalancingConstraint
    ) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=state.device)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}(name={self.name!r}, hard={self.hard})"


def alive_mask(state: ClusterState) -> torch.Tensor:
    return state.broker_valid & state.broker_alive


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def count_f32(mask: torch.Tensor) -> torch.Tensor:
    """Number of set entries as an f32 scalar."""
    return mask.sum().to(torch.float32)


def count_rows(mask: torch.Tensor) -> torch.Tensor:
    """`count_f32` of a replica- or partition-row mask, which the
    sharded-model mode holds a block of on each shard: summed over the
    model axis under its scope (common/collectives.py), the plain count
    otherwise."""
    return gsum(mask).to(torch.float32)
