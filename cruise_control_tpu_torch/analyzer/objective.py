"""Scalarized goal-chain objective for the batched optimizer.

The reference optimizes goals sequentially by priority, letting every
already-optimized goal veto later moves (reference
analyzer/GoalOptimizer.java:437-461).  A batched annealer needs one scalar,
so the chain is encoded lexicographically:

  objective = sum_g  w_g * violation_g(state)  +  w_tie * sum_g score_g(state)

with w_g decaying geometrically in priority order and every hard goal
boosted by HARD_BOOST so no weighted sum of soft improvements can pay for a
hard violation.

The balancedness score reported to users mirrors reference
KafkaCruiseControlUtils.balancednessCostByGoal:511-537.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.goals import DEFAULT_GOAL_ORDER, GOALS_BY_NAME
from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.kernels.move_delta import round_bf16
from cruise_control_tpu_torch.models.aggregates import BrokerAggregates, compute_aggregates
from cruise_control_tpu_torch.models.state import ClusterState

#: weight multiplier separating hard goals from the soft chain
HARD_BOOST = 1e4
#: geometric decay between adjacent priorities
PRIORITY_DECAY = 0.5
#: weight of the continuous tiebreaker scores relative to the smallest
#: violation weight
TIE_WEIGHT = 1e-3
#: accepted values of score_dtype (config analyzer.precision.score.dtype)
SCORE_DTYPES = ("float32", "bfloat16")


def bf16_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of a vector taken element after element, rounded to
    bf16 once: what XLA:CPU makes of a bf16 `.sum()` (it keeps the
    products and the running sum in f32).  On the CPU the sum is numpy's
    sequential f32 sum; on CUDA PyTorch's prefix sum, which is
    deterministic."""
    if x.device.type == "cpu":
        total = torch.from_numpy(np.cumsum(x.numpy(), dtype=np.float32)[-1:])[0]
    else:
        total = torch.cumsum(x, 0)[-1]
    return round_bf16(total)


@dataclasses.dataclass(frozen=True)
class GoalChain:
    """An ordered, weighted goal list (the reference's `default.goals`)."""

    goals: tuple[Goal, ...]
    weights: tuple[float, ...]  # violation weight per goal, same order

    @staticmethod
    def from_names(
        names: list[str] | None = None,
        *,
        hard_boost: float = HARD_BOOST,
        decay: float = PRIORITY_DECAY,
    ) -> "GoalChain":
        names = list(names) if names is not None else list(DEFAULT_GOAL_ORDER)
        goals = tuple(GOALS_BY_NAME[n] for n in names)
        weights = []
        for rank, g in enumerate(goals):
            w = decay**rank
            if g.hard:
                w *= hard_boost
            weights.append(w)
        return GoalChain(goals=goals, weights=tuple(weights))

    def evaluate(
        self,
        state: ClusterState,
        agg: BrokerAggregates | None = None,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        *,
        score_dtype: str = "float32",
        weights: torch.Tensor | None = None,
    ):
        """Full evaluation: (scalar objective, violations[G], scores[G]) as
        f32 tensors on the state's device.  `weights`, the chain's weights
        as an f32[G] tensor on that device, saves a copy from the host (a
        captured CUDA graph may not make one).

        `score_dtype` (config analyzer.precision.score.dtype) sets the
        precision of the weighted objective sum only; the violations and
        scores stay f32.  "bfloat16" sums as the JAX package's compiled
        program does on XLA:CPU: the weights, violations and scores rounded
        to bf16, the products left in f32, each sum taken in f32 element
        after element and rounded to bf16 once (`bf16_sum`)."""
        if score_dtype not in SCORE_DTYPES:
            raise ValueError(f"score_dtype must be one of {SCORE_DTYPES}, got {score_dtype!r}")
        if agg is None:
            agg = compute_aggregates(state)
        violations = torch.stack([g.violation(state, agg, constraint) for g in self.goals])
        scores = torch.stack([g.score(state, agg, constraint) for g in self.goals])
        w = weights
        if w is None:
            w = torch.tensor(self.weights, dtype=torch.float32, device=violations.device)
        if score_dtype == "bfloat16":
            obj = (bf16_sum(round_bf16(w) * round_bf16(violations))
                   + TIE_WEIGHT * min(self.weights) * bf16_sum(round_bf16(scores)))
        else:
            obj = (w * violations).sum() + TIE_WEIGHT * min(self.weights) * scores.sum()
        return obj, violations, scores

    def hard_mask(self) -> np.ndarray:
        return np.asarray([g.hard for g in self.goals])

    def names(self) -> list[str]:
        return [g.name for g in self.goals]


def balancedness_score(
    violations: np.ndarray,
    chain: GoalChain,
    *,
    priority_weight: float = 1.1,
    strictness_weight: float = 1.5,
) -> float:
    """0-100 user-facing score (reference KafkaCruiseControlUtils.java:511-537):
    priority_weight^rank * (strictness_weight if hard) summed over violated
    goals, scaled to 100.  A goal is violated when its normalized violation
    exceeds 1e-6 (the f32 noise floor of a 500k-replica cluster is
    ~1e-8..1e-7)."""
    n = len(chain.goals)
    weights = np.array(
        [
            priority_weight ** (n - 1 - i) * (strictness_weight if g.hard else 1.0)
            for i, g in enumerate(chain.goals)
        ],
        np.float64,
    )
    total = weights.sum()
    violated = np.asarray(violations) > 1e-6
    return float(100.0 * (1.0 - weights[violated].sum() / total))


DEFAULT_CHAIN = GoalChain.from_names()
