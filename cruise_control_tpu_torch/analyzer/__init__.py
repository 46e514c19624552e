"""Analyzer layer: goal framework + the annealing optimization engine."""

from cruise_control_tpu_torch.analyzer.engine import Engine, OptimizerConfig
from cruise_control_tpu_torch.analyzer.objective import (
    DEFAULT_CHAIN,
    GoalChain,
    balancedness_score,
)
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer, OptimizerResult
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS, OptimizationOptions
from cruise_control_tpu_torch.analyzer.prewarm import PrewarmStore
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal, extract_proposals
from cruise_control_tpu_torch.analyzer.scenario_eval import ScenarioEvaluator, ScenarioOutcome

__all__ = [
    "DEFAULT_CHAIN",
    "DEFAULT_OPTIONS",
    "Engine",
    "ExecutionProposal",
    "GoalChain",
    "GoalOptimizer",
    "OptimizationOptions",
    "OptimizerConfig",
    "OptimizerResult",
    "PrewarmStore",
    "ScenarioEvaluator",
    "ScenarioOutcome",
    "balancedness_score",
    "extract_proposals",
]
