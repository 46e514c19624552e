"""Operation progress tracking for async operations.

Reference: async/progress/OperationProgress.java + OperationStep.java and
the concrete steps (Pending, RetrievingMetrics, WaitingForClusterModel,
GeneratingClusterModel with % complete, OptimizationForGoal,
WaitingForOngoingExecutionToStop).  Surfaced through 202 responses while
an operation runs (SURVEY §5 tracing).
"""

from __future__ import annotations

import threading
import time


class OperationStep:
    def __init__(self, description: str):
        self._description = description
        self._start = time.time()
        self._done_pct = 0.0

    @property
    def description(self) -> str:
        return self._description

    def completeness(self) -> float:
        return self._done_pct

    def set_completeness(self, pct: float):
        self._done_pct = min(1.0, max(0.0, pct))

    def done(self):
        self._done_pct = 1.0


class Pending(OperationStep):
    def __init__(self):
        super().__init__("OPERATION IS PENDING")


class RetrievingMetrics(OperationStep):
    def __init__(self):
        super().__init__("RETRIEVING METRICS")


class WaitingForClusterModel(OperationStep):
    def __init__(self):
        super().__init__("WAITING FOR CLUSTER MODEL")


class GeneratingClusterModel(OperationStep):
    def __init__(self):
        super().__init__("GENERATING CLUSTER MODEL")


class OptimizationForGoal(OperationStep):
    def __init__(self, goal_name: str):
        super().__init__(f"OPTIMIZING {goal_name}")


class BatchedOptimization(OperationStep):
    """TPU-specific: one step for the whole batched goal chain."""

    def __init__(self, round_count: int):
        super().__init__(f"BATCHED OPTIMIZATION ({round_count} ROUNDS)")


class WaitingForOngoingExecutionToStop(OperationStep):
    def __init__(self):
        super().__init__("WAITING FOR ONGOING EXECUTION TO STOP")


class ExecutingProposals(OperationStep):
    def __init__(self):
        super().__init__("EXECUTING PROPOSALS")


class OperationProgress:
    def __init__(self):
        self._steps: list[OperationStep] = []
        self._lock = threading.Lock()

    def add_step(self, step: OperationStep) -> OperationStep:
        with self._lock:
            if self._steps:
                self._steps[-1].done()
            self._steps.append(step)
        return step

    def refer_to(self, other: "OperationProgress"):
        """Share another operation's progress (reference
        OperationProgress.refer — used when ops join a cached computation)."""
        with self._lock:
            self._steps = other._steps

    def to_json(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "step": s.description,
                    "completionPercentage": round(100.0 * s.completeness(), 1),
                    "timeInMs": int((time.time() - s._start) * 1000),
                }
                for s in self._steps
            ]
