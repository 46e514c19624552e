"""Execution task state machine + tracker.

Reference: executor/ExecutionTask.java:26-40 (PENDING -> IN_PROGRESS ->
{COMPLETED, ABORTING -> ABORTED, DEAD}) and executor/ExecutionTaskTracker.java:25.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal


class TaskType(enum.Enum):
    """Reference ExecutionTask.TaskType."""

    INTER_BROKER_REPLICA_ACTION = "INTER_BROKER_REPLICA_ACTION"
    INTRA_BROKER_REPLICA_ACTION = "INTRA_BROKER_REPLICA_ACTION"
    LEADER_ACTION = "LEADER_ACTION"


class TaskState(enum.Enum):
    PENDING = "PENDING"
    IN_PROGRESS = "IN_PROGRESS"
    ABORTING = "ABORTING"
    ABORTED = "ABORTED"
    COMPLETED = "COMPLETED"
    DEAD = "DEAD"


_VALID_TRANSFER = {
    TaskState.PENDING: {TaskState.IN_PROGRESS},
    TaskState.IN_PROGRESS: {TaskState.ABORTING, TaskState.DEAD, TaskState.COMPLETED},
    TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
    TaskState.COMPLETED: set(),
    TaskState.DEAD: set(),
    TaskState.ABORTED: set(),
}


@dataclasses.dataclass
class ExecutionTask:
    """One unit of execution (reference executor/ExecutionTask.java:44)."""

    execution_id: int
    proposal: ExecutionProposal
    task_type: TaskType
    state: TaskState = TaskState.PENDING
    start_time_ms: int = -1
    end_time_ms: int = -1
    alert_time_ms: int = -1
    #: called with (task, new_state, now_ms) after every transition — the
    #: executor's durable-journal hook (executor/journal.py); excluded from
    #: equality/repr so tasks stay value-comparable in tests
    observer: Callable | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _transfer(self, target: TaskState, now_ms: int):
        if target not in _VALID_TRANSFER[self.state]:
            raise ValueError(f"invalid task transition {self.state} -> {target}")
        self.state = target
        if target == TaskState.IN_PROGRESS:
            self.start_time_ms = now_ms
        if target in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD):
            self.end_time_ms = now_ms
        if self.observer is not None:
            self.observer(self, target, now_ms)

    def in_progress(self, now_ms: int):
        self._transfer(TaskState.IN_PROGRESS, now_ms)

    def completed(self, now_ms: int):
        self._transfer(TaskState.COMPLETED, now_ms)

    def aborting(self, now_ms: int):
        self._transfer(TaskState.ABORTING, now_ms)

    def aborted(self, now_ms: int):
        self._transfer(TaskState.ABORTED, now_ms)

    def kill(self, now_ms: int):
        self._transfer(TaskState.DEAD, now_ms)

    @property
    def active(self) -> bool:
        return self.state in (TaskState.IN_PROGRESS, TaskState.ABORTING)

    def to_json(self) -> dict:
        return {
            "executionId": self.execution_id,
            "type": self.task_type.value,
            "state": self.state.value,
            "proposal": self.proposal.to_json(),
        }


class ExecutionTaskTracker:
    """Counts tasks by (type, state) + data-movement progress
    (reference executor/ExecutionTaskTracker.java:25).

    observer: installed on every tracked task (see ExecutionTask.observer)."""

    def __init__(self, observer: Callable | None = None):
        self._tasks: dict[int, ExecutionTask] = {}
        self._observer = observer

    def add(self, task: ExecutionTask):
        if self._observer is not None:
            task.observer = self._observer
        self._tasks[task.execution_id] = task

    def tasks(self, task_type: TaskType | None = None, state: TaskState | None = None):
        return [
            t
            for t in self._tasks.values()
            if (task_type is None or t.task_type == task_type)
            and (state is None or t.state == state)
        ]

    def count(self, task_type: TaskType | None = None, state: TaskState | None = None) -> int:
        return len(self.tasks(task_type, state))

    @property
    def finished(self) -> bool:
        return all(
            t.state in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD)
            for t in self._tasks.values()
        )

    def in_execution_data_bytes(self) -> float:
        return sum(
            t.proposal.inter_broker_data_to_move
            for t in self._tasks.values()
            if t.state == TaskState.IN_PROGRESS
            and t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION
        )

    def finished_data_bytes(self) -> float:
        return sum(
            t.proposal.inter_broker_data_to_move
            for t in self._tasks.values()
            if t.state in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD)
            and t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION
        )

    def status(self) -> dict:
        out: dict = {}
        for tt in TaskType:
            out[tt.value] = {
                st.value: self.count(tt, st) for st in TaskState if self.count(tt, st)
            }
        return out
