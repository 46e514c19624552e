"""Executor layer: proposal execution with throttling and progress tracking.

Reference: cruise-control/.../executor/ (Executor.java, ExecutionTaskPlanner.java,
strategy/, ReplicationThrottleHelper.java) + the Scala ZK bridge
(ExecutorUtils.scala), replaced by the ClusterAdmin SPI.
"""

from cruise_control_tpu_torch.executor.admin import (
    ClusterAdmin,
    LeadershipSpec,
    ReassignmentSpec,
    SimulatedClusterAdmin,
)
from cruise_control_tpu_torch.executor.executor import (
    ConcurrencyAdjuster,
    ExecutionOptions,
    ExecutionResult,
    Executor,
    ExecutorState,
    NoOngoingExecutionError,
    OngoingExecutionError,
)
from cruise_control_tpu_torch.executor.journal import ExecutionJournal
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import (
    STRATEGIES_BY_NAME,
    BaseReplicaMovementStrategy,
    PostponeUrpReplicaMovementStrategy,
    PrioritizeLargeReplicaMovementStrategy,
    PrioritizeSmallReplicaMovementStrategy,
    ReplicaMovementStrategy,
)
from cruise_control_tpu_torch.executor.tasks import (
    ExecutionTask,
    ExecutionTaskTracker,
    TaskState,
    TaskType,
)
from cruise_control_tpu_torch.executor.throttle import ReplicationThrottleHelper
