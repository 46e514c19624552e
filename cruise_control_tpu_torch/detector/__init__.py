"""Detector layer: anomaly detection + self-healing dispatch.

Reference: cruise-control/.../detector/ (AnomalyDetector.java, 5 detectors,
notifier/).
"""

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    DiskFailures,
    ExecutionStuck,
    GoalViolations,
    SlowBrokers,
    TopicPartitionSizeAnomaly,
    TopicReplicationFactorAnomaly,
)
from cruise_control_tpu_torch.detector.detector import (
    AnomalyDetector,
    AnomalyDetectorState,
    AnomalyRecord,
    SelfHealingActions,
)
from cruise_control_tpu_torch.detector.detectors import (
    BrokerFailureDetector,
    DiskFailureDetector,
    GoalViolationDetector,
    PartitionSizeAnomalyFinder,
    SlowBrokerFinder,
    TopicReplicationFactorAnomalyFinder,
)
from cruise_control_tpu_torch.detector.notifier import (
    Action,
    AnomalyNotificationResult,
    AnomalyNotifier,
    NoopNotifier,
    SelfHealingNotifier,
)
