"""Metrics reporter — broker-side metric emission (plugin analog).

Reference: cruise-control-metrics-reporter/ (CruiseControlMetricsReporter
runs INSIDE each Kafka broker, samples Yammer/Kafka metrics on an interval
and produces serialized records to the __CruiseControlMetrics topic).
"""

from cruise_control_tpu_torch.reporter.metrics import (
    BrokerMetric,
    CruiseControlMetric,
    MetricSerde,
    MetricType,
    PartitionMetric,
    TopicMetric,
)
from cruise_control_tpu_torch.reporter.reporter import (
    MetricsRegistrySnapshotter,
    MetricsReporter,
    MetricTransport,
    InMemoryTransport,
)
