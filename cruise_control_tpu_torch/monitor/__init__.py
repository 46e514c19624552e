"""Monitor layer: sampling, windowed aggregation, cluster-model generation.

Reference: cruise-control/.../monitor/ (LoadMonitor.java, sampling/,
metricdefinition/) + cruise-control-core aggregator.
"""

from cruise_control_tpu_torch.monitor.aggregator import (
    AggregationOptions,
    AggregationResult,
    Extrapolation,
    MetricSampleCompleteness,
    WindowedMetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.capacity import (
    BrokerCapacityInfo,
    FileCapacityResolver,
    FixedCapacityResolver,
)
from cruise_control_tpu_torch.monitor.completeness import (
    DEFAULT_REQUIREMENTS,
    ModelCompletenessRequirements,
)
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor,
    ModelGeneration,
    MonitorState,
    NotEnoughValidWindowsError,
)
from cruise_control_tpu_torch.monitor.metricdef import (
    KAFKA_METRIC_DEF,
    MetricDef,
    MetricScope,
    ValueComputingStrategy,
)
from cruise_control_tpu_torch.monitor.sampling import (
    BrokerEntity,
    FileSampleStore,
    InMemorySampleStore,
    MetricFetcherManager,
    MetricSample,
    MetricSampler,
    NoopSampleStore,
    PartitionEntity,
    SamplingResult,
)
from cruise_control_tpu_torch.monitor.topology import (
    BrokerNode,
    ClusterTopology,
    MetadataProvider,
    PartitionInfo,
    StaticMetadataProvider,
)
