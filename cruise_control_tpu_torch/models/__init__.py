from cruise_control_tpu_torch.models.aggregates import BrokerAggregates, compute_aggregates, host_load
from cruise_control_tpu_torch.models.builder import (
    BrokerSpec,
    ClusterCatalog,
    ClusterModelBuilder,
    PartitionSpec,
    build_state_columnar,
    default_follower_load,
    pad_state,
    prewarm_state,
)
from cruise_control_tpu_torch.models.state import (
    DEFAULT_BUCKET_POLICY,
    DEVICE_CHECKS,
    ClusterShape,
    ClusterState,
    ShapeBucketPolicy,
    validate,
    validate_on_device,
)
from cruise_control_tpu_torch.models.stats import ClusterStats, compute_stats
from cruise_control_tpu_torch.models.whatif import HostState, LiveState

__all__ = [
    "BrokerAggregates",
    "BrokerSpec",
    "ClusterCatalog",
    "ClusterModelBuilder",
    "ClusterShape",
    "ClusterState",
    "ClusterStats",
    "DEFAULT_BUCKET_POLICY",
    "DEVICE_CHECKS",
    "HostState",
    "LiveState",
    "PartitionSpec",
    "ShapeBucketPolicy",
    "build_state_columnar",
    "compute_aggregates",
    "compute_stats",
    "default_follower_load",
    "host_load",
    "pad_state",
    "prewarm_state",
    "validate",
    "validate_on_device",
]
