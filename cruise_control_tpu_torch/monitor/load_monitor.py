"""LoadMonitor — sampling/aggregation orchestration + ClusterState generation.

Reference: monitor/LoadMonitor.java:81 — clusterModel():485-568 (metadata
refresh -> partition aggregation -> rack/broker creation with capacity
resolver -> per-partition load population -> bad-broker marking),
acquireForModelGeneration():390 (semaphore), meetCompletenessRequirements():616,
and monitor/task/LoadMonitorTaskRunner.java:33 (state machine
NOT_STARTED/RUNNING/SAMPLING/PAUSED/BOOTSTRAPPING/TRAINING/LOADING).

The generation step is the monitor's whole purpose: it turns the windowed
aggregation tensors + live topology into the array-encoded ClusterState
the optimizer consumes.  Everything up to the build is host-side numpy;
the build copies the state onto the monitor's device (`device=`, resolved
by `device.resolve_device`: the current CUDA device unless the caller
names another, and an error on a host without CUDA when none is named).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.models.builder import BrokerSpec
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.monitor.aggregator import (
    AggregationOptions,
    WindowedMetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.capacity import BrokerCapacityConfigResolver
from cruise_control_tpu_torch.monitor.completeness import (
    DEFAULT_REQUIREMENTS,
    ModelCompletenessRequirements,
)
from cruise_control_tpu_torch.monitor.cpu_model import follower_cpu_util_array
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF, MetricDef
from cruise_control_tpu_torch.monitor.topology import ClusterTopology, MetadataProvider


class MonitorState(enum.Enum):
    """Reference LoadMonitorTaskRunner.LoadMonitorTaskRunnerState."""

    NOT_STARTED = "NOT_STARTED"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    TRAINING = "TRAINING"
    LOADING = "LOADING"


class NotEnoughValidWindowsError(Exception):
    """Reference NotEnoughValidWindowsException."""


class BrokerCapacityEstimationError(Exception):
    """A request forbade capacity estimation but a broker's capacity could
    only be estimated (reference BrokerCapacityResolutionException +
    sanityCheckCapacityEstimation)."""


@dataclasses.dataclass(frozen=True)
class ModelGeneration:
    """(metadata generation, load/sample generation) pair
    (reference monitor/ModelGeneration.java)."""

    metadata_generation: int
    load_generation: int


class LoadMonitor:
    """Builds ClusterStates from aggregated samples + topology."""

    def __init__(
        self,
        metadata: MetadataProvider,
        capacity_resolver: BrokerCapacityConfigResolver,
        partition_aggregator: WindowedMetricSampleAggregator,
        *,
        metric_def: MetricDef = KAFKA_METRIC_DEF,
        max_concurrent_model_generations: int = 1,
        replica_capacity: int | None = None,
        regression=None,
        topic_filter=None,
        max_allowed_extrapolations: int = 5,
        cpu_weights: tuple[float, float, float] | None = None,
        bucket_policy=None,
        device=None,
    ):
        from cruise_control_tpu_torch.monitor.cpu_model import DEFAULT_CPU_WEIGHTS

        #: reference MonitorConfig max.allowed.extrapolations.per.partition —
        #: partitions whose windows extrapolate more than this are invalid
        self.max_allowed_extrapolations = max_allowed_extrapolations
        #: static follower-CPU coefficients (reference MonitorConfig
        #: {leader.network.inbound,leader.network.outbound,
        #: follower.network.inbound}.weight.for.cpu.util)
        self.cpu_weights = cpu_weights or DEFAULT_CPU_WEIGHTS
        self.metadata = metadata
        self.capacity_resolver = capacity_resolver
        self.partition_aggregator = partition_aggregator
        self.metric_def = metric_def
        #: optional str -> bool predicate; topics failing it are invisible
        #: to the cluster model (the service's OWN metrics/sample-store
        #: topics must not be modeled as workload — the reference processor
        #: skips its metrics topic the same way)
        self.topic_filter = topic_filter
        #: optional LinearRegressionModelParameters — once trained (via the
        #: task runner's /train flow) it replaces the static-coefficient
        #: follower-CPU estimate (reference ModelUtils.java:84)
        self.regression = regression
        #: optional models.state.ShapeBucketPolicy — built models are padded
        #: to bucketed shapes so the analyzer's compiled engines survive
        #: topology churn (config tpu.shape.bucket.*; None = exact shapes)
        self.bucket_policy = bucket_policy
        #: where cluster_model() builds the state (None = the current CUDA
        #: device; resolved at each build, so a monitor made on a host
        #: without CUDA raises only when asked for a model)
        self.device = device
        self._state = MonitorState.NOT_STARTED
        # reference acquireForModelGeneration():390 — semaphore bounding
        # concurrent model generations
        self._model_semaphore = threading.Semaphore(max_concurrent_model_generations)
        self._replica_capacity = replica_capacity
        self._generation_lock = threading.Lock()
        self._load_generation = 0
        self._paused_reason: str | None = None
        # metric column ids resolved once
        self._cpu_id = metric_def.metric_id("CPU_USAGE")
        self._disk_id = metric_def.metric_id("DISK_USAGE")
        self._nwin_id = metric_def.metric_id("LEADER_BYTES_IN")
        self._nwout_id = metric_def.metric_id("LEADER_BYTES_OUT")
        #: id<->name catalog of the most recent cluster_model() build
        self.last_catalog = None

    # ------------------------------------------------------------------

    @property
    def state(self) -> MonitorState:
        return self._state

    def start(self):
        self._state = MonitorState.RUNNING

    def pause(self, reason: str = "user request"):
        """Reference LoadMonitor.pauseMetricSampling."""
        self._state = MonitorState.PAUSED
        self._paused_reason = reason

    def resume(self):
        self._state = MonitorState.RUNNING
        self._paused_reason = None

    def acquire_for_model_generation(self, timeout_s: float = 600.0):
        """Context manager bounding concurrent model generations
        (reference acquireForModelGeneration:390)."""
        monitor = self

        class _Ctx:
            def __enter__(self):
                if not monitor._model_semaphore.acquire(timeout=timeout_s):
                    raise TimeoutError("could not acquire model-generation semaphore")
                return monitor

            def __exit__(self, *exc):
                monitor._model_semaphore.release()
                return False

        return _Ctx()

    # ------------------------------------------------------------------

    def meets_completeness_requirements(
        self, requirements: ModelCompletenessRequirements
    ) -> bool:
        """Reference meetCompletenessRequirements():616."""
        try:
            agg = self.partition_aggregator.aggregate(
                AggregationOptions(
                    min_valid_entity_ratio=requirements.min_monitored_partitions_percentage,
                    max_allowed_extrapolations_per_entity=self.max_allowed_extrapolations,
                )
            )
        except ValueError:
            return False
        enough_windows = (
            agg.completeness.valid_windows.size >= requirements.min_required_num_windows
        )
        enough_partitions = (
            agg.completeness.valid_entity_ratio
            >= requirements.min_monitored_partitions_percentage
        )
        return enough_windows and enough_partitions

    def cluster_model(
        self,
        requirements: ModelCompletenessRequirements = DEFAULT_REQUIREMENTS,
        *,
        allow_capacity_estimation: bool = True,
    ) -> ClusterState:
        """Generate the array-encoded cluster model
        (reference LoadMonitor.clusterModel():485-568; timed like its
        cluster-model-creation-timer sensor, LoadMonitor.java:100,510).

        Traced as the `monitor.cluster_model` span of whatever operation
        requested the model (the flight recorder's first pipeline stage) —
        the served (bucketed) shape and generation ride as attributes so a
        trace shows which compiled-engine bucket this build landed in."""
        from cruise_control_tpu_torch.common.sensors import REGISTRY
        from cruise_control_tpu_torch.common.trace import TRACER

        sensors = getattr(self, "sensors", None) or REGISTRY
        tracer = getattr(self, "tracer", None) or TRACER
        with sensors.timer("monitor.cluster-model-creation-timer").time():
            with tracer.span("monitor.cluster_model", component="monitor") as sp:
                state = self._cluster_model_impl(
                    requirements, allow_capacity_estimation=allow_capacity_estimation
                )
                s = state.shape
                sp.set(
                    brokers=s.B, partitions=s.P, replicas=s.R,
                    topics=s.num_topics, load_generation=self._load_generation,
                )
                return state

    def _cluster_model_impl(
        self,
        requirements: ModelCompletenessRequirements,
        *,
        allow_capacity_estimation: bool = True,
    ) -> ClusterState:
        topology = self.metadata.refresh()
        if self.topic_filter is not None:
            import dataclasses as _dc

            topology = _dc.replace(
                topology,
                partitions=tuple(
                    p for p in topology.partitions if self.topic_filter(p.topic)
                ),
            )
        agg = self.partition_aggregator.aggregate(
            AggregationOptions(
                min_valid_entity_ratio=requirements.min_monitored_partitions_percentage,
                max_allowed_extrapolations_per_entity=self.max_allowed_extrapolations,
            )
        )
        if agg.completeness.valid_windows.size < requirements.min_required_num_windows:
            raise NotEnoughValidWindowsError(
                f"{agg.completeness.valid_windows.size} valid windows < "
                f"required {requirements.min_required_num_windows}"
            )
        if (
            agg.completeness.valid_entity_ratio
            < requirements.min_monitored_partitions_percentage
        ):
            raise NotEnoughValidWindowsError(
                f"valid partition ratio {agg.completeness.valid_entity_ratio:.3f} < "
                f"required {requirements.min_monitored_partitions_percentage:.3f}"
            )
        state = self._build_state(
            topology, agg, allow_capacity_estimation=allow_capacity_estimation
        )
        with self._generation_lock:
            self._load_generation = agg.completeness.generation
        return state

    def model_generation(self) -> ModelGeneration:
        return ModelGeneration(
            metadata_generation=self.metadata.topology().generation,
            load_generation=self._load_generation,
        )

    # ------------------------------------------------------------------

    def _window_reduced_loads(self, agg) -> dict:
        """Reduce [E, W, M] window values to per-entity [4] loads.

        AVG-strategy resources average over valid windows; DISK (LATEST)
        takes the newest valid window (reference model/Load.expectedUtilizationFor,
        model/Load.java:84-118 — AVG vs LATEST per KafkaMetricDef strategy).
        The reduction itself is monitor/delta.py's `reduce_windowed_loads`
        — ONE implementation for the model build and the streaming
        controller's delta path, so the two cannot drift.
        """
        from cruise_control_tpu_torch.monitor.delta import reduce_windowed_loads

        # slice the 4 consumed metric columns FIRST: the reduction then
        # runs on [E, W, 4] instead of the full [E, W, M] tensor
        cols = [self._cpu_id, self._nwin_id, self._nwout_id, self._disk_id]
        return reduce_windowed_loads(agg.values[:, :, cols], agg.window_valid)

    def _build_state(
        self,
        topology: ClusterTopology,
        agg,
        *,
        allow_capacity_estimation: bool = True,
    ) -> ClusterState:
        loads = self._window_reduced_loads(agg)
        broker_specs = []
        for b in topology.brokers:
            info = self.capacity_resolver.capacity_for_broker(b.rack, b.host, b.broker_id)
            if not allow_capacity_estimation and info.estimation_info:
                # reference sanityCheckCapacityEstimation: requests that
                # forbid estimation fail loudly when any broker capacity is
                # an estimate rather than a resolved value
                raise BrokerCapacityEstimationError(
                    f"broker {b.broker_id} capacity is estimated "
                    f"({info.estimation_info}) and the request disallows "
                    "capacity estimation"
                )
            disk_caps = None
            bad_disks = None
            if info.disk_capacities:
                logdirs = b.logdirs or tuple(info.disk_capacities)
                disk_caps = [info.disk_capacities.get(d, 0.0) for d in logdirs]
                bad = set(b.offline_logdirs)
                bad_disks = [i for i, d in enumerate(logdirs) if d in bad] or None
            broker_specs.append(
                BrokerSpec(
                    b.broker_id,
                    rack=b.rack,
                    host=b.host,
                    capacity=np.asarray(info.capacity, np.float32),
                    disk_capacities=disk_caps,
                    alive=b.alive,
                    new_broker=b.is_new,
                    bad_disks=bad_disks,
                )
            )

        # columnar join: topology partitions -> aggregator entity rows.
        # Unmonitored partitions get zero load (reference populates only
        # monitored partitions; include_all_topics keeps them in the model).
        cols = topology.columns()
        part_keys = (cols.part_topic.astype(np.int64) << 32) | cols.part_num
        ekeys, erows = self.partition_aggregator.entity_key_rows()
        P = part_keys.size
        if ekeys.size:
            pos = np.minimum(np.searchsorted(ekeys, part_keys), ekeys.size - 1)
            monitored = ekeys[pos] == part_keys
            row_of_part = np.where(monitored, erows[pos], 0)
        else:
            monitored = np.zeros(P, bool)
            row_of_part = np.zeros(P, np.int64)
        leader_load = np.zeros((P, NUM_RESOURCES), np.float32)
        follower_load = np.zeros((P, NUM_RESOURCES), np.float32)
        if np.any(monitored):
            m_rows = row_of_part[monitored]
            ll = loads[m_rows]
            leader_load[monitored] = ll
            follower_load[monitored] = self.follower_loads(ll)

        from cruise_control_tpu_torch.models.builder import build_state_columnar

        state, catalog = build_state_columnar(
            broker_specs,
            cols,
            leader_load,
            follower_load,
            replica_capacity=self._replica_capacity,
            bucket_policy=self.bucket_policy,
            device=self.device,
        )
        self.last_catalog = catalog
        return state

    def follower_loads(self, loads: np.ndarray) -> np.ndarray:
        """[N, 4] follower twin of per-partition leader loads: NW_OUT
        zeroed, CPU the follower share (the trained regression when
        available, else the static coefficients) — ONE function for the
        model build and the streaming controller's in-place delta path,
        so the two can never disagree on follower semantics."""
        loads = np.asarray(loads, np.float32)
        if self.regression is not None and self.regression.trained:
            follower_cpu = self.regression.follower_cpu_array(loads)
        else:
            follower_cpu = follower_cpu_util_array(
                loads, loads[:, Resource.CPU], weights=self.cpu_weights
            )
        fl = loads.copy()
        fl[:, Resource.NW_OUT] = 0.0
        fl[:, Resource.CPU] = follower_cpu
        return fl

    # ------------------------------------------------------------------

    def monitor_state(self) -> dict:
        """STATE endpoint payload (reference LoadMonitorState)."""
        try:
            agg = self.partition_aggregator.aggregate()
            windows = agg.completeness.valid_windows.size
            ratio = agg.completeness.valid_entity_ratio
        except ValueError:
            windows, ratio = 0, 0.0
        return {
            "state": self._state.value,
            "reasonOfLatestPauseOrResume": self._paused_reason,
            "numValidWindows": int(windows),
            "monitoredPartitionsPercentage": round(float(ratio) * 100.0, 3),
            "numMonitoredPartitions": self.partition_aggregator.num_entities(),
            "loadGeneration": self._load_generation,
        }
