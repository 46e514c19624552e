"""Metric definitions for monitoring.

Reference: cruise-control-core metricdef/MetricDef.java + MetricInfo.java
(registry with AVG/MAX/LATEST value-computing strategies) and
monitor/metricdefinition/KafkaMetricDef.java:42-135 (the Kafka taxonomy,
COMMON vs BROKER_ONLY scopes, resource attribution).

Array consequence: a MetricDef is the index space of the metric axis in
the windowed aggregation tensors ([entities, windows, metrics]) — each
MetricInfo's `id` is its column.
"""

from __future__ import annotations

import dataclasses
import enum

from cruise_control_tpu_torch.common.resources import Resource


class ValueComputingStrategy(enum.Enum):
    """How multiple samples within one window combine
    (reference metricdef/ValueComputingStrategy.java)."""

    AVG = "avg"
    MAX = "max"
    LATEST = "latest"


class MetricScope(enum.Enum):
    """COMMON metrics exist per partition AND per broker; BROKER_ONLY only
    per broker (reference KafkaMetricDef.DefScope, KafkaMetricDef.java:265)."""

    COMMON = "common"
    BROKER_ONLY = "broker_only"


@dataclasses.dataclass(frozen=True)
class MetricInfo:
    name: str
    id: int
    strategy: ValueComputingStrategy
    scope: MetricScope
    resource: Resource | None  # which balanced resource it attributes to
    to_predict: bool = False  # input to the CPU estimation model


class MetricDef:
    """Ordered metric registry (reference metricdef/MetricDef.java)."""

    def __init__(self):
        self._by_name: dict[str, MetricInfo] = {}
        self._infos: list[MetricInfo] = []

    def define(
        self,
        name: str,
        strategy: ValueComputingStrategy,
        scope: MetricScope = MetricScope.COMMON,
        resource: Resource | None = None,
        to_predict: bool = False,
    ) -> "MetricDef":
        if name in self._by_name:
            raise ValueError(f"metric {name} already defined")
        info = MetricInfo(name, len(self._infos), strategy, scope, resource, to_predict)
        self._by_name[name] = info
        self._infos.append(info)
        return self

    def info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def metric_id(self, name: str) -> int:
        return self._by_name[name].id

    @property
    def num_metrics(self) -> int:
        return len(self._infos)

    def all_infos(self) -> list[MetricInfo]:
        return list(self._infos)

    def resource_metric_ids(self, resource: Resource) -> list[int]:
        return [m.id for m in self._infos if m.resource == resource]

    def common_metric_ids(self) -> list[int]:
        return [m.id for m in self._infos if m.scope == MetricScope.COMMON]


def kafka_metric_def() -> MetricDef:
    """The Kafka metric taxonomy (reference KafkaMetricDef.java:44-80).

    Column order mirrors the reference declaration order so serialized
    sample payloads stay comparable.
    """
    AVG = ValueComputingStrategy.AVG
    LATEST = ValueComputingStrategy.LATEST
    C, B = MetricScope.COMMON, MetricScope.BROKER_ONLY
    d = MetricDef()
    d.define("CPU_USAGE", AVG, C, Resource.CPU, to_predict=True)
    d.define("DISK_USAGE", LATEST, C, Resource.DISK)
    d.define("LEADER_BYTES_IN", AVG, C, Resource.NW_IN)
    d.define("LEADER_BYTES_OUT", AVG, C, Resource.NW_OUT)
    d.define("PRODUCE_RATE", AVG, C)
    d.define("FETCH_RATE", AVG, C)
    d.define("MESSAGE_IN_RATE", AVG, C)
    d.define("REPLICATION_BYTES_IN_RATE", AVG, C, Resource.NW_IN)
    d.define("REPLICATION_BYTES_OUT_RATE", AVG, C, Resource.NW_OUT)
    for name in (
        "BROKER_PRODUCE_REQUEST_RATE",
        "BROKER_CONSUMER_FETCH_REQUEST_RATE",
        "BROKER_FOLLOWER_FETCH_REQUEST_RATE",
        "BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT",
        "BROKER_REQUEST_QUEUE_SIZE",
        "BROKER_RESPONSE_QUEUE_SIZE",
        "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX",
        "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN",
        "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX",
        "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN",
        "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX",
        "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN",
        "BROKER_PRODUCE_TOTAL_TIME_MS_MAX",
        "BROKER_PRODUCE_TOTAL_TIME_MS_MEAN",
        "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX",
        "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN",
        "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX",
        "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN",
        "BROKER_PRODUCE_LOCAL_TIME_MS_MAX",
        "BROKER_PRODUCE_LOCAL_TIME_MS_MEAN",
        "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX",
        "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN",
        "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX",
        "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN",
        "BROKER_LOG_FLUSH_RATE",
        "BROKER_LOG_FLUSH_TIME_MS_MAX",
        "BROKER_LOG_FLUSH_TIME_MS_MEAN",
        # percentile latencies (reference KafkaMetricDef BROKER_ONLY v5
        # additions; SlowBrokerFinder evidence) — ingested from the
        # reference reporter plugin's RawMetricType ids 43-62
        "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH",
        "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_999TH",
        "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_50TH",
        "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_999TH",
        "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_50TH",
        "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_999TH",
        "BROKER_PRODUCE_TOTAL_TIME_MS_50TH",
        "BROKER_PRODUCE_TOTAL_TIME_MS_999TH",
        "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_50TH",
        "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_999TH",
        "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_50TH",
        "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_999TH",
        "BROKER_PRODUCE_LOCAL_TIME_MS_50TH",
        "BROKER_PRODUCE_LOCAL_TIME_MS_999TH",
        "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_50TH",
        "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH",
        "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_50TH",
        "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH",
        "BROKER_LOG_FLUSH_TIME_MS_50TH",
        "BROKER_LOG_FLUSH_TIME_MS_999TH",
    ):
        d.define(name, AVG, B)
    return d


KAFKA_METRIC_DEF = kafka_metric_def()
