"""Raw metric records + wire serialization.

Reference: cruise-control-metrics-reporter metric/RawMetricType.java:27-80
(~56 types with BROKER/TOPIC/PARTITION scope and versioned serialization),
metric/CruiseControlMetric.java (classId + version wire format),
metric/MetricSerde.java (Kafka serde).

The wire format here is a compact little-endian struct mirroring the
reference's layout idea (class id byte, version byte, then fields) so a
heterogeneous stream of broker/topic/partition metrics can share one
topic/transport.
"""

from __future__ import annotations

import dataclasses
import enum
import struct


class MetricClassId(enum.IntEnum):
    """Reference CruiseControlMetric.MetricClassId."""

    BROKER_METRIC = 0
    TOPIC_METRIC = 1
    PARTITION_METRIC = 2


class MetricType(enum.IntEnum):
    """Raw metric taxonomy (reference metric/RawMetricType.java:27-80).

    Scope encoded by range: 0-39 broker, 40-49 topic, 50+ partition.
    """

    # broker scope
    ALL_TOPIC_BYTES_IN = 0
    ALL_TOPIC_BYTES_OUT = 1
    ALL_TOPIC_REPLICATION_BYTES_IN = 2
    ALL_TOPIC_REPLICATION_BYTES_OUT = 3
    ALL_TOPIC_PRODUCE_REQUEST_RATE = 4
    ALL_TOPIC_FETCH_REQUEST_RATE = 5
    ALL_TOPIC_MESSAGES_IN_PER_SEC = 6
    BROKER_CPU_UTIL = 7
    BROKER_PRODUCE_REQUEST_RATE = 8
    BROKER_CONSUMER_FETCH_REQUEST_RATE = 9
    BROKER_FOLLOWER_FETCH_REQUEST_RATE = 10
    BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT = 11
    BROKER_REQUEST_QUEUE_SIZE = 12
    BROKER_RESPONSE_QUEUE_SIZE = 13
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX = 14
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN = 15
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = 16
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = 17
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = 18
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = 19
    BROKER_PRODUCE_TOTAL_TIME_MS_MAX = 20
    BROKER_PRODUCE_TOTAL_TIME_MS_MEAN = 21
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX = 22
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN = 23
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX = 24
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN = 25
    BROKER_PRODUCE_LOCAL_TIME_MS_MAX = 26
    BROKER_PRODUCE_LOCAL_TIME_MS_MEAN = 27
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX = 28
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN = 29
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX = 30
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN = 31
    BROKER_LOG_FLUSH_RATE = 32
    BROKER_LOG_FLUSH_TIME_MS_MAX = 33
    BROKER_LOG_FLUSH_TIME_MS_MEAN = 34
    # topic scope
    TOPIC_BYTES_IN = 40
    TOPIC_BYTES_OUT = 41
    TOPIC_REPLICATION_BYTES_IN = 42
    TOPIC_REPLICATION_BYTES_OUT = 43
    TOPIC_PRODUCE_REQUEST_RATE = 44
    TOPIC_FETCH_REQUEST_RATE = 45
    TOPIC_MESSAGES_IN_PER_SEC = 46
    # partition scope
    PARTITION_SIZE = 50
    # broker scope, percentile latencies (reference serde v1 additions,
    # RawMetricType.java ids 43-62 — SlowBrokerFinder inputs); 60-79 is a
    # second broker-scope range so the earlier ranges stay stable
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH = 60
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_999TH = 61
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = 62
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = 63
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = 64
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = 65
    BROKER_PRODUCE_TOTAL_TIME_MS_50TH = 66
    BROKER_PRODUCE_TOTAL_TIME_MS_999TH = 67
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_50TH = 68
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_999TH = 69
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_50TH = 70
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_999TH = 71
    BROKER_PRODUCE_LOCAL_TIME_MS_50TH = 72
    BROKER_PRODUCE_LOCAL_TIME_MS_999TH = 73
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_50TH = 74
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH = 75
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_50TH = 76
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH = 77
    BROKER_LOG_FLUSH_TIME_MS_50TH = 78
    BROKER_LOG_FLUSH_TIME_MS_999TH = 79

    @property
    def is_broker_scope(self) -> bool:
        return self < 40 or 60 <= self < 80

    @property
    def is_topic_scope(self) -> bool:
        return 40 <= self < 50

    @property
    def is_partition_scope(self) -> bool:
        return 50 <= self < 60


_VERSION = 0


@dataclasses.dataclass(frozen=True)
class CruiseControlMetric:
    metric_type: MetricType
    time_ms: int
    broker_id: int
    value: float

    class_id = MetricClassId.BROKER_METRIC


@dataclasses.dataclass(frozen=True)
class BrokerMetric(CruiseControlMetric):
    class_id = MetricClassId.BROKER_METRIC


@dataclasses.dataclass(frozen=True)
class TopicMetric(CruiseControlMetric):
    topic: str = ""

    class_id = MetricClassId.TOPIC_METRIC


@dataclasses.dataclass(frozen=True)
class PartitionMetric(CruiseControlMetric):
    topic: str = ""
    partition: int = -1

    class_id = MetricClassId.PARTITION_METRIC


class MetricSerde:
    """Binary serde (reference metric/MetricSerde.java).

    Layout: class_id u8 | version u8 | metric_type u16 | time_ms i64 |
    broker_id i32 | value f64 [| topic_len u16 | topic utf8 [| partition i32]]
    """

    _HEAD = struct.Struct("<BBHqid")

    @classmethod
    def serialize(cls, m: CruiseControlMetric) -> bytes:
        head = cls._HEAD.pack(
            int(m.class_id), _VERSION, int(m.metric_type), m.time_ms, m.broker_id, m.value
        )
        if isinstance(m, PartitionMetric):
            t = m.topic.encode()
            return head + struct.pack("<H", len(t)) + t + struct.pack("<i", m.partition)
        if isinstance(m, TopicMetric):
            t = m.topic.encode()
            return head + struct.pack("<H", len(t)) + t
        return head

    @classmethod
    def deserialize(cls, data: bytes) -> CruiseControlMetric:
        class_id, version, mtype, time_ms, broker_id, value = cls._HEAD.unpack_from(data)
        if version > _VERSION:
            raise ValueError(f"unsupported metric version {version}")
        rest = data[cls._HEAD.size:]
        mt = MetricType(mtype)
        if class_id == MetricClassId.BROKER_METRIC:
            return BrokerMetric(mt, time_ms, broker_id, value)
        (tlen,) = struct.unpack_from("<H", rest)
        topic = rest[2: 2 + tlen].decode()
        if class_id == MetricClassId.TOPIC_METRIC:
            return TopicMetric(mt, time_ms, broker_id, value, topic=topic)
        (partition,) = struct.unpack_from("<i", rest, 2 + tlen)
        return PartitionMetric(mt, time_ms, broker_id, value, topic=topic, partition=partition)


# ---------------------------------------------------------------------------
# drop-in interop with the REFERENCE reporter plugin's wire format
# ---------------------------------------------------------------------------

#: our MetricType name at each reference RawMetricType id (index == id) —
#: transcribed from RawMetricType.java:27-97 (id, scope, version-since).
#: The names are identical by construction; only the id spaces differ.
_REFERENCE_TYPE_NAMES = (
    "ALL_TOPIC_BYTES_IN",                                   # 0  v1 BROKER
    "ALL_TOPIC_BYTES_OUT",                                  # 1  v1 BROKER
    "TOPIC_BYTES_IN",                                       # 2  v1 TOPIC
    "TOPIC_BYTES_OUT",                                      # 3  v1 TOPIC
    "PARTITION_SIZE",                                       # 4  v1 PARTITION
    "BROKER_CPU_UTIL",                                      # 5  v1 BROKER
    "ALL_TOPIC_REPLICATION_BYTES_IN",                       # 6
    "ALL_TOPIC_REPLICATION_BYTES_OUT",                      # 7
    "ALL_TOPIC_PRODUCE_REQUEST_RATE",                       # 8
    "ALL_TOPIC_FETCH_REQUEST_RATE",                         # 9
    "ALL_TOPIC_MESSAGES_IN_PER_SEC",                        # 10
    "TOPIC_REPLICATION_BYTES_IN",                           # 11
    "TOPIC_REPLICATION_BYTES_OUT",                          # 12
    "TOPIC_PRODUCE_REQUEST_RATE",                           # 13
    "TOPIC_FETCH_REQUEST_RATE",                             # 14
    "TOPIC_MESSAGES_IN_PER_SEC",                            # 15
    "BROKER_PRODUCE_REQUEST_RATE",                          # 16
    "BROKER_CONSUMER_FETCH_REQUEST_RATE",                   # 17
    "BROKER_FOLLOWER_FETCH_REQUEST_RATE",                   # 18
    "BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT",              # 19
    "BROKER_REQUEST_QUEUE_SIZE",                            # 20
    "BROKER_RESPONSE_QUEUE_SIZE",                           # 21
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX",             # 22
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN",            # 23
    "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX",      # 24
    "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN",     # 25
    "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX",      # 26
    "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN",     # 27
    "BROKER_PRODUCE_TOTAL_TIME_MS_MAX",                     # 28
    "BROKER_PRODUCE_TOTAL_TIME_MS_MEAN",                    # 29
    "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX",              # 30
    "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN",             # 31
    "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX",              # 32
    "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN",             # 33
    "BROKER_PRODUCE_LOCAL_TIME_MS_MAX",                     # 34
    "BROKER_PRODUCE_LOCAL_TIME_MS_MEAN",                    # 35
    "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX",              # 36
    "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN",             # 37
    "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX",              # 38
    "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN",             # 39
    "BROKER_LOG_FLUSH_RATE",                                # 40
    "BROKER_LOG_FLUSH_TIME_MS_MAX",                         # 41
    "BROKER_LOG_FLUSH_TIME_MS_MEAN",                        # 42
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH",            # 43 v5
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_999TH",           # 44 v5
    "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_50TH",     # 45
    "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_999TH",    # 46
    "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_50TH",     # 47
    "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_999TH",    # 48
    "BROKER_PRODUCE_TOTAL_TIME_MS_50TH",                    # 49
    "BROKER_PRODUCE_TOTAL_TIME_MS_999TH",                   # 50
    "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_50TH",             # 51
    "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_999TH",            # 52
    "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_50TH",             # 53
    "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_999TH",            # 54
    "BROKER_PRODUCE_LOCAL_TIME_MS_50TH",                    # 55
    "BROKER_PRODUCE_LOCAL_TIME_MS_999TH",                   # 56
    "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_50TH",             # 57
    "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH",            # 58
    "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_50TH",             # 59
    "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH",            # 60
    "BROKER_LOG_FLUSH_TIME_MS_50TH",                        # 61
    "BROKER_LOG_FLUSH_TIME_MS_999TH",                       # 62
)

_REF_TYPE_BY_ID = {i: MetricType[n] for i, n in enumerate(_REFERENCE_TYPE_NAMES)}
_REF_ID_BY_TYPE = {t: i for i, t in _REF_TYPE_BY_ID.items()}

_REFERENCE_METRIC_VERSION = 0


class ReferenceMetricSerde:
    """The REFERENCE reporter plugin's exact wire format (big-endian):

      class_id u8 | version u8 | raw_type u8 | time i64 | broker_id i32
        [| topic_len i32 | topic utf8 [| partition i32]] | value f64

    per metric/MetricSerde.java (class-id header byte) +
    BrokerMetric.java:30-41 / TopicMetric.java:37-52 /
    PartitionMetric.java:44-60 (field layouts; value LAST, unlike our
    native serde).  With this serde the service ingests records produced
    by the reference's in-broker plugin unchanged — the drop-in path for
    broker-internal metrics (request-handler idle ratio, queue sizes, the
    SlowBrokerFinder's percentile latencies) that no process-external
    sidecar can observe.

    deserialize returns None for an unknown class id, exactly like the
    reference's fromBytes (new metric class on old code -> skip).
    """

    @staticmethod
    def serialize(m: CruiseControlMetric) -> bytes:
        ref_id = _REF_ID_BY_TYPE.get(m.metric_type)
        if ref_id is None:
            raise ValueError(
                f"{m.metric_type.name} has no reference RawMetricType id"
            )
        head = struct.pack(
            ">BBBqi", int(m.class_id), _REFERENCE_METRIC_VERSION, ref_id,
            m.time_ms, m.broker_id,
        )
        if isinstance(m, PartitionMetric):
            t = m.topic.encode()
            return head + struct.pack(">i", len(t)) + t + struct.pack(
                ">id", m.partition, m.value
            )
        if isinstance(m, TopicMetric):
            t = m.topic.encode()
            return head + struct.pack(">i", len(t)) + t + struct.pack(">d", m.value)
        return head + struct.pack(">d", m.value)

    @staticmethod
    def deserialize(data: bytes) -> CruiseControlMetric | None:
        class_id = data[0]
        if class_id > max(MetricClassId):
            return None  # newer metric class than we know: skip (reference behavior)
        version, ref_id, time_ms, broker_id = struct.unpack_from(">BBqi", data, 1)
        if version > _REFERENCE_METRIC_VERSION:
            # a bumped record version may have changed the field layout —
            # skip the record rather than decode garbage; raising would
            # discard the entire already-drained poll batch
            return None
        mt = _REF_TYPE_BY_ID.get(ref_id)
        if mt is None:
            # a newer reporter plugin emitting a type we don't know yet —
            # skip the record (ids 43-62 were added exactly this way);
            # raising here would discard the whole drained batch
            return None
        off = 1 + struct.calcsize(">BBqi")
        if class_id == MetricClassId.BROKER_METRIC:
            (value,) = struct.unpack_from(">d", data, off)
            return BrokerMetric(mt, time_ms, broker_id, value)
        (tlen,) = struct.unpack_from(">i", data, off)
        off += 4
        topic = data[off: off + tlen].decode()
        off += tlen
        if class_id == MetricClassId.TOPIC_METRIC:
            (value,) = struct.unpack_from(">d", data, off)
            return TopicMetric(mt, time_ms, broker_id, value, topic=topic)
        partition, value = struct.unpack_from(">id", data, off)
        return PartitionMetric(
            mt, time_ms, broker_id, value, topic=topic, partition=partition
        )
