"""Sample store persisted to Kafka topics — the warm-restart path.

Reference: monitor/sampling/KafkaSampleStore.java:117-128 persists
partition/broker metric samples to two Kafka topics
(`partition.metric.sample.store.topic` / broker variant) and replays them
on startup (SampleLoadingTask.java) so a restarted service regains its
windowed load model without waiting num.windows sampling rounds.

This implementation rides the same wire-protocol data plane as the metric
stream (kafka/transport.py): samples are packed into a compact binary
record (one per MetricSample) and produced in record batches; `load()`
fetches every partition from offset 0.

Topic identity: partition samples are keyed by topic NAME on the wire —
the in-memory dense topic ids are interned per process in first-seen order
(monitor builder / reporter sampler), so a raw id persisted before a
restart could point at a different topic afterwards.  `topic_name_fn` /
`topic_id_fn` translate id <-> name at the store boundary; the monitor
catalog's `ClusterCatalog.topic_id` is the natural `topic_id_fn` (O(1),
dict-backed — it is called once per replayed sample).

Record layout (little-endian):
  kind u8 (0=partition, 1=broker) | id i32 | partition i32 | time_ms i64 |
  n_values u16 | name_len u16 | topic_name utf8 | values f32[n]
"""

from __future__ import annotations

import struct
import time
from typing import Callable

import numpy as np

from cruise_control_tpu_torch.kafka.client import KafkaAdminClient
from cruise_control_tpu_torch.kafka.transport import KafkaMetricsConsumer, KafkaMetricsTransport
from cruise_control_tpu_torch.monitor.sampling import (
    BrokerEntity,
    MetricSample,
    PartitionEntity,
    SamplingResult,
)

_HEAD = struct.Struct("<BiiqHH")

PARTITION_SAMPLE_TOPIC = "__KafkaCruiseControlPartitionMetricSamples"
BROKER_SAMPLE_TOPIC = "__KafkaCruiseControlModelTrainingSamples"


class KafkaSampleStore:
    """SampleStore SPI over the two reference sample topics.

    topic_name_fn: dense topic id -> topic name (used at store time);
    topic_id_fn: topic name -> dense topic id in THIS process (load time).
    Both default to numeric passthrough, which is only safe when the
    process's topic interning is stable across restarts — pass real
    mappings (e.g. from the monitor's catalog) in production.
    """

    def __init__(
        self,
        client: KafkaAdminClient,
        *,
        partition_topic: str = PARTITION_SAMPLE_TOPIC,
        broker_topic: str = BROKER_SAMPLE_TOPIC,
        topic_name_fn: Callable[[int], str] | None = None,
        topic_id_fn: Callable[[str], int] | None = None,
        metric_def=None,
    ):
        from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF

        self.client = client
        self.topic_name_fn = topic_name_fn or str
        self.topic_id_fn = topic_id_fn or int
        self.metric_def = metric_def or KAFKA_METRIC_DEF
        # ensure the store topics exist (reference ensureTopicsCreated;
        # 36 = TOPIC_ALREADY_EXISTS is the normal warm-restart case)
        codes = client.create_topics(
            [(partition_topic, 4, 2), (broker_topic, 4, 2)]
        )
        bad = {t: c for t, c in codes.items() if c not in (0, 36)}
        if bad:
            raise RuntimeError(f"sample-store topic creation failed: {bad}")
        self._p_out = KafkaMetricsTransport(client, partition_topic, flush_every=5000)
        self._b_out = KafkaMetricsTransport(client, broker_topic, flush_every=5000)
        self._p_topic = partition_topic
        self._b_topic = broker_topic

    # ---- wire format ----

    def _pack(self, kind: int, a: int, b: int, time_ms: int, name: str, values) -> bytes:
        vals = np.asarray(values, np.float32)
        raw = name.encode()
        return (
            _HEAD.pack(kind, a, b, time_ms, vals.size, len(raw))
            + raw
            + vals.tobytes()
        )

    def _unpack(self, payload: bytes) -> MetricSample:
        kind, a, b, time_ms, n, name_len = _HEAD.unpack_from(payload)
        name = payload[_HEAD.size: _HEAD.size + name_len].decode()
        vals = np.frombuffer(
            payload, np.float32, count=n, offset=_HEAD.size + name_len
        )
        # samples persisted before a metric-def extension replay with the
        # OLD vector width — pad new metrics with zeros (and tolerate a
        # future shrink by truncating) so a warm restart survives upgrades
        m = self.metric_def.num_metrics
        if vals.size < m:
            vals = np.concatenate([vals, np.zeros(m - vals.size, np.float32)])
        elif vals.size > m:
            vals = vals[:m]
        if kind == 0:
            entity = PartitionEntity(self.topic_id_fn(name), b)
        else:
            entity = BrokerEntity(a)
        return MetricSample(entity, time_ms, vals)

    # ---- SampleStore SPI ----

    def store(self, result: SamplingResult) -> None:
        for s in result.partition_samples:
            self._p_out.send(self._pack(
                0, s.entity.topic, s.entity.partition, s.time_ms,
                self.topic_name_fn(s.entity.topic), s.values,
            ))
        for s in result.broker_samples:
            self._b_out.send(
                self._pack(1, s.entity.broker_id, -1, s.time_ms, "", s.values)
            )
        self._p_out.flush()
        self._b_out.flush()

    def load(self) -> list[SamplingResult]:
        """Replay everything persisted (reference SampleLoadingTask).

        Each poll issues one Fetch round (bounded bytes per partition), so a
        history larger than one round needs repeated polls — the reference's
        SampleLoadingTask likewise consumes to the log end, not one batch.
        """

        def drain(topic: str) -> list[MetricSample]:
            consumer = KafkaMetricsConsumer(self.client, topic)
            out: list[MetricSample] = []
            stalled = 0
            while True:
                batch = consumer.poll_records()
                if not batch:
                    # an empty round is log-end only if ListOffsets agrees —
                    # transient fetch errors (leader change, offset re-seek)
                    # also yield empty rounds mid-stream.  A partition that
                    # stays unreadable must not hang startup forever: after
                    # 10 stalled rounds return the partial history (the
                    # monitor re-samples what replay missed).
                    stalled += 1
                    if consumer.at_log_end() or stalled > 10:
                        return out
                    time.sleep(0.1 * stalled)
                    continue
                stalled = 0
                out.extend(self._unpack(r) for r in batch)

        parts = drain(self._p_topic)
        brokers = drain(self._b_topic)
        if not parts and not brokers:
            return []
        # one SamplingResult per distinct sample time window keeps the
        # aggregator's per-window sample counts faithful on replay
        by_time: dict[int, tuple[list, list]] = {}
        for s in parts:
            by_time.setdefault(s.time_ms, ([], []))[0].append(s)
        for s in brokers:
            by_time.setdefault(s.time_ms, ([], []))[1].append(s)
        return [
            SamplingResult(ps, bs) for _, (ps, bs) in sorted(by_time.items())
        ]

    def close(self) -> None:
        self._p_out.flush()
        self._b_out.flush()
