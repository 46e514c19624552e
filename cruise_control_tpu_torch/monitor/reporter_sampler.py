"""Sampler that consumes the metrics-reporter stream.

Reference: monitor/sampling/CruiseControlMetricsReporterSampler.java:41
(poll loop over __CruiseControlMetrics) +
CruiseControlMetricsProcessor.java (raw broker/topic/partition metrics ->
PartitionMetricSample / BrokerMetricSample, including CPU attribution:
broker CPU is apportioned to leader partitions by their share of the
broker's produce/fetch bytes).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF, MetricDef
from cruise_control_tpu_torch.monitor.sampling import (
    BrokerEntity,
    MetricSample,
    PartitionEntity,
    SamplingResult,
)
from cruise_control_tpu_torch.monitor.topology import ClusterTopology
from cruise_control_tpu_torch.reporter.metrics import (
    BrokerMetric,
    MetricType,
    PartitionMetric,
    TopicMetric,
)
from cruise_control_tpu_torch.reporter.reporter import InMemoryTransport

# raw broker metric -> aggregate broker metric name (KafkaMetricDef)
_BROKER_METRIC_MAP = {
    MetricType.BROKER_PRODUCE_REQUEST_RATE: "BROKER_PRODUCE_REQUEST_RATE",
    MetricType.BROKER_CONSUMER_FETCH_REQUEST_RATE: "BROKER_CONSUMER_FETCH_REQUEST_RATE",
    MetricType.BROKER_FOLLOWER_FETCH_REQUEST_RATE: "BROKER_FOLLOWER_FETCH_REQUEST_RATE",
    MetricType.BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT: "BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT",
    MetricType.BROKER_REQUEST_QUEUE_SIZE: "BROKER_REQUEST_QUEUE_SIZE",
    MetricType.BROKER_RESPONSE_QUEUE_SIZE: "BROKER_RESPONSE_QUEUE_SIZE",
    MetricType.BROKER_LOG_FLUSH_RATE: "BROKER_LOG_FLUSH_RATE",
    MetricType.BROKER_LOG_FLUSH_TIME_MS_MAX: "BROKER_LOG_FLUSH_TIME_MS_MAX",
    MetricType.BROKER_LOG_FLUSH_TIME_MS_MEAN: "BROKER_LOG_FLUSH_TIME_MS_MEAN",
    # slow-broker evidence + training inputs (reference
    # SlowBrokerFinder.java:99 byte rates and request latencies)
    MetricType.BROKER_PRODUCE_LOCAL_TIME_MS_MEAN: "BROKER_PRODUCE_LOCAL_TIME_MS_MEAN",
    MetricType.BROKER_PRODUCE_LOCAL_TIME_MS_MAX: "BROKER_PRODUCE_LOCAL_TIME_MS_MAX",
    MetricType.ALL_TOPIC_BYTES_IN: "LEADER_BYTES_IN",
    MetricType.ALL_TOPIC_BYTES_OUT: "LEADER_BYTES_OUT",
    MetricType.ALL_TOPIC_REPLICATION_BYTES_IN: "REPLICATION_BYTES_IN_RATE",
    MetricType.ALL_TOPIC_REPLICATION_BYTES_OUT: "REPLICATION_BYTES_OUT_RATE",
}
# percentile latencies (reference reporter ids 43-62): MetricType and
# KafkaMetricDef names coincide, so the map rows are mechanical
_BROKER_METRIC_MAP.update({
    mt: mt.name
    for mt in MetricType
    if mt.name.endswith(("_50TH", "_999TH"))
})


class CruiseControlMetricsReporterSampler:
    """MetricSampler over an InMemoryTransport (Kafka consumer in prod)."""

    #: the service's own topics never become workload samples (the
    #: reference CruiseControlMetricsProcessor skips its metrics topic)
    DEFAULT_EXCLUDED = r"^__(KafkaCruiseControl|CruiseControlMetrics).*"

    def __init__(
        self,
        transport: InMemoryTransport,
        topology_provider,
        *,
        metric_def: MetricDef = KAFKA_METRIC_DEF,
        topic_filter=None,
        allow_cpu_estimation: bool = True,
    ):
        """allow_cpu_estimation (reference MonitorConfig
        sampling.allow.cpu.capacity.estimation): when False, partitions on
        a broker that reported no CPU metric are NOT sampled at all — a
        byte-share CPU attribution against an unknown broker CPU would be
        an estimate the operator forbade."""
        import re

        self.transport = transport
        self.topology_provider = topology_provider
        self.metric_def = metric_def
        self.allow_cpu_estimation = allow_cpu_estimation
        if topic_filter is None:
            rx = re.compile(self.DEFAULT_EXCLUDED)
            topic_filter = lambda name: not rx.match(str(name))  # noqa: E731
        self.topic_filter = topic_filter
        self._topic_ids: dict[str, int] = {}

    def _topic_id(self, topic: str) -> int:
        if topic not in self._topic_ids:
            # dense ids in first-seen order; the monitor's builder re-sorts
            self._topic_ids[topic] = len(self._topic_ids)
        return self._topic_ids[topic]

    def get_samples(self, assigned_partitions, start_ms: int, end_ms: int) -> SamplingResult:
        topo: ClusterTopology = self.topology_provider()
        m = self.metric_def
        cpu_id = m.metric_id("CPU_USAGE")
        disk_id = m.metric_id("DISK_USAGE")
        nwin_id = m.metric_id("LEADER_BYTES_IN")
        nwout_id = m.metric_id("LEADER_BYTES_OUT")

        part_size: dict[tuple[str, int], float] = {}
        topic_bytes_in: dict[tuple[int, str], float] = defaultdict(float)
        topic_bytes_out: dict[tuple[int, str], float] = defaultdict(float)
        broker_cpu: dict[int, float] = {}
        broker_values: dict[int, np.ndarray] = {}
        times: dict[int, int] = {}

        if getattr(self.transport, "framed_native", hasattr(self.transport, "poll_framed")):
            # columnar fast path: one native pass over the whole batch
            # (cruise_control_tpu_torch/native/serde.cpp), numpy masks instead of
            # a per-record object loop — the JVM sampler's hot loop analog
            from cruise_control_tpu_torch.native import batch_deserialize

            b = batch_deserialize(self.transport.poll_framed())
            if len(b):
                # latest report time per broker
                order = np.argsort(b.broker_ids, kind="stable")
                bids = b.broker_ids[order]
                tms = b.times_ms[order]
                uniq, starts = np.unique(bids, return_index=True)
                maxes = np.maximum.reduceat(tms, starts)
                times.update(
                    (int(u), int(t)) for u, t in zip(uniq, maxes)
                )
                part_mask = (b.class_ids == 2) & (
                    b.metric_types == int(MetricType.PARTITION_SIZE)
                )
                for i in np.nonzero(part_mask)[0]:
                    part_size[(b.topics[b.topic_ids[i]], int(b.partitions[i]))] = float(
                        b.values[i]
                    )
                for mask, store in (
                    ((b.class_ids == 1) & (b.metric_types == int(MetricType.TOPIC_BYTES_IN)),
                     topic_bytes_in),
                    ((b.class_ids == 1) & (b.metric_types == int(MetricType.TOPIC_BYTES_OUT)),
                     topic_bytes_out),
                ):
                    for i in np.nonzero(mask)[0]:
                        store[(int(b.broker_ids[i]), b.topics[b.topic_ids[i]])] = float(
                            b.values[i]
                        )
                broker_mask = b.class_ids == 0
                for i in np.nonzero(broker_mask)[0]:
                    mt = MetricType(int(b.metric_types[i]))
                    if mt == MetricType.BROKER_CPU_UTIL:
                        broker_cpu[int(b.broker_ids[i])] = float(b.values[i])
                    else:
                        name = _BROKER_METRIC_MAP.get(mt)
                        if name is not None:
                            v = broker_values.setdefault(
                                int(b.broker_ids[i]), np.zeros(m.num_metrics, np.float32)
                            )
                            v[m.metric_id(name)] = float(b.values[i])
        else:
            for r in self.transport.poll():
                times[r.broker_id] = max(times.get(r.broker_id, 0), r.time_ms)
                if isinstance(r, PartitionMetric) and r.metric_type == MetricType.PARTITION_SIZE:
                    part_size[(r.topic, r.partition)] = r.value
                elif isinstance(r, TopicMetric):
                    if r.metric_type == MetricType.TOPIC_BYTES_IN:
                        topic_bytes_in[(r.broker_id, r.topic)] = r.value
                    elif r.metric_type == MetricType.TOPIC_BYTES_OUT:
                        topic_bytes_out[(r.broker_id, r.topic)] = r.value
                elif isinstance(r, BrokerMetric):
                    if r.metric_type == MetricType.BROKER_CPU_UTIL:
                        broker_cpu[r.broker_id] = r.value
                    else:
                        name = _BROKER_METRIC_MAP.get(r.metric_type)
                        if name is not None:
                            v = broker_values.setdefault(
                                r.broker_id, np.zeros(m.num_metrics, np.float32)
                            )
                            v[m.metric_id(name)] = r.value

        # leader partitions per (broker, topic) for byte attribution
        leaders: dict[tuple[int, str], list] = defaultdict(list)
        for p in topo.partitions:
            if self.topic_filter(p.topic):
                leaders[(p.leader, p.topic)].append(p)

        # each broker's bytes-in over its topics, summed in the stream's
        # order, once: the JAX package's copy re-scans every (broker, topic)
        # key for each pair, which is quadratic in the pairs (~10^10 steps
        # at 2,600 brokers x 200 topics); the sums are the same bits
        broker_total_in: dict[int, float] = {}
        for (b2, _t2), v in topic_bytes_in.items():
            broker_total_in[b2] = broker_total_in.get(b2, 0) + v

        t_mid = (start_ms + end_ms) // 2
        partition_samples: list[MetricSample] = []
        for (broker, topic), parts in leaders.items():
            tb_in = topic_bytes_in.get((broker, topic), 0.0)
            tb_out = topic_bytes_out.get((broker, topic), 0.0)
            sizes = np.array([part_size.get((topic, p.partition), 0.0) for p in parts])
            if tb_in == 0.0 and tb_out == 0.0 and sizes.sum() == 0.0:
                # nothing reported for this (broker, topic): emitting zero
                # samples would poison the windows as real measurements
                continue
            total = sizes.sum()
            shares = sizes / total if total > 0 else np.full(len(parts), 1.0 / max(len(parts), 1))
            # CPU attribution: broker CPU split across leader partitions by
            # their byte share (reference CruiseControlMetricsProcessor)
            if not self.allow_cpu_estimation and broker not in broker_cpu:
                continue
            b_cpu = broker_cpu.get(broker, 0.0)
            b_total_in = broker_total_in.get(broker, 0)
            for p, share in zip(parts, shares):
                vals = np.zeros(m.num_metrics, np.float32)
                vals[disk_id] = part_size.get((topic, p.partition), 0.0)
                vals[nwin_id] = tb_in * share
                vals[nwout_id] = tb_out * share
                if b_total_in > 0:
                    vals[cpu_id] = b_cpu * (tb_in * share) / b_total_in
                partition_samples.append(
                    MetricSample(
                        PartitionEntity(self._topic_id(topic), p.partition), t_mid, vals
                    )
                )

        broker_samples = [
            MetricSample(BrokerEntity(b), times.get(b, t_mid), v)
            for b, v in broker_values.items()
        ]
        return SamplingResult(partition_samples, broker_samples)
