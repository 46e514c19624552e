"""Synthetic workload generation against a ClusterTopology.

Plays the role the embedded-cluster harness plays in the reference tests
(reference CCKafkaIntegrationTestHarness + CruiseControlMetricsReporter
producing real metrics): a MetricSampler implementation that fabricates
plausible per-partition metric samples so the whole monitor -> analyzer ->
executor -> detector pipeline can run without a Kafka cluster.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF, MetricDef
from cruise_control_tpu_torch.monitor.sampling import (
    BrokerEntity,
    MetricSample,
    PartitionEntity,
    SamplingResult,
)
from cruise_control_tpu_torch.monitor.topology import ClusterTopology


@dataclasses.dataclass
class WorkloadSpec:
    mean_cpu: float = 1.0
    mean_nw_in: float = 200.0
    mean_nw_out: float = 240.0
    mean_disk: float = 1000.0
    deviation: float = 0.3  # lognormal sigma across partitions
    jitter: float = 0.05  # per-sample noise
    #: per-topic multipliers to create hot topics
    topic_multipliers: dict[str, float] = dataclasses.field(default_factory=dict)


class SyntheticWorkloadSampler:
    """Deterministic per-partition workload with per-sample jitter."""

    def __init__(
        self,
        topology: ClusterTopology,
        spec: WorkloadSpec | None = None,
        *,
        metric_def: MetricDef = KAFKA_METRIC_DEF,
        seed: int = 0,
    ):
        self.topology = topology
        self.spec = spec or WorkloadSpec()
        self.metric_def = metric_def
        self._rng = np.random.default_rng(seed)
        self._topic_ids: dict[str, int] = {}
        for p in topology.partitions:
            self._topic_ids.setdefault(p.topic, len(self._topic_ids))
        # per-partition base rates, fixed at construction
        self._base: dict[tuple[int, int], np.ndarray] = {}
        s = self.spec
        for p in topology.partitions:
            mult = s.topic_multipliers.get(p.topic, 1.0)
            base = np.array(
                [s.mean_cpu, s.mean_nw_in, s.mean_nw_out, s.mean_disk], np.float64
            ) * mult * np.exp(self._rng.normal(0.0, s.deviation, 4))
            self._base[(self._topic_ids[p.topic], p.partition)] = base

    def topic_id(self, topic: str) -> int:
        return self._topic_ids[topic]

    def get_samples(self, assigned_partitions, start_ms: int, end_ms: int) -> SamplingResult:
        m = self.metric_def
        cpu = m.metric_id("CPU_USAGE")
        nwin = m.metric_id("LEADER_BYTES_IN")
        nwout = m.metric_id("LEADER_BYTES_OUT")
        disk = m.metric_id("DISK_USAGE")
        rep_in = m.metric_id("REPLICATION_BYTES_IN_RATE")
        t = (start_ms + end_ms) // 2
        samples = []
        for e in assigned_partitions:
            base = self._base.get((e.topic, e.partition))
            if base is None:
                continue
            noise = np.exp(self._rng.normal(0.0, self.spec.jitter, 4))
            vals = np.zeros(m.num_metrics, np.float32)
            vals[cpu] = base[0] * noise[0]
            vals[nwin] = base[1] * noise[1]
            vals[nwout] = base[2] * noise[2]
            vals[disk] = base[3] * noise[3]
            samples.append(MetricSample(e, t, vals))
        # per-broker samples with CPU linear in byte rates — gives the
        # /train regression a learnable ground truth (reference: the broker
        # reporter emits BrokerMetricSamples the TrainingTask harvests).
        # Only the ASSIGNED partitions contribute, so sub-batch fetches
        # don't double-count broker rates.
        assigned = {(e.topic, e.partition) for e in assigned_partitions}
        broker_samples = []
        per_broker: dict[int, np.ndarray] = {}
        for p in self.topology.partitions:
            key = (self._topic_ids[p.topic], p.partition)
            if key not in assigned:
                continue
            base = self._base.get(key)
            if base is None:
                continue
            for b in p.replicas:
                row = per_broker.setdefault(b, np.zeros(3, np.float64))
                if b == p.leader:
                    row[0] += base[1]  # leader bytes in
                    row[1] += base[2]  # leader bytes out
                else:
                    row[2] += base[1]  # replication (follower) bytes in
        for b, (lbin, lbout, fbin) in sorted(per_broker.items()):
            vals = np.zeros(m.num_metrics, np.float32)
            noise = float(np.exp(self._rng.normal(0.0, self.spec.jitter)))
            vals[nwin] = lbin
            vals[nwout] = lbout
            vals[rep_in] = fbin
            vals[cpu] = (2e-4 * lbin + 5e-5 * lbout + 1e-4 * fbin) * noise
            broker_samples.append(MetricSample(BrokerEntity(b), t, vals))
        return SamplingResult(samples, broker_samples)

    def drift(self, factor: float, topic: str | None = None) -> None:
        """Scale the per-partition base rates in place — a deterministic
        load trend for streaming-controller tests and `bench.py
        --streaming` (real clusters drift between metric windows; the
        static base would make every window's delta zero)."""
        tid = None if topic is None else self._topic_ids.get(topic)
        for (t, _p), base in self._base.items():
            if tid is None or t == tid:
                base *= factor

    def all_partition_entities(self) -> list[PartitionEntity]:
        return [
            PartitionEntity(self._topic_ids[p.topic], p.partition)
            for p in self.topology.partitions
        ]


def synthetic_topology(
    num_brokers: int = 6,
    num_racks: int = 3,
    topics: dict[str, int] | None = None,
    replication: int = 2,
    *,
    dead_brokers: tuple[int, ...] = (),
    seed: int = 0,
) -> ClusterTopology:
    """Small random topology for integration-style tests."""
    from cruise_control_tpu_torch.monitor.topology import BrokerNode, PartitionInfo

    rng = np.random.default_rng(seed)
    topics = topics or {"T0": 8, "T1": 8}
    brokers = tuple(
        BrokerNode(
            i,
            rack=f"r{i % num_racks}",
            host=f"h{i}",
            alive=i not in dead_brokers,
        )
        for i in range(num_brokers)
    )
    parts = []
    for t, n in topics.items():
        for p in range(n):
            reps = rng.choice(num_brokers, size=min(replication, num_brokers), replace=False)
            parts.append(
                PartitionInfo(t, p, leader=int(reps[0]), replicas=tuple(int(x) for x in reps))
            )
    return ClusterTopology(brokers=brokers, partitions=tuple(parts))
