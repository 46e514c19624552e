"""Metric sampling framework: sampler SPI, fetcher, raw-metric processing.

Reference: monitor/sampling/MetricSampler.java (plugin SPI),
MetricFetcherManager.java:145 (scheduled fetch loops),
CruiseControlMetricsProcessor.java (raw broker/topic/partition metrics ->
partition & broker samples, incl. CPU attribution),
holder/PartitionMetricSample.java + BrokerMetricSample.java.

This package keeps sampling host-side (it is network I/O) but makes the
sample payloads dense arrays keyed by the MetricDef so they pour straight
into the windowed aggregation tensors.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Protocol

import numpy as np

from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF, MetricDef


@dataclasses.dataclass(frozen=True)
class PartitionEntity:
    """Aggregation entity for one partition; group = topic (reference
    monitor/sampling/PartitionEntity.java)."""

    topic: int
    partition: int

    @property
    def group(self):
        return self.topic


@dataclasses.dataclass(frozen=True)
class BrokerEntity:
    """Reference monitor/sampling/BrokerEntity.java."""

    broker_id: int


@dataclasses.dataclass(frozen=True)
class MetricSample:
    """One entity's metrics at one time (reference
    cruise-control-core monitor/sampling/MetricSample.java)."""

    entity: object
    time_ms: int
    values: np.ndarray  # f32[M] indexed by MetricDef ids


@dataclasses.dataclass(frozen=True)
class SamplingResult:
    partition_samples: list[MetricSample]
    broker_samples: list[MetricSample]


class MetricSampler(Protocol):
    """Pluggable sampler SPI (reference monitor/sampling/MetricSampler.java).

    Implementations fetch metrics for the assigned partitions between two
    timestamps — from the metrics-reporter topic, a REST endpoint, files,
    or synthetic generators in tests.
    """

    def get_samples(
        self, assigned_partitions: list[PartitionEntity], start_ms: int, end_ms: int
    ) -> SamplingResult:
        ...


class SampleStore(Protocol):
    """Persists samples for warm restart (reference KafkaSampleStore.java:117)."""

    def store(self, result: SamplingResult) -> None:
        ...

    def load(self) -> list[SamplingResult]:
        ...

    def close(self) -> None:
        ...


class NoopSampleStore:
    """Reference monitor/sampling/NoopSampleStore.java."""

    def store(self, result: SamplingResult) -> None:
        pass

    def load(self) -> list[SamplingResult]:
        return []

    def close(self) -> None:
        pass


class InMemorySampleStore:
    """Bounded in-memory store, useful for tests and single-process runs."""

    def __init__(self, max_results: int = 10_000):
        self._results: list[SamplingResult] = []
        self._max = max_results
        self._lock = threading.Lock()

    def store(self, result: SamplingResult) -> None:
        with self._lock:
            self._results.append(result)
            if len(self._results) > self._max:
                self._results = self._results[-self._max:]

    def load(self) -> list[SamplingResult]:
        with self._lock:
            return list(self._results)

    def close(self) -> None:
        pass


class FileSampleStore:
    """npz-file-backed store — the warm-restart path when there is no Kafka
    sample topic (role of reference KafkaSampleStore, storage swapped for
    local files)."""

    def __init__(self, path: str):
        import os

        self.path = path
        os.makedirs(path, exist_ok=True)
        self._n = len(self._files())

    def _files(self):
        import glob
        import os

        return sorted(glob.glob(os.path.join(self.path, "samples_*.npz")))

    def store(self, result: SamplingResult) -> None:
        import os

        def pack(samples: list[MetricSample]):
            if not samples:
                return np.zeros((0, 3), np.int64), np.zeros((0, 0), np.float32)
            meta = np.array(
                [
                    [
                        getattr(s.entity, "topic", getattr(s.entity, "broker_id", -1)),
                        getattr(s.entity, "partition", -1),
                        s.time_ms,
                    ]
                    for s in samples
                ],
                np.int64,
            )
            vals = np.stack([s.values for s in samples])
            return meta, vals

        pm, pv = pack(result.partition_samples)
        bm, bv = pack(result.broker_samples)
        np.savez_compressed(
            os.path.join(self.path, f"samples_{self._n:08d}.npz"),
            part_meta=pm, part_values=pv, broker_meta=bm, broker_values=bv,
        )
        self._n += 1

    def load(self) -> list[SamplingResult]:
        out = []
        for f in self._files():
            z = np.load(f)
            ps = [
                MetricSample(PartitionEntity(int(t), int(p)), int(ts), v)
                for (t, p, ts), v in zip(z["part_meta"], z["part_values"])
            ]
            bs = [
                MetricSample(BrokerEntity(int(b)), int(ts), v)
                for (b, _, ts), v in zip(z["broker_meta"], z["broker_values"])
            ]
            out.append(SamplingResult(ps, bs))
        return out

    def close(self) -> None:
        pass


class MetricSamplerPartitionAssignor:
    """Splits the partition universe into per-fetcher disjoint sets
    (reference monitor/sampling/MetricSamplerPartitionAssignor.java:1 —
    the default assignor distributes each topic's partitions so fetcher
    loads stay balanced while a topic's partitions stay together as far as
    the balance allows).

    A rotating round-robin walks topics in order and deals their partitions
    across the fetcher sets, carrying the cursor between topics: every set
    ends within one partition of even, and no topic can serialize a round
    on one fetcher.
    """

    def assign(
        self, partitions: list[PartitionEntity], num_fetchers: int
    ) -> list[list[PartitionEntity]]:
        if num_fetchers <= 1:
            return [list(partitions)]
        by_topic: dict[object, list[PartitionEntity]] = {}
        for p in partitions:
            by_topic.setdefault(p.topic, []).append(p)
        sets: list[list[PartitionEntity]] = [[] for _ in range(num_fetchers)]
        k = 0
        for _topic, plist in sorted(by_topic.items(), key=lambda kv: str(kv[0])):
            for p in plist:
                sets[k].append(p)
                k = (k + 1) % num_fetchers
        return sets


class MetricFetcherManager:
    """Schedules sampling rounds and feeds aggregators + sample store
    (reference monitor/sampling/MetricFetcherManager.java:35-56,145,
    SamplingFetcher.java:32).  `num_fetchers > 1` splits each round's
    partition universe across a thread pool via the assignor — the
    reference's fetcher-pool parallelism (num.metric.fetchers) — and merges
    the per-fetcher results; each fetch is timed and failure-counted into
    the sensor registry, with monitor self-observability gauges
    (monitored-partitions-percentage, num-partitions-with-flaw: reference
    docs/wiki User Guide/Sensors.md:9-17).
    """

    def __init__(
        self,
        sampler: MetricSampler,
        partition_aggregator,
        broker_aggregator,
        sample_store: SampleStore | None = None,
        *,
        sampling_interval_ms: int = 120_000,
        num_fetchers: int = 1,
        assignor: MetricSamplerPartitionAssignor | None = None,
        sensors=None,
    ):
        from cruise_control_tpu_torch.common.sensors import SensorRegistry

        self.sampler = sampler
        self.partition_aggregator = partition_aggregator
        self.broker_aggregator = broker_aggregator
        self.sample_store = sample_store or NoopSampleStore()
        self.sampling_interval_ms = sampling_interval_ms
        self.num_fetchers = max(1, num_fetchers)
        self.assignor = assignor or MetricSamplerPartitionAssignor()
        # per-instance default, NOT the module-global registry: the health
        # gauges below close over self, so a global default would let a
        # second manager silently take over the gauge names and would pin
        # every stopped manager alive via the registry (the facade scopes
        # its registry per instance for the same reason)
        self.sensors = sensors if sensors is not None else SensorRegistry()
        self._pool = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.total_samples = 0
        self.failed_fetches = 0
        #: last round's monitor-health numbers (also exported as gauges)
        self.last_monitored_percentage = 100.0
        self.last_partitions_with_flaw = 0
        self.sensors.gauge(
            "monitor.monitored-partitions-percentage",
            lambda: self.last_monitored_percentage,
        )
        self.sensors.gauge(
            "monitor.num-partitions-with-flaw",
            lambda: self.last_partitions_with_flaw,
        )

    def _fetch_one(
        self, partitions: list[PartitionEntity], start_ms: int, end_ms: int
    ) -> SamplingResult:
        """One fetcher's sampling call, timed + failure-counted
        (reference MetricFetcherManager fetch timer/failure sensors :53-56)."""
        try:
            with self.sensors.timer("monitor.metric-fetch").time():
                return self.sampler.get_samples(partitions, start_ms, end_ms)
        except Exception:
            self.failed_fetches += 1
            self.sensors.counter("monitor.metric-fetch-failures").inc()
            raise

    def fetch_once(self, partitions: list[PartitionEntity], start_ms: int, end_ms: int) -> int:
        """One sampling round (reference fetchPartitionMetricSamples:145);
        with num_fetchers > 1 the round fans out over disjoint partition
        sets and merges (reference MetricSamplerPartitionAssignor split)."""
        if self.num_fetchers > 1 and len(partitions) > 1:
            from concurrent.futures import ThreadPoolExecutor

            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_fetchers, thread_name_prefix="metric-fetcher"
                )
            sets = [
                s for s in self.assignor.assign(partitions, self.num_fetchers) if s
            ]
            futures = [
                self._pool.submit(self._fetch_one, s, start_ms, end_ms) for s in sets
            ]
            parts: list[MetricSample] = []
            brokers: list[MetricSample] = []
            errors = []
            for f in futures:
                try:
                    r = f.result()
                    parts.extend(r.partition_samples)
                    brokers.extend(r.broker_samples)
                except Exception as e:  # noqa: BLE001 — surface after merging
                    errors.append(e)
            if errors and not parts and not brokers:
                raise errors[0]
            result = SamplingResult(parts, brokers)
        else:
            result = self._fetch_one(partitions, start_ms, end_ms)
        self._update_health(partitions, result)
        n = self._absorb(result)
        self.sample_store.store(result)
        return n

    def _update_health(
        self, assigned: list[PartitionEntity], result: SamplingResult
    ) -> None:
        """Monitor self-observability (reference Sensors.md
        monitored-partitions-percentage / num-partitions-with-flaw)."""
        if not assigned:
            return
        sampled = {
            (s.entity.topic, s.entity.partition) for s in result.partition_samples
        }
        n_ok = sum(1 for p in assigned if (p.topic, p.partition) in sampled)
        self.last_monitored_percentage = 100.0 * n_ok / len(assigned)
        flawed = sum(
            1 for s in result.partition_samples if not np.all(np.isfinite(s.values))
        )
        self.last_partitions_with_flaw = flawed + (len(assigned) - n_ok)

    def _absorb(self, result: SamplingResult) -> int:
        n = 0
        for s in result.partition_samples:
            if self.partition_aggregator.add_sample(
                s.entity, s.time_ms, s.values, group=getattr(s.entity, "group", None)
            ):
                n += 1
        if self.broker_aggregator is not None:
            for s in result.broker_samples:
                if self.broker_aggregator.add_sample(s.entity, s.time_ms, s.values):
                    n += 1
        self.total_samples += n
        return n

    def load_samples(self) -> int:
        """Warm restart from the sample store (reference SampleLoadingTask)."""
        n = 0
        for result in self.sample_store.load():
            n += self._absorb(result)
        return n

    def start(self, partitions_fn, *, interval_s: float | None = None):
        interval = interval_s or self.sampling_interval_ms / 1000.0

        def loop():
            while not self._stop.wait(interval):
                now = int(time.time() * 1000)
                try:
                    self.fetch_once(partitions_fn(), now - self.sampling_interval_ms, now)
                except Exception:  # noqa: BLE001 — keep the loop alive like the reference fetchers
                    pass

        self._thread = threading.Thread(target=loop, daemon=True, name="metric-fetcher")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
