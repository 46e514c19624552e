"""Broker-side metrics reporter loop.

Reference: CruiseControlMetricsReporter.java (implements Kafka
MetricsReporter + Runnable: samples the broker's Yammer/Kafka metric
registries every reportingIntervalMs and produces to the
__CruiseControlMetrics topic, auto-creating it), metric/YammerMetricProcessor.java
(+ MetricsUtils.java filter logic).

Transport is an SPI: a real deployment produces to Kafka; in-process runs
use InMemoryTransport, which the CruiseControlMetricsReporterSampler
equivalent drains on the monitor side (reference
monitor/sampling/CruiseControlMetricsReporterSampler.java:41).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Protocol

from cruise_control_tpu_torch.reporter.metrics import (
    BrokerMetric,
    CruiseControlMetric,
    MetricSerde,
    MetricType,
    PartitionMetric,
    TopicMetric,
)


class MetricTransport(Protocol):
    """Where serialized metric records go (Kafka producer in production)."""

    def send(self, payload: bytes) -> None:
        ...

    def flush(self) -> None:
        ...


class InMemoryTransport:
    """Bounded in-process topic standing in for __CruiseControlMetrics.

    `serde` picks the record wire format: the native MetricSerde (default)
    or ReferenceMetricSerde to carry records in the REFERENCE reporter
    plugin's exact byte layout (drop-in interop path).
    """

    def __init__(self, max_records: int = 1_000_000, *, serde=MetricSerde):
        self._records: list[bytes] = []
        self._lock = threading.Lock()
        self._max = max_records
        self.serde = serde
        #: the native columnar decoder only parses the native layout; the
        #: sampler falls back to the object path for other serdes
        self.framed_native = serde is MetricSerde

    def send(self, payload: bytes) -> None:
        with self._lock:
            self._records.append(payload)
            if len(self._records) > self._max:
                del self._records[: len(self._records) - self._max]

    def flush(self) -> None:
        pass

    def poll(self, max_records: int | None = None) -> list[CruiseControlMetric]:
        """Consumer side (the sampler drains this).  Records the serde does
        not recognize (None — e.g. a newer metric class id) are skipped,
        matching the reference sampler's behavior."""
        with self._lock:
            n = len(self._records) if max_records is None else min(max_records, len(self._records))
            out, self._records = self._records[:n], self._records[n:]
        decoded = (self.serde.deserialize(r) for r in out)
        return [m for m in decoded if m is not None]

    def poll_framed(self, max_records: int | None = None) -> bytes:
        """Drain as one u32-length-framed batch for the native columnar
        decoder (cruise_control_tpu_torch/native) — no per-record objects."""
        from cruise_control_tpu_torch.native import frame_records

        with self._lock:
            n = len(self._records) if max_records is None else min(max_records, len(self._records))
            out, self._records = self._records[:n], self._records[n:]
        return frame_records(out)


class MetricsRegistrySnapshotter:
    """Adapter from a metrics source to raw metric records — the
    YammerMetricProcessor role.  The source is a callable returning
    {"broker": {MetricType: value}, "topics": {t: {...}}, "partitions":
    {(t, p): size}} for one broker."""

    def __init__(self, broker_id: int, source: Callable[[], dict]):
        self.broker_id = broker_id
        self.source = source

    def snapshot(self, now_ms: int) -> list[CruiseControlMetric]:
        data = self.source()
        out: list[CruiseControlMetric] = []
        for mt, v in data.get("broker", {}).items():
            out.append(BrokerMetric(MetricType(mt), now_ms, self.broker_id, float(v)))
        for topic, metrics in data.get("topics", {}).items():
            for mt, v in metrics.items():
                out.append(
                    TopicMetric(MetricType(mt), now_ms, self.broker_id, float(v), topic=topic)
                )
        for (topic, part), size in data.get("partitions", {}).items():
            out.append(
                PartitionMetric(
                    MetricType.PARTITION_SIZE, now_ms, self.broker_id, float(size),
                    topic=topic, partition=int(part),
                )
            )
        return out


class MetricsReporter:
    """The reporter loop (reference CruiseControlMetricsReporter.run)."""

    def __init__(
        self,
        snapshotter: MetricsRegistrySnapshotter,
        transport: MetricTransport,
        *,
        reporting_interval_ms: int = 60_000,
        serde=MetricSerde,
    ):
        """serde: MetricSerde (native) or ReferenceMetricSerde — the latter
        produces records a REFERENCE Cruise Control service consumes
        unchanged (interop in both directions)."""
        self.snapshotter = snapshotter
        self.transport = transport
        self.reporting_interval_ms = reporting_interval_ms
        self.serde = serde
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.reported = 0

    def report_once(self, now_ms: int | None = None) -> int:
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        metrics = self.snapshotter.snapshot(now_ms)
        for m in metrics:
            self.transport.send(self.serde.serialize(m))
        self.transport.flush()
        self.reported += len(metrics)
        return len(metrics)

    def start(self):
        def loop():
            while not self._stop.wait(self.reporting_interval_ms / 1000.0):
                try:
                    self.report_once()
                except Exception:  # noqa: BLE001 — reporter must not kill the broker
                    pass

        self._thread = threading.Thread(target=loop, daemon=True, name="metrics-reporter")
        self._thread.start()

    def close(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
