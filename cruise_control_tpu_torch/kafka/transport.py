"""Metric stream over real Kafka topics: producer + consumer transports.

Completes the real-cluster sampling loop the reference runs
(CruiseControlMetricsReporter produces to `__CruiseControlMetrics`;
CruiseControlMetricsReporterSampler.java:101 polls it):

  * KafkaMetricsTransport — the reporter-side MetricTransport SPI
    (reporter/reporter.py): buffers serialized metric records and produces
    one record-batch per partition leader on flush.
  * KafkaMetricsConsumer — the sampler-side drain: fetches every partition
    from its leader, decodes v2 batches, and exposes `poll_framed()` so the
    native columnar decoder (cruise_control_tpu_torch/native) parses the whole
    batch without per-record objects.

Both route by live Metadata (leader per partition) through the shared
KafkaAdminClient connection pool.
"""

from __future__ import annotations

import random
import threading
import time

from cruise_control_tpu_torch.common.device_watchdog import jittered_backoff_s
from cruise_control_tpu_torch.kafka import protocol as proto
from cruise_control_tpu_torch.kafka.client import KafkaAdminClient, KafkaProtocolError, NONE
from cruise_control_tpu_torch.kafka.records import decode_batches, encode_batch

DEFAULT_TOPIC = "__CruiseControlMetrics"
EARLIEST = -2
LATEST = -1


class _TopicRouter:
    """Partition -> leader routing from live metadata."""

    def __init__(self, client: KafkaAdminClient, topic: str):
        self.client = client
        self.topic = topic
        self._leaders: dict[int, int] = {}

    def refresh(self) -> dict[int, int]:
        md = self.client.metadata([self.topic])
        self._leaders = {}
        for t in md["topics"]:
            if t["name"] != self.topic or t["error_code"] != NONE:
                continue
            for p in t["partitions"]:
                if p["leader_id"] >= 0:
                    self._leaders[p["partition_index"]] = p["leader_id"]
        return self._leaders

    def leaders(self) -> dict[int, int]:
        return self._leaders or self.refresh()


class KafkaMetricsTransport:
    """MetricTransport over Produce v3 (reference reporter's producer)."""

    def __init__(
        self,
        client: KafkaAdminClient,
        topic: str = DEFAULT_TOPIC,
        *,
        acks: int = 1,
        flush_every: int = 1000,
        now_ms=None,
        retry_backoff_s: float = 0.05,
        retry_backoff_cap_s: float = 0.5,
        rng: random.Random | None = None,
        sleep=time.sleep,
    ):
        """retry_backoff_s/cap: full-jitter backoff base/cap applied before
        the NOT_LEADER reroute retry and the transient-connection retry —
        a metadata-lagging or restarting broker answered the instant retry
        with the same error.  rng/sleep injectable for deterministic tests."""
        self.client = client
        self.topic = topic
        self.acks = acks
        self.flush_every = flush_every
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._router = _TopicRouter(client, topic)
        self._buffer: list[bytes] = []
        self._rr = 0  # round-robin partition cursor
        self._lock = threading.Lock()

        self._now = now_ms or (lambda: int(time.time() * 1000))

    def send(self, payload: bytes) -> None:
        with self._lock:
            self._buffer.append(payload)
            full = len(self._buffer) >= self.flush_every
        if full:
            self.flush()

    def flush(self) -> None:
        # swap the buffer under the lock; network work (metadata + produce)
        # happens OUTSIDE it so concurrent send()s never block on a slow
        # broker.  On any failure the records go back to the buffer — a
        # transient hiccup must not drop metrics.
        with self._lock:
            records, self._buffer = self._buffer, []
            if not records:
                return
            rr = self._rr
            self._rr += 1
        try:
            leaders = self._router.leaders()
            if not leaders:
                raise KafkaProtocolError("Produce", 3, f"no leaders for {self.topic}")
            # spread whole flushes across partitions round-robin (records of
            # one flush stay together: ordering within a batch is preserved)
            parts = sorted(leaders)
            partition = parts[rr % len(parts)]
            batch = encode_batch(
                [(None, r) for r in records], base_timestamp_ms=self._now()
            )
            self._produce(partition, leaders[partition], batch, retry_route=True)
        except Exception:
            with self._lock:
                self._buffer[:0] = records  # restore, preserving order
            raise

    def _backoff(self, attempt: int = 1) -> None:
        self._sleep(
            jittered_backoff_s(
                attempt,
                base_s=self.retry_backoff_s,
                cap_s=self.retry_backoff_cap_s,
                rng=self._rng,
            )
        )

    def _produce(self, partition: int, node: int, batch: bytes, *,
                 retry_route: bool) -> None:
        request = {
            "transactional_id": None,
            "acks": self.acks,
            "timeout_ms": 30_000,
            "topic_data": [{
                "name": self.topic,
                "partition_data": [{"index": partition, "records": batch}],
            }],
        }
        try:
            resp = self.client.broker_request(node, proto.PRODUCE, request)
        except (ConnectionError, TimeoutError, OSError):
            # transient transport error (broker restarting, socket dropped):
            # retry ONCE after a short jittered pause, against fresh routing
            # — the leader may have moved with the restart.  A second
            # failure surfaces to flush(), which restores the buffer.
            if not retry_route:
                raise
            self._backoff()
            node = self._router.refresh().get(partition, node)
            resp = self.client.broker_request(node, proto.PRODUCE, request)
        for t in resp["responses"] or []:
            for p in t["partition_responses"] or []:
                if p["error_code"] == NONE:
                    continue
                if p["error_code"] == 6 and retry_route:
                    # NOT_LEADER_OR_FOLLOWER: re-route ONCE, then surface
                    # whatever the retry returns (a silently-dropped batch is
                    # silent metric loss).  Backoff first — the cluster is
                    # mid-election and instant metadata often still names
                    # the old leader.
                    self._backoff()
                    new_leader = self._router.refresh().get(partition)
                    if new_leader is None:
                        raise KafkaProtocolError(
                            "Produce", 6, f"partition {partition} leaderless"
                        )
                    self._produce(partition, new_leader, batch, retry_route=False)
                else:
                    raise KafkaProtocolError("Produce", p["error_code"])


class KafkaMetricsConsumer:
    """Drains the reporter topic; `poll_framed()` feeds the native decoder.

    Tracks its own per-partition offsets (the reference sampler also manages
    offsets explicitly, seeking by time window) starting from EARLIEST.
    """

    def __init__(
        self,
        client: KafkaAdminClient,
        topic: str = DEFAULT_TOPIC,
        *,
        max_bytes_per_fetch: int = 8 * 1024 * 1024,
        serde=None,
    ):
        """serde: record deserializer — native MetricSerde (default) or
        ReferenceMetricSerde when the topic is fed by the REFERENCE's
        in-broker reporter plugin (drop-in ingestion interop)."""
        from cruise_control_tpu_torch.reporter.metrics import MetricSerde

        self.client = client
        self.topic = topic
        self.max_bytes = max_bytes_per_fetch
        self.serde = serde or MetricSerde
        self.framed_native = self.serde is MetricSerde
        self._router = _TopicRouter(client, topic)
        self._offsets: dict[int, int] = {}
        #: fetched-but-undelivered payloads (a max_records poll must not
        #: drop the tail — offsets advance at fetch time)
        self._pending: list[bytes] = []
        self._lock = threading.Lock()

    def _ensure_offsets(self, leaders: dict[int, int]) -> None:
        missing = [p for p in leaders if p not in self._offsets]
        if not missing:
            return
        by_leader: dict[int, list[int]] = {}
        for p in missing:
            by_leader.setdefault(leaders[p], []).append(p)
        for node, parts in by_leader.items():
            resp = self.client.broker_request(node, proto.LIST_OFFSETS, {
                "replica_id": -1,
                "topics": [{
                    "name": self.topic,
                    "partitions": [
                        {"partition_index": p, "timestamp": EARLIEST} for p in parts
                    ],
                }],
            })
            for t in resp["topics"] or []:
                for p in t["partitions"] or []:
                    if p["error_code"] == NONE:
                        self._offsets[p["partition_index"]] = p["offset"]

    def poll_records(self, max_records: int | None = None) -> list[bytes]:
        """New record payloads across partitions (undelivered ones first)."""
        with self._lock:
            self._pending.extend(self._fetch_all())
            n = len(self._pending) if max_records is None else min(
                max_records, len(self._pending)
            )
            out, self._pending = self._pending[:n], self._pending[n:]
            return out

    def _fetch_all(self) -> list[bytes]:
        """Fetch every partition from its leader, advancing offsets.
        Caller holds the lock."""
        leaders = self._router.refresh()
        self._ensure_offsets(leaders)
        by_leader: dict[int, list[int]] = {}
        for p, node in leaders.items():
            by_leader.setdefault(node, []).append(p)
        out: list[bytes] = []
        for node, parts in sorted(by_leader.items()):
            resp = self.client.broker_request(node, proto.FETCH, {
                "replica_id": -1,
                "max_wait_ms": 0,
                "min_bytes": 0,
                "max_bytes": self.max_bytes,
                "isolation_level": 0,
                "topics": [{
                    "topic": self.topic,
                    "partitions": [
                        {
                            "partition": p,
                            "fetch_offset": self._offsets.get(p, 0),
                            "partition_max_bytes": self.max_bytes,
                        }
                        for p in sorted(parts)
                    ],
                }],
            })
            for t in resp["responses"] or []:
                for pr in t["partitions"] or []:
                    if pr["error_code"] == 1:  # OFFSET_OUT_OF_RANGE
                        # retention passed our offset: drop it so the next
                        # poll re-seeks to EARLIEST instead of stalling the
                        # partition forever
                        self._offsets.pop(pr["partition_index"], None)
                        continue
                    if pr["error_code"] != NONE or not pr["records"]:
                        continue
                    records = decode_batches(pr["records"])
                    part = pr["partition_index"]
                    next_off = self._offsets.get(part, 0)
                    for r in records:
                        if r.offset >= next_off:
                            out.append(r.value)
                            next_off = r.offset + 1
                    self._offsets[part] = next_off
        return out

    def log_end_offsets(self) -> dict[int, int]:
        """Current LATEST offset per partition (fresh ListOffsets round)."""
        leaders = self._router.refresh()
        by_leader: dict[int, list[int]] = {}
        for p, node in leaders.items():
            by_leader.setdefault(node, []).append(p)
        out: dict[int, int] = {}
        for node, parts in by_leader.items():
            resp = self.client.broker_request(node, proto.LIST_OFFSETS, {
                "replica_id": -1,
                "topics": [{
                    "name": self.topic,
                    "partitions": [
                        {"partition_index": p, "timestamp": LATEST} for p in parts
                    ],
                }],
            })
            for t in resp["topics"] or []:
                for p in t["partitions"] or []:
                    if p["error_code"] == NONE:
                        out[p["partition_index"]] = p["offset"]
        return out

    def at_log_end(self) -> bool:
        """True when every reachable partition's offset is at LATEST.

        One empty poll is NOT proof of log end: a transient fetch error
        (leader change, offset re-seek) yields an empty round with data
        still unread — callers draining history (sample-store replay) must
        confirm against ListOffsets.
        """
        with self._lock:
            if self._pending:
                return False
            ends = self.log_end_offsets()
            return all(self._offsets.get(p, 0) >= end for p, end in ends.items())

    def poll_framed(self, max_records: int | None = None) -> bytes:
        from cruise_control_tpu_torch.native import frame_records

        return frame_records(self.poll_records(max_records))

    def poll(self, max_records: int | None = None):
        """Object-path compatibility with the MetricSampler SPI; unknown
        record classes (serde returns None) are skipped."""
        decoded = (self.serde.deserialize(r) for r in self.poll_records(max_records))
        return [m for m in decoded if m is not None]
