"""The port's record batches, metric transport and sample store
(cruise_control_tpu_torch.kafka.{records,transport,sample_store}) on the
CPU: tests/test_kafka_records.py's 8 tests pointed at the port, and
tests/test_faults.py :338 test_kafka_transport_backoff_and_connection_retry.
The reference's notes follow.

Record-batch v2 + Produce/Fetch/ListOffsets + metric-stream transports.

Covers the data plane the reference runs over `__CruiseControlMetrics`
(reporter producer -> topic -> sampler consumer) end to end over real
sockets against the fake wire-protocol cluster.
"""

import random

import numpy as np
import pytest

from cruise_control_tpu_torch.kafka import KafkaAdminClient
from cruise_control_tpu_torch.kafka.records import (
    Record,
    crc32c,
    decode_batches,
    encode_batch,
    read_zigzag,
    write_zigzag,
)
from cruise_control_tpu_torch.kafka.transport import (
    KafkaMetricsConsumer,
    KafkaMetricsTransport,
)
from cruise_control_tpu_torch.testing.fake_kafka import FakeKafkaCluster


def test_crc32c_check_value():
    # the canonical CRC-32C check vector
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


def test_zigzag_roundtrip():
    for v in (0, 1, -1, 63, -64, 127, -128, 2**31, -(2**31), 10**15):
        out = bytearray()
        write_zigzag(out, v)
        got, off = read_zigzag(out, 0)
        assert got == v and off == len(out)


def test_batch_roundtrip():
    records = [(None, b"value-%d" % i) for i in range(10)] + [(b"key", b"v")]
    batch = encode_batch(records, base_offset=100, base_timestamp_ms=5000)
    out = decode_batches(batch)
    assert len(out) == 11
    assert out[0] == Record(offset=100, timestamp_ms=5000, key=None, value=b"value-0")
    assert out[-1].key == b"key" and out[-1].offset == 110
    # concatenated batches + trailing partial are handled
    two = batch + encode_batch([(None, b"x")], base_offset=111) + batch[:20]
    assert len(decode_batches(two)) == 12
    # null-value (tombstone) records decode without poisoning the cursor
    import struct as _struct
    from cruise_control_tpu_torch.kafka.records import write_zigzag

    rec = bytearray()
    rec.append(0)
    write_zigzag(rec, 0)   # ts delta
    write_zigzag(rec, 0)   # offset delta
    write_zigzag(rec, 3)
    rec += b"key"
    write_zigzag(rec, -1)  # NULL value
    write_zigzag(rec, 0)   # headers
    body = bytearray()
    write_zigzag(body, len(rec))
    body += rec
    post = _struct.pack(">hiqqqhii", 0, 0, 7, 7, -1, -1, -1, 1) + bytes(body)
    from cruise_control_tpu_torch.kafka.records import crc32c as _crc
    tomb = (_struct.pack(">qii", 5, 4 + 1 + 4 + len(post), -1) + b"\x02"
            + _struct.pack(">I", _crc(post)) + post)
    [t] = decode_batches(tomb)
    assert t.key == b"key" and t.value == b"" and t.offset == 5

    # corrupted CRC rejected
    bad = bytearray(batch)
    bad[30] ^= 0xFF
    try:
        decode_batches(bytes(bad))
        raise AssertionError("expected CRC failure")
    except ValueError:
        pass


def _cluster():
    return FakeKafkaCluster(
        brokers={i: {"rack": f"r{i%2}"} for i in range(3)},
        topics={
            "__CruiseControlMetrics": [
                {"partition": p, "leader": p % 3, "replicas": [p % 3]}
                for p in range(4)
            ],
        },
    ).start()


def test_produce_fetch_over_sockets():
    cluster = _cluster()
    client = KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    try:
        tr = KafkaMetricsTransport(client, flush_every=10_000)
        for i in range(25):
            tr.send(b"payload-%d" % i)
        tr.flush()
        consumer = KafkaMetricsConsumer(client)
        values = consumer.poll_records()
        assert sorted(values) == sorted(b"payload-%d" % i for i in range(25))
        # nothing new -> empty poll; new sends appear on the next poll
        assert consumer.poll_records() == []
        tr.send(b"late")
        tr.flush()
        assert consumer.poll_records() == [b"late"]
    finally:
        client.close()
        cluster.stop()


def test_reporter_to_sampler_loop_over_kafka():
    """The COMPLETE reference loop over wire-protocol sockets: metrics
    reporter -> produce -> __CruiseControlMetrics -> consumer ->
    reporter-sampler (native columnar path) -> partition samples."""
    from cruise_control_tpu_torch.monitor.reporter_sampler import (
        CruiseControlMetricsReporterSampler,
    )
    from cruise_control_tpu_torch.reporter.metrics import (
        BrokerMetric,
        MetricSerde,
        MetricType,
        PartitionMetric,
        TopicMetric,
    )
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    cluster = _cluster()
    client = KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    try:
        topo = synthetic_topology(num_brokers=3, topics={"T0": 6}, seed=2)
        tr = KafkaMetricsTransport(client, flush_every=10_000)
        for b in range(3):
            tr.send(MetricSerde.serialize(
                BrokerMetric(MetricType.BROKER_CPU_UTIL, 1000, b, 50.0)))
            tr.send(MetricSerde.serialize(BrokerMetric(
                MetricType.BROKER_PRODUCE_REQUEST_RATE, 1000, b, 9.0)))
            tr.send(MetricSerde.serialize(
                TopicMetric(MetricType.TOPIC_BYTES_IN, 1000, b, 1e5, topic="T0")))
            tr.send(MetricSerde.serialize(
                TopicMetric(MetricType.TOPIC_BYTES_OUT, 1000, b, 2e5, topic="T0")))
        for p in topo.partitions:
            tr.send(MetricSerde.serialize(PartitionMetric(
                MetricType.PARTITION_SIZE, 1000, p.leader, 1e6,
                topic=p.topic, partition=p.partition)))
        tr.flush()

        consumer = KafkaMetricsConsumer(client)
        sampler = CruiseControlMetricsReporterSampler(consumer, lambda: topo)
        result = sampler.get_samples([], 0, 2000)
        assert len(result.partition_samples) == 6
        assert len(result.broker_samples) == 3
        vals = np.asarray(result.partition_samples[0].values, float)
        assert vals.sum() > 0
    finally:
        client.close()
        cluster.stop()


def test_kafka_sample_store_warm_restart():
    """Samples persisted to the Kafka store topics replay into a FRESH
    store instance — the reference KafkaSampleStore/SampleLoadingTask warm
    restart (KafkaSampleStore.java:117-128)."""
    from cruise_control_tpu_torch.kafka.sample_store import KafkaSampleStore
    from cruise_control_tpu_torch.monitor.sampling import (
        BrokerEntity,
        MetricSample,
        PartitionEntity,
        SamplingResult,
    )

    cluster = _cluster()
    client = KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    try:
        # old process interned {alpha: 0}; new process interns {alpha: 7} —
        # replay must follow the NAME, not the stale dense id
        store = KafkaSampleStore(
            client, topic_name_fn={0: "alpha"}.__getitem__,
        )
        for w in range(3):
            t = w * 1000 + 500
            store.store(SamplingResult(
                partition_samples=[
                    MetricSample(PartitionEntity(0, p), t,
                                 np.arange(4, dtype=np.float32) + p + w)
                    for p in range(5)
                ],
                broker_samples=[
                    MetricSample(BrokerEntity(b), t,
                                 np.full(4, float(b), np.float32))
                    for b in range(2)
                ],
            ))
        # "restart": a brand-new store over a brand-new client
        client2 = KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
        try:
            fresh = KafkaSampleStore(
                client2, topic_id_fn={"alpha": 7}.__getitem__,
            )
            replayed = fresh.load()
            assert len(replayed) == 3  # one result per sample time
            total_p = sum(len(r.partition_samples) for r in replayed)
            total_b = sum(len(r.broker_samples) for r in replayed)
            assert total_p == 15 and total_b == 6
            assert all(
                s.entity.topic == 7
                for r in replayed for s in r.partition_samples
            )
            s0 = min(
                (s for r in replayed for s in r.partition_samples),
                key=lambda s: (s.time_ms, s.entity.partition),
            )
            # stored 4-wide; replay zero-pads to the live metric-def width
            np.testing.assert_allclose(s0.values[:4], [0.0, 1.0, 2.0, 3.0])
            assert not s0.values[4:].any()
        finally:
            client2.close()
    finally:
        client.close()
        cluster.stop()


def test_kafka_sample_store_load_drains_past_one_fetch_round(monkeypatch):
    """load() must replay the WHOLE persisted history, not one Fetch round —
    the reference SampleLoadingTask consumes to the log end
    (KafkaSampleStore.java:117-128).  A tiny per-fetch byte cap forces many
    rounds; a single poll_records() call would silently truncate."""
    import cruise_control_tpu_torch.kafka.sample_store as ss
    from cruise_control_tpu_torch.monitor.sampling import (
        MetricSample,
        PartitionEntity,
        SamplingResult,
    )

    class TinyFetchConsumer(KafkaMetricsConsumer):
        def __init__(self, client, topic):
            super().__init__(client, topic, max_bytes_per_fetch=512)

    monkeypatch.setattr(ss, "KafkaMetricsConsumer", TinyFetchConsumer)

    cluster = _cluster()
    client = KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    try:
        store = ss.KafkaSampleStore(client, topic_name_fn=lambda _t: "alpha")
        n_windows, per_window = 10, 8
        for w in range(n_windows):
            store.store(SamplingResult(
                partition_samples=[
                    MetricSample(PartitionEntity(0, p), w * 1000 + 500,
                                 np.full(4, float(w * per_window + p), np.float32))
                    for p in range(per_window)
                ],
                broker_samples=[],
            ))
        fresh = ss.KafkaSampleStore(client, topic_id_fn=lambda _n: 0)
        replayed = fresh.load()
        assert sum(len(r.partition_samples) for r in replayed) == n_windows * per_window
        assert len(replayed) == n_windows
    finally:
        client.close()
        cluster.stop()


def test_sample_store_replays_pre_extension_vector_width():
    """Samples persisted BEFORE a metric-def extension (e.g. the 36 -> 56
    broker percentile additions) must replay into the wider current def:
    short vectors zero-pad, longer ones truncate — a warm restart across
    an upgrade must not lose the persisted history (reference
    SampleLoadingTask warm restart)."""
    import numpy as np

    from cruise_control_tpu_torch.kafka.sample_store import KafkaSampleStore
    from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF

    store = KafkaSampleStore.__new__(KafkaSampleStore)  # no cluster needed
    store.topic_id_fn = {"T0": 0}.__getitem__
    store.metric_def = KAFKA_METRIC_DEF
    m = KAFKA_METRIC_DEF.num_metrics
    old = np.arange(36, dtype=np.float32)  # pre-extension width
    s = store._unpack(store._pack(0, 0, 3, 1234, "T0", old))
    assert s.values.shape == (m,)
    assert np.all(s.values[:36] == old) and np.all(s.values[36:] == 0.0)
    long = np.arange(m + 7, dtype=np.float32)  # hypothetical future shrink
    s2 = store._unpack(store._pack(1, 5, 0, 99, "b", long))
    assert s2.values.shape == (m,) and np.all(s2.values == long[:m])


def test_kafka_transport_backoff_and_connection_retry():
    from cruise_control_tpu_torch.kafka import protocol as proto
    from cruise_control_tpu_torch.kafka.client import KafkaProtocolError
    from cruise_control_tpu_torch.kafka.transport import KafkaMetricsTransport

    class FakeClient:
        """Scripted broker: responses[i] is an error_code or an exception
        for the i-th Produce."""

        def __init__(self, script):
            self.script = list(script)
            self.produces = 0

        def metadata(self, topics):
            return {"topics": [{
                "name": topics[0], "error_code": 0,
                "partitions": [
                    {"partition_index": 0, "leader_id": 1, "error_code": 0}
                ],
            }]}

        def broker_request(self, node, api, body):
            assert api is proto.PRODUCE
            self.produces += 1
            step = self.script.pop(0)
            if isinstance(step, Exception):
                raise step
            return {"responses": [{"partition_responses": [
                {"error_code": step, "index": 0}
            ]}]}

    sleeps: list[float] = []

    def make(script):
        client = FakeClient(script)
        t = KafkaMetricsTransport(
            client, flush_every=1, rng=random.Random(1), sleep=sleeps.append,
        )
        return client, t

    # NOT_LEADER -> jittered backoff -> reroute succeeds
    client, t = make([6, 0])
    t.send(b"m1")
    assert client.produces == 2 and len(sleeps) == 1
    assert 0 < sleeps[0] <= 0.5

    # transient connection error -> backoff -> retry succeeds
    sleeps.clear()
    client, t = make([ConnectionError("reset"), 0])
    t.send(b"m2")
    assert client.produces == 2 and len(sleeps) == 1

    # double failure surfaces AND the buffer is restored (contract)
    sleeps.clear()
    client, t = make([ConnectionError("reset"), ConnectionError("reset")])
    with pytest.raises(ConnectionError):
        t.send(b"m3")
    assert t._buffer == [b"m3"]

    # hard protocol errors do not retry
    client, t = make([3])
    with pytest.raises(KafkaProtocolError):
        t.send(b"m4")
    assert client.produces == 1 and t._buffer == [b"m4"]
