"""The port's metrics reporter and reporter sampler on the CPU.

tests/test_reporter.py's tests, pointed at the port: the record serde, the
reporter -> transport -> sampler pipeline, the reference plugin's wire
format (golden bytes, the id table, unknown classes, records flowing into
the aggregator).  Then parity with the JAX package: on one seeded stream of
reports from many brokers and topics, the port's sampler gives the JAX
package's samples bit for bit, through the native columnar path and
through the object path.
"""

import dataclasses
import struct

import numpy as np
import pytest

from cruise_control_tpu_torch.monitor.reporter_sampler import CruiseControlMetricsReporterSampler
from cruise_control_tpu_torch.monitor.topology import BrokerNode, ClusterTopology, PartitionInfo
from cruise_control_tpu_torch.reporter import (
    BrokerMetric,
    InMemoryTransport,
    MetricSerde,
    MetricsRegistrySnapshotter,
    MetricsReporter,
    MetricType,
    PartitionMetric,
    TopicMetric,
)
from cruise_control_tpu_torch.reporter.metrics import (
    _REF_ID_BY_TYPE,
    _REF_TYPE_BY_ID,
    ReferenceMetricSerde,
)

# --------------------------------------------- tests/test_reporter.py, ported


def test_serde_roundtrip():
    cases = [
        BrokerMetric(MetricType.BROKER_CPU_UTIL, 12345, 3, 0.75),
        TopicMetric(MetricType.TOPIC_BYTES_IN, 99, 1, 1024.5, topic="T0"),
        PartitionMetric(MetricType.PARTITION_SIZE, 7, 2, 5e6, topic="T1", partition=42),
    ]
    for m in cases:
        assert MetricSerde.deserialize(MetricSerde.serialize(m)) == m


def topo():
    brokers = (BrokerNode(0, "r0", "h0"), BrokerNode(1, "r1", "h1"))
    parts = (
        PartitionInfo("T0", 0, leader=0, replicas=(0, 1)),
        PartitionInfo("T0", 1, leader=0, replicas=(0, 1)),
        PartitionInfo("T0", 2, leader=1, replicas=(1, 0)),
    )
    return ClusterTopology(brokers=brokers, partitions=parts)


def test_reporter_to_sampler_pipeline():
    t = topo()
    transport = InMemoryTransport()

    def source_b0():
        return {
            "broker": {MetricType.BROKER_CPU_UTIL: 40.0, MetricType.BROKER_LOG_FLUSH_TIME_MS_MEAN: 5.0},
            "topics": {"T0": {MetricType.TOPIC_BYTES_IN: 300.0, MetricType.TOPIC_BYTES_OUT: 600.0}},
            "partitions": {("T0", 0): 1000.0, ("T0", 1): 2000.0},
        }

    reporter = MetricsReporter(MetricsRegistrySnapshotter(0, source_b0), transport, reporting_interval_ms=10)
    assert reporter.report_once(now_ms=1000) == 6
    sampler = CruiseControlMetricsReporterSampler(transport, lambda: t)
    result = sampler.get_samples([], 0, 2000)
    assert len(result.partition_samples) == 2
    by_part = {s.entity.partition: s.values for s in result.partition_samples}
    md = sampler.metric_def
    nwin = md.metric_id("LEADER_BYTES_IN")
    disk = md.metric_id("DISK_USAGE")
    cpu = md.metric_id("CPU_USAGE")
    assert by_part[1][nwin] == pytest.approx(200.0)
    assert by_part[0][nwin] == pytest.approx(100.0)
    assert by_part[0][disk] == 1000.0
    assert by_part[0][cpu] + by_part[1][cpu] == pytest.approx(40.0)
    assert len(result.broker_samples) == 1
    assert result.broker_samples[0].values[md.metric_id("BROKER_LOG_FLUSH_TIME_MS_MEAN")] == 5.0
    assert sampler.get_samples([], 0, 2000).partition_samples == []


def test_reference_serde_golden_bytes():
    b = BrokerMetric(MetricType.BROKER_CPU_UTIL, 1234, 7, 0.5)
    expect_b = b"\x00" + b"\x00" + b"\x05" + struct.pack(">q", 1234) + struct.pack(">i", 7) + struct.pack(">d", 0.5)
    assert ReferenceMetricSerde.serialize(b) == expect_b
    assert ReferenceMetricSerde.deserialize(expect_b) == b

    t = TopicMetric(MetricType.TOPIC_BYTES_IN, 99, 1, 1024.5, topic="T0")
    expect_t = (b"\x01\x00\x02" + struct.pack(">q", 99) + struct.pack(">i", 1)
                + struct.pack(">i", 2) + b"T0" + struct.pack(">d", 1024.5))
    assert ReferenceMetricSerde.serialize(t) == expect_t
    assert ReferenceMetricSerde.deserialize(expect_t) == t

    p = PartitionMetric(MetricType.PARTITION_SIZE, 7, 2, 5e6, topic="T1", partition=42)
    expect_p = (b"\x02\x00\x04" + struct.pack(">q", 7) + struct.pack(">i", 2)
                + struct.pack(">i", 2) + b"T1" + struct.pack(">i", 42) + struct.pack(">d", 5e6))
    assert ReferenceMetricSerde.serialize(p) == expect_p
    assert ReferenceMetricSerde.deserialize(expect_p) == p


def test_reference_id_table_complete_and_pinned():
    assert sorted(_REF_TYPE_BY_ID) == list(range(63))
    pins = {
        0: MetricType.ALL_TOPIC_BYTES_IN,
        2: MetricType.TOPIC_BYTES_IN,
        4: MetricType.PARTITION_SIZE,
        5: MetricType.BROKER_CPU_UTIL,
        19: MetricType.BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT,
        40: MetricType.BROKER_LOG_FLUSH_RATE,
        43: MetricType.BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH,
        62: MetricType.BROKER_LOG_FLUSH_TIME_MS_999TH,
    }
    for ref_id, mt in pins.items():
        assert _REF_TYPE_BY_ID[ref_id] is mt
        assert _REF_ID_BY_TYPE[mt] == ref_id


def test_reference_serde_roundtrip_every_type():
    for _ref_id, mt in _REF_TYPE_BY_ID.items():
        if mt.is_partition_scope:
            m = PartitionMetric(mt, 5, 1, 2.0, topic="t", partition=3)
        elif mt.is_topic_scope:
            m = TopicMetric(mt, 5, 1, 2.0, topic="t")
        else:
            m = BrokerMetric(mt, 5, 1, 2.0)
        assert ReferenceMetricSerde.deserialize(ReferenceMetricSerde.serialize(m)) == m


def test_reference_serde_skips_unknown_class_id():
    frame = b"\x09" + b"\x00\x05" + struct.pack(">qid", 1, 1, 1.0)
    assert ReferenceMetricSerde.deserialize(frame) is None
    tr = InMemoryTransport(serde=ReferenceMetricSerde)
    tr.send(frame)
    tr.send(ReferenceMetricSerde.serialize(BrokerMetric(MetricType.BROKER_CPU_UTIL, 1, 0, 9.0)))
    polled = tr.poll()
    assert len(polled) == 1 and polled[0].value == 9.0


def test_reference_format_records_flow_into_aggregator():
    from cruise_control_tpu_torch.monitor import KAFKA_METRIC_DEF, WindowedMetricSampleAggregator

    t = topo()
    transport = InMemoryTransport(serde=ReferenceMetricSerde)
    assert transport.framed_native is False
    records = [
        BrokerMetric(MetricType.BROKER_CPU_UTIL, 500, 0, 40.0),
        BrokerMetric(MetricType.BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT, 500, 0, 0.8),
        BrokerMetric(MetricType.BROKER_PRODUCE_LOCAL_TIME_MS_MEAN, 500, 0, 3.5),
        BrokerMetric(MetricType.BROKER_PRODUCE_LOCAL_TIME_MS_999TH, 500, 0, 25.0),
        TopicMetric(MetricType.TOPIC_BYTES_IN, 500, 0, 300.0, topic="T0"),
        TopicMetric(MetricType.TOPIC_BYTES_OUT, 500, 0, 600.0, topic="T0"),
        PartitionMetric(MetricType.PARTITION_SIZE, 500, 0, 1000.0, topic="T0", partition=0),
        PartitionMetric(MetricType.PARTITION_SIZE, 500, 0, 2000.0, topic="T0", partition=1),
    ]
    for m in records:
        transport.send(ReferenceMetricSerde.serialize(m))
    sampler = CruiseControlMetricsReporterSampler(transport, lambda: t)
    result = sampler.get_samples([], 0, 1000)
    assert len(result.partition_samples) == 2
    assert len(result.broker_samples) == 1
    md = sampler.metric_def
    bvals = result.broker_samples[0].values
    assert bvals[md.metric_id("BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT")] == pytest.approx(0.8)
    assert bvals[md.metric_id("BROKER_PRODUCE_LOCAL_TIME_MS_MEAN")] == pytest.approx(3.5)
    assert bvals[md.metric_id("BROKER_PRODUCE_LOCAL_TIME_MS_999TH")] == pytest.approx(25.0)

    agg = WindowedMetricSampleAggregator(3, 1000, 1, KAFKA_METRIC_DEF)
    for s in result.partition_samples:
        assert agg.add_sample(s.entity, s.time_ms, s.values)
    for m in records:
        transport.send(ReferenceMetricSerde.serialize(dataclasses.replace(m, time_ms=1500)))
    for s in CruiseControlMetricsReporterSampler(transport, lambda: t).get_samples([], 1000, 2000).partition_samples:
        agg.add_sample(s.entity, s.time_ms, s.values)
    res = agg.aggregate()
    assert res.entity_valid.sum() == 2
    nwin = md.metric_id("LEADER_BYTES_IN")
    w0 = list(res.window_indices).index(0)
    assert res.values[:, w0, nwin][res.entity_valid].sum() == pytest.approx(300.0)


# --------------------------------------------- parity with the JAX package


def _stream(pkg, topology, rng_seed: int):
    """A seeded reporting round from every broker of `topology` in package
    `pkg`'s record classes: CPU and a few broker metrics, bytes in and out
    of each topic a broker leads, partition sizes (some missing, one topic
    silent, one broker without CPU)."""
    rng = np.random.default_rng(rng_seed)
    mt = pkg.MetricType
    out = []
    leaders: dict = {}
    for p in topology.partitions:
        leaders.setdefault(p.leader, {}).setdefault(p.topic, []).append(p.partition)
    for b in sorted(leaders):
        t = 10_000 + 10 * b
        if b != 1:
            out.append(pkg.BrokerMetric(mt.BROKER_CPU_UTIL, t, b, float(rng.uniform(5, 90))))
        for m in (mt.BROKER_LOG_FLUSH_RATE, mt.ALL_TOPIC_BYTES_IN, mt.BROKER_PRODUCE_LOCAL_TIME_MS_999TH):
            out.append(pkg.BrokerMetric(m, t, b, float(rng.uniform(0, 1e4))))
        for topic, parts in leaders[b].items():
            if topic == "quiet":
                continue
            out.append(pkg.TopicMetric(mt.TOPIC_BYTES_IN, t, b, float(rng.uniform(0, 1e6)), topic=topic))
            out.append(pkg.TopicMetric(mt.TOPIC_BYTES_OUT, t, b, float(rng.uniform(0, 1e6)), topic=topic))
            for p in parts:
                if rng.random() < 0.9:
                    out.append(pkg.PartitionMetric(mt.PARTITION_SIZE, t, b, float(rng.uniform(0, 1e7)),
                                                   topic=topic, partition=p))
    return out


@pytest.mark.parametrize("path", ["native", "object"])
def test_sampler_samples_match_jax(path):
    """The same reporting round through both packages' transports and
    samplers: partition and broker samples, entity for entity, time for
    time, value bits for value bits.  It holds the port's one-pass
    per-broker bytes-in sum against the JAX package's rescan."""
    from cruise_control_tpu.monitor import reporter_sampler as jrs
    from cruise_control_tpu.reporter import metrics as jm
    from cruise_control_tpu.reporter import reporter as jr
    from cruise_control_tpu.testing.synthetic import synthetic_topology as j_topology
    from cruise_control_tpu_torch.reporter import metrics as tm
    from cruise_control_tpu_torch.reporter import reporter as tr
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    topics = {"A": 30, "B": 17, "quiet": 5, "C": 23, "__CruiseControlMetrics": 2}
    tt = synthetic_topology(num_brokers=9, num_racks=3, topics=topics, replication=3, seed=8)
    jt = j_topology(num_brokers=9, num_racks=3, topics=topics, replication=3, seed=8)
    results = []
    for pkg, rep, rs, tp in ((tm, tr, None, tt), (jm, jr, jrs, jt)):
        transport = rep.InMemoryTransport()
        for rec in _stream(pkg, tp, 4):
            transport.send(pkg.MetricSerde.serialize(rec))
        if path == "object":
            inner = transport

            class _Objects:
                def poll(self, max_records=None):
                    return inner.poll(max_records)

            transport = _Objects()
        cls = CruiseControlMetricsReporterSampler if rs is None else rs.CruiseControlMetricsReporterSampler
        results.append(cls(transport, lambda tp=tp: tp).get_samples([], 9_000, 11_000))
    got, want = results
    assert len(got.partition_samples) == len(want.partition_samples) > 50
    for xs, ys in ((got.partition_samples, want.partition_samples), (got.broker_samples, want.broker_samples)):
        assert [dataclasses.astuple(s.entity) for s in xs] == [dataclasses.astuple(s.entity) for s in ys]
        assert [s.time_ms for s in xs] == [s.time_ms for s in ys]
        for a, b in zip(xs, ys):
            assert a.values.dtype == b.values.dtype and a.values.tobytes() == b.values.tobytes()
