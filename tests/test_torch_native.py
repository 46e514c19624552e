"""The port's native batch serde (cruise_control_tpu_torch/native) on the CPU.

tests/test_native.py's tests, pointed at the port: parity of the C++ and
Python decoders with the record serde, malformed batches, the sampler's
columnar fast path against its object path.  Then: the port builds its
library under the package's `_build/` and counts the batches its C++ path
decodes, and both packages' serializers write the same bytes for every
metric type in both wire formats, which each package's decoders read back.
"""

import time

import numpy as np
import pytest

from cruise_control_tpu_torch import native
from cruise_control_tpu_torch.native import batch_deserialize, frame_records, native_available
from cruise_control_tpu_torch.reporter.metrics import (
    BrokerMetric,
    MetricSerde,
    MetricType,
    PartitionMetric,
    ReferenceMetricSerde,
    TopicMetric,
)


def _random_records(n: int, seed: int = 0, pkg=None):
    from cruise_control_tpu_torch.reporter import metrics

    pkg = pkg or metrics
    rng = np.random.default_rng(seed)
    recs = []
    topics = ["Topic-A", "tøpic-ünïcode", "T" * 100, "b"]
    for i in range(n):
        kind = rng.integers(0, 3)
        t = int(rng.integers(0, 10_000_000))
        b = int(rng.integers(0, 4000))
        v = float(rng.normal() * 1e6)
        mt = pkg.MetricType
        if kind == 0:
            recs.append(pkg.BrokerMetric(mt.BROKER_CPU_UTIL, t, b, v))
        elif kind == 1:
            recs.append(pkg.TopicMetric(mt.TOPIC_BYTES_IN, t, b, v, topic=topics[i % len(topics)]))
        else:
            recs.append(pkg.PartitionMetric(mt.PARTITION_SIZE, t, b, v, topic=topics[i % len(topics)],
                                            partition=int(rng.integers(0, 500))))
    return recs


# --------------------------------------------- tests/test_native.py, ported


def test_native_builds():
    assert native_available(), "g++ is needed to build the native serde"


@pytest.mark.parametrize("force_python", [False, True])
def test_batch_parity_with_record_serde(force_python):
    recs = _random_records(500, seed=3)
    framed = frame_records([MetricSerde.serialize(r) for r in recs])
    batch = batch_deserialize(framed, force_python=force_python)
    assert len(batch) == len(recs)
    for i, r in enumerate(recs):
        assert batch.metric_types[i] == int(r.metric_type)
        assert batch.times_ms[i] == r.time_ms
        assert batch.broker_ids[i] == r.broker_id
        assert batch.values[i] == r.value
        if isinstance(r, PartitionMetric):
            assert batch.class_ids[i] == 2
            assert batch.partitions[i] == r.partition
            assert batch.topics[batch.topic_ids[i]] == r.topic
        elif isinstance(r, TopicMetric):
            assert batch.class_ids[i] == 1
            assert batch.topics[batch.topic_ids[i]] == r.topic
        else:
            assert batch.class_ids[i] == 0
            assert batch.topic_ids[i] == -1


def test_native_and_python_paths_agree():
    """Every column of the two paths, dtype and bytes."""
    recs = _random_records(300, seed=9)
    framed = frame_records([MetricSerde.serialize(r) for r in recs])
    a = batch_deserialize(framed, force_python=False)
    b = batch_deserialize(framed, force_python=True)
    for f in ("class_ids", "metric_types", "times_ms", "broker_ids", "values", "partitions", "topic_ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert a.topics == b.topics


def test_malformed_batches_rejected():
    good = frame_records([MetricSerde.serialize(BrokerMetric(MetricType.BROKER_CPU_UTIL, 1, 2, 3.0))])
    for bad in (good[:-1], good + b"\x01", b"\x05\x00\x00\x00abc"):
        with pytest.raises(ValueError):
            batch_deserialize(bad)
        with pytest.raises(ValueError):
            batch_deserialize(bad, force_python=True)
    assert len(batch_deserialize(b"")) == 0


def test_sampler_columnar_path_matches_object_path():
    from cruise_control_tpu_torch.monitor.reporter_sampler import CruiseControlMetricsReporterSampler
    from cruise_control_tpu_torch.reporter.reporter import InMemoryTransport
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    topo = synthetic_topology(num_brokers=4, topics={"T0": 8, "T1": 8}, seed=5)

    def make_transport(records):
        tr = InMemoryTransport()
        for r in records:
            tr.send(MetricSerde.serialize(r))
        return tr

    records = []
    for b in range(4):
        records.append(BrokerMetric(MetricType.BROKER_CPU_UTIL, 1000, b, 40.0 + b))
        for t in ("T0", "T1"):
            records.append(TopicMetric(MetricType.TOPIC_BYTES_IN, 1000, b, 1e5 * (b + 1), topic=t))
            records.append(TopicMetric(MetricType.TOPIC_BYTES_OUT, 1000, b, 2e5 * (b + 1), topic=t))
    for p in topo.partitions:
        records.append(PartitionMetric(MetricType.PARTITION_SIZE, 1000, p.leader, 1e6 + p.partition,
                                       topic=p.topic, partition=p.partition))

    class ObjectOnlyTransport:
        """Exposes poll() but not poll_framed: forces the object path."""

        def __init__(self, inner):
            self._inner = inner

        def poll(self, max_records=None):
            return self._inner.poll(max_records)

    fast = CruiseControlMetricsReporterSampler(make_transport(records), lambda: topo)
    slow = CruiseControlMetricsReporterSampler(ObjectOnlyTransport(make_transport(records)), lambda: topo)
    calls = native.native_calls()
    r_fast = fast.get_samples([], 0, 2000)
    assert native.native_calls() == calls + 1  # the C++ path decoded the batch
    r_slow = slow.get_samples([], 0, 2000)

    def key(s):
        return (repr(s.entity), tuple(np.round(np.asarray(s.values, float), 6)))

    assert sorted(map(key, r_fast.partition_samples)) == sorted(map(key, r_slow.partition_samples))
    assert sorted(map(key, r_fast.broker_samples)) == sorted(map(key, r_slow.broker_samples))


def test_native_throughput_smoke():
    recs = _random_records(20_000, seed=1)
    payloads = [MetricSerde.serialize(r) for r in recs]
    framed = frame_records(payloads)
    t0 = time.perf_counter()
    batch = batch_deserialize(framed)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ = [MetricSerde.deserialize(p) for p in payloads]
    object_s = time.perf_counter() - t0
    assert len(batch) == len(recs)
    if native_available():
        assert native_s <= object_s


def test_truncated_topic_record_rejected_by_both_paths():
    import struct

    good = MetricSerde.serialize(
        PartitionMetric(MetricType.PARTITION_SIZE, 5, 1, 2.0, topic="abcdef", partition=3)
    )
    bad_topic_len = good[:24] + struct.pack("<H", 1000) + good[26:]
    bad_part = good[:24] + struct.pack("<H", len(good) - 26 - 2) + good[26:]
    for bad in (bad_topic_len, bad_part):
        framed = frame_records([bad])
        for force_python in (False, True):
            with pytest.raises(ValueError):
                batch_deserialize(framed, force_python=force_python)


# --------------------------------------------- the port's build, and parity


def test_library_builds_under_the_package_build_dir():
    """The library lies in the package's `_build/` (never beside the
    source), named by a hash of the source and flags; `native_calls`
    counts the native path only."""
    from pathlib import Path

    assert native_available()
    path = native.library_path()
    pkg = Path(native.__file__).resolve().parents[1]
    assert path.parent == pkg / "_build" and path.exists()
    assert not list(Path(native.__file__).resolve().parent.glob("*.so"))
    framed = frame_records([MetricSerde.serialize(r) for r in _random_records(10)])
    n = native.native_calls()
    batch_deserialize(framed, force_python=True)
    assert native.native_calls() == n
    batch_deserialize(framed)
    assert native.native_calls() == n + 1


def _every_type(pkg, serde_name):
    """One record of every metric type the serde can carry, in package
    `pkg`'s classes."""
    out = []
    for i, mt in enumerate(pkg.MetricType):
        if serde_name == "reference" and mt not in pkg._REF_ID_BY_TYPE:
            continue
        t, b, v = 1_000 + 7 * i, i % 11, (i - 30) * 12.375
        if mt.is_partition_scope:
            out.append(pkg.PartitionMetric(mt, t, b, v, topic=f"tøpic-{i}", partition=i * 3))
        elif mt.is_topic_scope:
            out.append(pkg.TopicMetric(mt, t, b, v, topic=f"t{i}"))
        else:
            out.append(pkg.BrokerMetric(mt, t, b, v))
    return out


@pytest.mark.parametrize("serde_name", ["native", "reference"])
def test_serializers_write_the_jax_package_bytes(serde_name):
    from cruise_control_tpu.reporter import metrics as jm
    from cruise_control_tpu_torch.reporter import metrics as tm

    t_serde = tm.MetricSerde if serde_name == "native" else tm.ReferenceMetricSerde
    j_serde = jm.MetricSerde if serde_name == "native" else jm.ReferenceMetricSerde
    t_recs, j_recs = _every_type(tm, serde_name), _every_type(jm, serde_name)
    assert len(t_recs) == len(j_recs) == len(tm.MetricType) == 63
    for t, j in zip(t_recs, j_recs):
        tb, jb = t_serde.serialize(t), j_serde.serialize(j)
        assert tb == jb, t
        # each package reads the other's bytes back to the same record
        assert t_serde.deserialize(jb) == t
        assert j_serde.deserialize(tb) == j


def test_batch_columns_match_the_jax_decoder():
    """The port's native and Python paths give the JAX package's Python
    decoder's columns on one framed stream of every record kind."""
    from cruise_control_tpu import native as jn
    from cruise_control_tpu_torch.reporter import metrics as tm

    recs = _random_records(400, seed=21) + _every_type(tm, "native")
    framed = frame_records([MetricSerde.serialize(r) for r in recs])
    want = jn.batch_deserialize(framed, force_python=True)
    for force_python in (False, True):
        got = batch_deserialize(framed, force_python=force_python)
        for f in ("class_ids", "metric_types", "times_ms", "broker_ids", "values", "partitions",
                  "topic_ids"):
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (force_python, f)
        assert got.topics == want.topics
    assert ReferenceMetricSerde.deserialize(ReferenceMetricSerde.serialize(recs[0])) == recs[0]
