"""The port's monitor (cruise_control_tpu_torch.monitor) on the CPU.

First tests/test_monitor.py's tests, pointed at the port: the aggregator's
window semantics, the CPU model, the capacity resolvers, the monitored
cluster's model build (with `device="cpu"`; with no device and no CUDA the
build raises), the sample store's warm restart, the fetchers, and the
monitor -> optimizer slice on the port's `GoalOptimizer(device="cpu")`.

Then parity with the JAX package on the same inputs, made from a seed with
numpy.  Both monitors are host numpy, so the bar is bit for bit, with no
tolerance: `aggregate()` over window rolls, extrapolations and evictions,
`history_snapshot`, `extract_window_delta`, the synthetic samplers,
`LoadMonitor.cluster_model` (every state field and the catalog, also with a
bucket policy and with a JBOD capacity file), the optimizer's placements
on the monitored 6-broker cluster, `partition_replica_table`, and the
`FileSampleStore` files, written by one package and read by the other.
"""

import dataclasses
import json

import numpy as np
import pytest

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.convert import to_numpy
from cruise_control_tpu_torch.models.state import STATE_FIELDS, validate
from cruise_control_tpu_torch.monitor import (
    AggregationOptions,
    Extrapolation,
    FileCapacityResolver,
    FixedCapacityResolver,
    KAFKA_METRIC_DEF,
    LoadMonitor,
    MetricFetcherManager,
    ModelCompletenessRequirements,
    NotEnoughValidWindowsError,
    PartitionEntity,
    StaticMetadataProvider,
    WindowedMetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.cpu_model import (
    LinearRegressionModelParameters,
    follower_cpu_util,
)
from cruise_control_tpu_torch.monitor.sampling import InMemorySampleStore
from cruise_control_tpu_torch.testing.synthetic import (
    SyntheticWorkloadSampler,
    WorkloadSpec,
    synthetic_topology,
)

WINDOW_MS = 1000
M = KAFKA_METRIC_DEF.num_metrics
CPU = KAFKA_METRIC_DEF.metric_id("CPU_USAGE")
DISK = KAFKA_METRIC_DEF.metric_id("DISK_USAGE")
CAPACITY = [100.0, 1e5, 1e5, 1e6]
REQ2 = dict(min_required_num_windows=2)


def agg_factory(num_windows=4, min_samples=2):
    return WindowedMetricSampleAggregator(
        num_windows=num_windows,
        window_ms=WINDOW_MS,
        min_samples_per_window=min_samples,
        metric_def=KAFKA_METRIC_DEF,
    )


def sample(v_cpu, v_disk=0.0):
    v = np.zeros(M, np.float32)
    v[CPU] = v_cpu
    v[DISK] = v_disk
    return v


# --------------------------------------------- tests/test_monitor.py, ported


def test_avg_and_latest_strategies():
    agg = agg_factory()
    e = PartitionEntity(0, 0)
    agg.add_sample(e, 100, sample(10.0, 100.0))
    agg.add_sample(e, 900, sample(20.0, 140.0))
    agg.add_sample(e, 1100, sample(0.0))  # opens window 1 -> window 0 completed
    res = agg.aggregate()
    w0 = np.where(res.window_indices == 0)[0][0]
    assert res.values[0, w0, CPU] == pytest.approx(15.0)
    assert res.values[0, w0, DISK] == pytest.approx(140.0)
    assert res.extrapolation[0, w0] == Extrapolation.NONE


def test_extrapolation_ladder():
    agg = agg_factory(num_windows=6, min_samples=4)
    e = PartitionEntity(0, 0)
    for i in range(4):
        agg.add_sample(e, i * 10, sample(8.0))
    for i in range(2):
        agg.add_sample(e, 1000 + i * 10, sample(6.0))
    agg.add_sample(e, 2000, sample(4.0))
    agg.add_sample(e, 5500, sample(1.0))  # current window = 5
    res = agg.aggregate()
    by_w = {int(w): i for i, w in enumerate(res.window_indices)}
    ext = res.extrapolation[0]
    assert ext[by_w[0]] == Extrapolation.NONE
    assert ext[by_w[1]] == Extrapolation.AVG_AVAILABLE
    assert ext[by_w[2]] == Extrapolation.FORCED_INSUFFICIENT
    assert ext[by_w[3]] == Extrapolation.NO_VALID_EXTRAPOLATION
    assert not res.window_valid[0, by_w[3]]


def test_avg_adjacent_extrapolation():
    agg = agg_factory(num_windows=4, min_samples=1)
    e = PartitionEntity(0, 0)
    agg.add_sample(e, 100, sample(10.0))
    agg.add_sample(e, 2100, sample(30.0))
    agg.add_sample(e, 3100, sample(0.0))
    res = agg.aggregate()
    by_w = {int(w): i for i, w in enumerate(res.window_indices)}
    assert res.extrapolation[0, by_w[1]] == Extrapolation.AVG_ADJACENT
    assert res.values[0, by_w[1], CPU] == pytest.approx(20.0)


def test_window_rolling_evicts_old():
    agg = agg_factory(num_windows=2, min_samples=1)
    e = PartitionEntity(0, 0)
    agg.add_sample(e, 100, sample(1.0))
    agg.add_sample(e, 5100, sample(5.0))
    assert not agg.add_sample(e, 200, sample(9.9))
    res = agg.aggregate()
    assert set(int(w) for w in res.window_indices) == {3, 4}


def test_completeness_ratios():
    agg = agg_factory(num_windows=2, min_samples=1)
    e0, e1 = PartitionEntity(0, 0), PartitionEntity(0, 1)
    agg.add_sample(e0, 100, sample(1.0), group=0)
    agg.add_sample(e1, 150, sample(1.0), group=0)
    agg.add_sample(e0, 1100, sample(1.0), group=0)
    agg.add_sample(e0, 2100, sample(1.0), group=0)
    res = agg.aggregate(AggregationOptions(min_valid_entity_ratio=1.0))
    by_w = {int(w): i for i, w in enumerate(res.window_indices)}
    assert res.completeness.valid_entity_ratio_by_window[by_w[0]] == pytest.approx(1.0)
    assert res.completeness.valid_entity_ratio_by_window[by_w[1]] == pytest.approx(0.5)
    assert list(res.completeness.valid_windows) == [0]
    res2 = agg.aggregate(
        AggregationOptions(min_valid_entity_ratio=0.4, granularity="ENTITY_GROUP")
    )
    assert res2.completeness.valid_entity_group_ratio == 0.0


def test_follower_cpu_model():
    assert follower_cpu_util(100.0, 0.0, 10.0) == pytest.approx(
        10.0 * 0.15 * 100.0 / (0.7 * 100.0)
    )
    assert follower_cpu_util(0.0, 0.0, 10.0) == 0.0
    lr = LinearRegressionModelParameters(
        min_samples_to_train=10, required_samples_per_bucket=1, min_num_cpu_util_buckets=1,
    )
    rng = np.random.default_rng(0)
    true_w = np.array([0.002, 0.001, 0.0005])
    for _ in range(50):
        x = rng.uniform(0, 1000, 3)
        lr.add_sample(*x, cpu_util=float(true_w @ x))
    assert lr.train()
    est = lr.estimate(100.0, 100.0, 100.0)
    assert est == pytest.approx(float(true_w.sum() * 100.0), rel=1e-3)


JBOD_DOC = {
    "brokerCapacities": [
        {"brokerId": "-1",
         "capacity": {"DISK": "100000", "CPU": "100", "NW_IN": "10000", "NW_OUT": "10000"}},
        {"brokerId": "0",
         "capacity": {"DISK": {"/d1": "250000", "/d2": "250000"}, "CPU": "100",
                      "NW_IN": "50000", "NW_OUT": "50000"}},
    ]
}


def test_file_capacity_resolver_jbod(tmp_path):
    p = tmp_path / "capacity.json"
    p.write_text(json.dumps(JBOD_DOC))
    r = FileCapacityResolver(str(p))
    b0 = r.capacity_for_broker("r0", "h0", 0)
    assert b0.is_jbod and b0.capacity[Resource.DISK] == 500000
    b9 = r.capacity_for_broker("r0", "h0", 9)
    assert b9.capacity[Resource.DISK] == 100000


def _monitored(pkg, store=None, **monitor_kw):
    """tests/test_monitor.py's monitored cluster, built from package `pkg`
    (this package's names or the JAX package's): 6 brokers, two topics of
    12 partitions, 3 completed windows and the current one."""
    topo = pkg["synthetic_topology"](num_brokers=6, topics={"T0": 12, "T1": 12}, seed=2)
    sampler = pkg["SyntheticWorkloadSampler"](topo, pkg["WorkloadSpec"](), seed=2)
    mk = lambda n, s: pkg["Aggregator"](num_windows=n, window_ms=WINDOW_MS,  # noqa: E731
                                        min_samples_per_window=s, metric_def=pkg["METRIC_DEF"])
    agg = mk(3, 1)
    store = store if store is not None else pkg["InMemorySampleStore"]()
    fetcher = pkg["MetricFetcherManager"](sampler, agg, mk(4, 2), sample_store=store)
    parts = sampler.all_partition_entities()
    for w in range(4):
        fetcher.fetch_once(parts, w * WINDOW_MS, (w + 1) * WINDOW_MS - 1)
    monitor = pkg["LoadMonitor"](pkg["StaticMetadataProvider"](topo),
                                 pkg["FixedCapacityResolver"](CAPACITY), agg, **monitor_kw)
    return topo, sampler, monitor, store


PORT = dict(
    synthetic_topology=synthetic_topology, SyntheticWorkloadSampler=SyntheticWorkloadSampler,
    WorkloadSpec=WorkloadSpec, Aggregator=WindowedMetricSampleAggregator,
    METRIC_DEF=KAFKA_METRIC_DEF, InMemorySampleStore=InMemorySampleStore,
    MetricFetcherManager=MetricFetcherManager, LoadMonitor=LoadMonitor,
    StaticMetadataProvider=StaticMetadataProvider, FixedCapacityResolver=FixedCapacityResolver,
    Requirements=ModelCompletenessRequirements,
)


def _jax_package():
    from cruise_control_tpu import monitor as jm
    from cruise_control_tpu.monitor import sampling as js
    from cruise_control_tpu.testing import synthetic as jsyn

    return dict(
        synthetic_topology=jsyn.synthetic_topology,
        SyntheticWorkloadSampler=jsyn.SyntheticWorkloadSampler, WorkloadSpec=jsyn.WorkloadSpec,
        Aggregator=jm.WindowedMetricSampleAggregator, METRIC_DEF=jm.KAFKA_METRIC_DEF,
        InMemorySampleStore=js.InMemorySampleStore, MetricFetcherManager=jm.MetricFetcherManager,
        LoadMonitor=jm.LoadMonitor, StaticMetadataProvider=jm.StaticMetadataProvider,
        FixedCapacityResolver=jm.FixedCapacityResolver,
        Requirements=jm.ModelCompletenessRequirements,
    )


@pytest.fixture()
def monitored_cluster():
    return _monitored(PORT, device="cpu")


def test_load_monitor_builds_valid_state(monitored_cluster):
    topo, sampler, monitor, _ = monitored_cluster
    req = ModelCompletenessRequirements(**REQ2)
    assert monitor.meets_completeness_requirements(req)
    state = monitor.cluster_model(req)
    assert validate(state) == []
    assert state.shape.B == 6
    assert state.device.type == "cpu"
    assert int(state.replica_valid.sum()) == topo.num_replicas
    leads = state.replica_is_leader & state.replica_valid
    assert (state.replica_load_leader[leads][:, Resource.CPU] > 0).all()


def test_load_monitor_rejects_insufficient_windows(monitored_cluster):
    _, _, monitor, _ = monitored_cluster
    with pytest.raises(NotEnoughValidWindowsError):
        monitor.cluster_model(ModelCompletenessRequirements(min_required_num_windows=50))


def test_cluster_model_without_a_device_builds_on_cuda_only():
    """No device named: the build resolves to the current CUDA device, and
    on a host without CUDA it raises rather than building on the CPU."""
    import torch

    topo, _, monitor, _ = _monitored(PORT)
    assert monitor.device is None
    if torch.cuda.is_available():
        assert monitor.cluster_model(ModelCompletenessRequirements(**REQ2)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            monitor.cluster_model(ModelCompletenessRequirements(**REQ2))


def test_sample_store_warm_restart(monitored_cluster):
    topo, sampler, _, store = monitored_cluster
    fresh_agg = agg_factory(num_windows=3, min_samples=1)
    fetcher = MetricFetcherManager(sampler, fresh_agg, agg_factory(), sample_store=store)
    assert fetcher.load_samples() > 0
    monitor = LoadMonitor(StaticMetadataProvider(topo), FixedCapacityResolver(CAPACITY), fresh_agg,
                          device="cpu")
    assert validate(monitor.cluster_model(ModelCompletenessRequirements(**REQ2))) == []


E2E = dict(num_candidates=128, leadership_candidates=32, steps_per_round=16, num_rounds=2)


def test_monitor_to_optimizer_end_to_end(monitored_cluster):
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig

    _, _, monitor, _ = monitored_cluster
    state = monitor.cluster_model(ModelCompletenessRequirements(**REQ2))
    res = GoalOptimizer(config=OptimizerConfig(**E2E), device="cpu").optimize(state)
    assert res.objective_after <= res.objective_before


def test_partition_assignor_disjoint_and_balanced():
    from cruise_control_tpu_torch.monitor.sampling import MetricSamplerPartitionAssignor

    parts = [PartitionEntity(t, p) for t, n in enumerate([40, 17, 9, 5, 3, 1]) for p in range(n)]
    sets = MetricSamplerPartitionAssignor().assign(parts, 4)
    assert len(sets) == 4
    seen = [pp for s in sets for pp in s]
    assert len(seen) == len(parts) and len(set(seen)) == len(parts)
    sizes = sorted(len(s) for s in sets)
    assert sizes[-1] - sizes[0] <= 1
    assert MetricSamplerPartitionAssignor().assign(parts, 1) == [parts]


class _NullAgg:
    def add_sample(self, *a, **k):
        return True


def test_multi_fetcher_sampling_parallel_and_observed():
    import threading

    from cruise_control_tpu_torch.common.sensors import SensorRegistry
    from cruise_control_tpu_torch.monitor.sampling import MetricSample, SamplingResult

    calls: list[list] = []
    lock = threading.Lock()

    class RecordingSampler:
        def get_samples(self, assigned, start_ms, end_ms):
            with lock:
                calls.append(list(assigned))
            return SamplingResult([MetricSample(p, end_ms, np.ones(4, np.float32)) for p in assigned], [])

    sensors = SensorRegistry()
    parts = [PartitionEntity(t, p) for t in range(8) for p in range(10)]
    mgr = MetricFetcherManager(RecordingSampler(), _NullAgg(), None, num_fetchers=4, sensors=sensors)
    try:
        n = mgr.fetch_once(parts, 0, 1000)
    finally:
        mgr.stop()
    assert n == len(parts)
    assert len(calls) == 4
    seen = [p for c in calls for p in c]
    assert len(seen) == len(parts) and len(set(seen)) == len(parts)
    snap = sensors.snapshot()
    assert snap["monitor.metric-fetch"]["count"] == 4
    assert snap["monitor.monitored-partitions-percentage"]["value"] == 100.0
    assert snap["monitor.num-partitions-with-flaw"]["value"] == 0


def test_multi_fetcher_partial_failure_and_flaw_gauges():
    from cruise_control_tpu_torch.common.sensors import SensorRegistry
    from cruise_control_tpu_torch.monitor.sampling import MetricSample, SamplingResult

    class FlakySampler:
        def get_samples(self, assigned, start_ms, end_ms):
            if any(p.topic == 0 and p.partition == 0 for p in assigned):
                raise RuntimeError("broker unreachable")
            return SamplingResult([MetricSample(p, end_ms, np.ones(4, np.float32)) for p in assigned], [])

    sensors = SensorRegistry()
    parts = [PartitionEntity(t, p) for t in range(4) for p in range(10)]
    mgr = MetricFetcherManager(FlakySampler(), _NullAgg(), None, num_fetchers=4, sensors=sensors)
    try:
        n = mgr.fetch_once(parts, 0, 1000)
    finally:
        mgr.stop()
    assert 0 < n < len(parts)
    assert mgr.failed_fetches == 1
    snap = sensors.snapshot()
    assert snap["monitor.metric-fetch-failures"]["count"] == 1
    assert snap["monitor.monitored-partitions-percentage"]["value"] == 75.0
    assert snap["monitor.num-partitions-with-flaw"]["value"] == 10


def test_columnar_sample_add_matches_per_sample():
    rng = np.random.default_rng(3)
    ents = [PartitionEntity(0, i) for i in range(40)] + [PartitionEntity(0, 7)]
    a = WindowedMetricSampleAggregator(3, 1000, 1, KAFKA_METRIC_DEF)
    b = WindowedMetricSampleAggregator(3, 1000, 1, KAFKA_METRIC_DEF)
    for w in range(4):
        vals = rng.uniform(-5, 50, (len(ents), M)).astype(np.float32)
        t = w * 1000 + 123
        assert a.add_samples_columnar(ents, t, vals)
        for e, v in zip(ents, vals):
            b.add_sample(e, t, v)
    ra, rb = a.aggregate(), b.aggregate()
    assert a.entity_index() == b.entity_index()
    np.testing.assert_array_equal(ra.values, rb.values)
    np.testing.assert_array_equal(ra.window_valid, rb.window_valid)
    np.testing.assert_array_equal(ra.entity_valid, rb.entity_valid)


def test_cluster_model_columnar_path_at_modest_scale():
    topo = synthetic_topology(num_brokers=12, topics={"a": 40, "b": 60}, seed=2)
    cols = topo.columns()
    ents = [PartitionEntity(int(t), int(p)) for t, p in zip(cols.part_topic, cols.part_num)]
    agg = WindowedMetricSampleAggregator(3, 1000, 1, KAFKA_METRIC_DEF)
    rng = np.random.default_rng(0)
    for w in range(4):
        agg.add_samples_columnar(ents, w * 1000 + 5, rng.uniform(1, 10, (len(ents), M)).astype(np.float32))
    monitor = LoadMonitor(StaticMetadataProvider(topo), FixedCapacityResolver(CAPACITY), agg, device="cpu")
    state = monitor.cluster_model(ModelCompletenessRequirements(**REQ2))
    assert state.shape.P == 100
    assert validate(state) == []
    lead = state.replica_load_leader[state.replica_is_leader & state.replica_valid]
    assert (lead.sum(1) > 0).all()
    assert monitor.last_catalog.partition_key(0)[0] in ("a", "b")


# --------------------------------------------- parity with the JAX package


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _keys(entities):
    return [(e.topic, e.partition) for e in entities]


def _same_aggregation(ra, rb, what):
    for f in ("window_indices", "values", "window_valid", "extrapolation", "entity_valid"):
        _same(getattr(ra, f), getattr(rb, f), f"{what}: {f}")
    ca, cb = ra.completeness, rb.completeness
    assert ca.generation == cb.generation, what
    _same(ca.valid_windows, cb.valid_windows, f"{what}: valid_windows")
    _same(ca.valid_entity_ratio_by_window, cb.valid_entity_ratio_by_window, f"{what}: ratio_by_window")
    assert ca.valid_entity_ratio == cb.valid_entity_ratio, what
    assert ca.valid_entity_group_ratio == cb.valid_entity_group_ratio, what


def _same_history(ha, hb, what):
    for f in ("window_indices", "values", "sample_counts", "complete"):
        _same(getattr(ha, f), getattr(hb, f), f"{what}: {f}")
    assert ha.window_ms == hb.window_ms and ha.generation == hb.generation, what
    assert _keys(ha.entities) == _keys(hb.entities), what


def _same_delta(da, db, what):
    assert _keys(da.entities) == _keys(db.entities), what
    _same(da.loads, db.loads, f"{what}: loads")
    _same(da.changed, db.changed, f"{what}: changed")
    for f in ("added", "removed", "stale"):
        assert _keys(getattr(da, f)) == _keys(getattr(db, f)), (what, f)
    assert da.windows_advanced == db.windows_advanced, what
    _same(da.reduced.loads, db.reduced.loads, f"{what}: reduced")
    _same(da.reduced.usable, db.reduced.usable, f"{what}: usable")


OPTIONS = (
    dict(),
    dict(min_valid_entity_ratio=0.5, max_allowed_extrapolations_per_entity=1),
    dict(min_valid_entity_ratio=0.2, granularity="ENTITY_GROUP"),
)


def test_aggregation_history_and_delta_match_jax_over_rolls():
    """One seeded stream into both aggregators: per window each entity gets
    0-5 samples (min_samples 4, so every extrapolation kind occurs), some
    windows are skipped, a jump recycles the whole ring, late samples are
    rejected, entities and topics join mid-stream, and the per-sample and
    columnar adds alternate.  After every window: aggregate() under three
    option sets, history_snapshot and the delta from the previous
    snapshot, all bit for bit; every add's verdict too."""
    from cruise_control_tpu.monitor import aggregator as jagg
    from cruise_control_tpu.monitor import delta as jdelta
    from cruise_control_tpu.monitor.metricdef import KAFKA_METRIC_DEF as JDEF
    from cruise_control_tpu.monitor.sampling import PartitionEntity as JEntity
    from cruise_control_tpu_torch.monitor import aggregator as tagg
    from cruise_control_tpu_torch.monitor import delta as tdelta

    rng = np.random.default_rng(16)
    a_t = tagg.WindowedMetricSampleAggregator(4, WINDOW_MS, 4, KAFKA_METRIC_DEF, initial_capacity=8)
    a_j = jagg.WindowedMetricSampleAggregator(4, WINDOW_MS, 4, JDEF, initial_capacity=8)
    n_ent = 24
    windows = [0, 1, 2, 3, 5, 6, 7, 8, 15, 16, 17, 18]  # 4 skipped, then a jump of 7
    prev = None
    checked = 0
    seen_ext, rejected = set(), 0
    for wi, w in enumerate(windows):
        live = n_ent if wi < 6 else n_ent + 6  # six entities (a new topic) join
        keys = [(t % 5, t) for t in range(live)]
        counts = rng.integers(0, 6, live)
        counts[rng.random(live) < 0.1] = 0
        if wi % 2:
            # per-sample adds at random times inside the window
            for k, c in zip(keys, counts):
                for _ in range(c):
                    t = int(w * WINDOW_MS + rng.integers(0, WINDOW_MS))
                    v = rng.uniform(-1, 100, M).astype(np.float32)
                    ok_t = a_t.add_sample(PartitionEntity(*k), t, v, group=k[0])
                    ok_j = a_j.add_sample(JEntity(*k), t, v, group=k[0])
                    assert ok_t == ok_j
        else:
            # columnar adds, one batch per sample index, duplicates included
            for s in range(int(counts.max()) + 1):
                sel = [k for k, c in zip(keys, counts) if c > s] + keys[:2]
                t = int(w * WINDOW_MS + 10 * s + 1)
                v = rng.uniform(-1, 100, (len(sel), M)).astype(np.float32)
                ok_t = a_t.add_samples_columnar([PartitionEntity(*k) for k in sel], t, v,
                                                groups=[k[0] for k in sel])
                ok_j = a_j.add_samples_columnar([JEntity(*k) for k in sel], t, v,
                                                groups=[k[0] for k in sel])
                assert ok_t == ok_j
        # a late sample for a window that rolled out
        late = int((w - 6) * WINDOW_MS)
        v = rng.uniform(0, 1, M).astype(np.float32)
        ok = a_t.add_sample(PartitionEntity(0, 0), late, v)
        assert ok == a_j.add_sample(JEntity(0, 0), late, v)
        rejected += not ok
        if wi == 0:
            continue
        for opts in OPTIONS:
            r_t = a_t.aggregate(tagg.AggregationOptions(**opts))
            _same_aggregation(r_t, a_j.aggregate(jagg.AggregationOptions(**opts)), f"window {w} {opts}")
            seen_ext.update(np.unique(r_t.extrapolation).tolist())
        h_t, h_j = a_t.history_snapshot(), a_j.history_snapshot()
        _same_history(h_t, h_j, f"window {w}")
        if prev is not None:
            d_t = tdelta.extract_window_delta(prev[0], h_t, KAFKA_METRIC_DEF)
            d_j = jdelta.extract_window_delta(prev[1], h_j, JDEF)
            _same_delta(d_t, d_j, f"delta to window {w}")
            checked += 1
        prev = (h_t, h_j)
    _same(a_t.entity_key_rows()[0], a_j.entity_key_rows()[0], "entity keys")
    _same(a_t.entity_key_rows()[1], a_j.entity_key_rows()[1], "entity rows")
    assert checked == len(windows) - 2
    # the stream reached every extrapolation kind and rejected late samples
    assert seen_ext == {0, 1, 2, 3, 4} and rejected > 0


def test_synthetic_samplers_match_jax():
    from cruise_control_tpu.testing import synthetic as jsyn

    kw = dict(num_brokers=7, num_racks=3, topics={"A": 9, "B": 5, "C": 4}, replication=3,
              dead_brokers=(2,), seed=11)
    tt, jt = synthetic_topology(**kw), jsyn.synthetic_topology(**kw)
    assert [dataclasses.astuple(b) for b in tt.brokers] == [dataclasses.astuple(b) for b in jt.brokers]
    assert [dataclasses.astuple(p) for p in tt.partitions] == [dataclasses.astuple(p) for p in jt.partitions]
    spec = dict(topic_multipliers={"B": 3.0}, jitter=0.1)
    ts = SyntheticWorkloadSampler(tt, WorkloadSpec(**spec), seed=5)
    js = jsyn.SyntheticWorkloadSampler(jt, jsyn.WorkloadSpec(**spec), seed=5)
    parts_t, parts_j = ts.all_partition_entities(), js.all_partition_entities()
    assert _keys(parts_t) == _keys(parts_j)
    for w in range(3):
        if w == 2:
            ts.drift(1.07, topic="A")
            js.drift(1.07, topic="A")
        rt = ts.get_samples(parts_t[w:], w * WINDOW_MS, (w + 1) * WINDOW_MS - 1)
        rj = js.get_samples(parts_j[w:], w * WINDOW_MS, (w + 1) * WINDOW_MS - 1)
        assert _keys(s.entity for s in rt.partition_samples) == _keys(s.entity for s in rj.partition_samples)
        assert [s.entity.broker_id for s in rt.broker_samples] == [s.entity.broker_id for s in rj.broker_samples]
        for a, b in zip(rt.partition_samples + rt.broker_samples, rj.partition_samples + rj.broker_samples):
            assert a.time_ms == b.time_ms
            _same(a.values, b.values, f"window {w} sample values")


def _same_model(t_state, t_catalog, j_state, j_catalog):
    assert dataclasses.asdict(t_state.shape) == dataclasses.asdict(j_state.shape)
    got = to_numpy(t_state)
    for f in STATE_FIELDS:
        _same(got[f], np.asarray(getattr(j_state, f)), f)
    for f in ("topics", "partitions", "racks", "hosts"):
        assert tuple(getattr(t_catalog, f)) == tuple(getattr(j_catalog, f)), f


@pytest.mark.parametrize("variant", ["plain", "bucketed", "jbod"])
def test_cluster_model_matches_jax(variant, tmp_path):
    """The same monitored cluster through both packages' LoadMonitor:
    every field of the built state, byte for byte, and the catalog."""
    from cruise_control_tpu.models.state import ShapeBucketPolicy as JPolicy
    from cruise_control_tpu.monitor import FileCapacityResolver as JFile
    from cruise_control_tpu_torch.models.state import ShapeBucketPolicy as TPolicy

    jp = _jax_package()
    tkw, jkw = dict(device="cpu"), {}
    if variant == "bucketed":
        tkw["bucket_policy"] = TPolicy(growth=1.3, floor=5)
        jkw["bucket_policy"] = JPolicy(growth=1.3, floor=5)
    _, _, t_mon, _ = _monitored(PORT, **tkw)
    _, _, j_mon, _ = _monitored(jp, **jkw)
    if variant == "jbod":
        doc = {"brokerCapacities": JBOD_DOC["brokerCapacities"] + [
            {"brokerId": "3", "capacity": {"DISK": {"/a": "4e5", "/b": "1e5", "/c": "2e5"},
                                           "CPU": "90", "NW_IN": "6e4", "NW_OUT": "6e4"}}]}
        p = tmp_path / "capacity.json"
        p.write_text(json.dumps(doc))
        t_mon.capacity_resolver, j_mon.capacity_resolver = FileCapacityResolver(str(p)), JFile(str(p))
    t_state = t_mon.cluster_model(ModelCompletenessRequirements(**REQ2))
    j_state = j_mon.cluster_model(jp["Requirements"](**REQ2))
    _same_model(t_state, t_mon.last_catalog, j_state, j_mon.last_catalog)
    if variant == "jbod":
        assert t_state.shape.max_disks_per_broker == 3
    if variant == "bucketed":
        assert t_state.shape.R > int(t_state.replica_valid.sum())


def test_monitor_to_optimizer_placements_match_jax():
    """The slice as a whole: monitored samples -> cluster_model ->
    optimize on the 6-broker monitored cluster, in both packages: the
    port's placements equal the JAX package's byte for byte."""
    from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
    from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig

    jp = _jax_package()
    _, _, t_mon, _ = _monitored(PORT, device="cpu")
    _, _, j_mon, _ = _monitored(jp)
    t_state = t_mon.cluster_model(ModelCompletenessRequirements(**REQ2))
    j_state = j_mon.cluster_model(jp["Requirements"](**REQ2))
    tr = GoalOptimizer(config=OptimizerConfig(**E2E), device="cpu").optimize(t_state)
    jr = JOptimizer(config=JConfig(**E2E)).optimize(j_state)
    for f in ("replica_broker", "replica_is_leader", "replica_disk", "replica_offline"):
        _same(getattr(tr.state_after, f).numpy(), np.asarray(getattr(jr.state_after, f)), f)
    assert len(tr.proposals) == len(jr.proposals) > 0
    assert [h["accepted"] for h in tr.history if "round" in h] == \
        [h["accepted"] for h in jr.history if "round" in h]


def _port_state(js):
    from cruise_control_tpu_torch.convert import from_jax_arrays

    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


@pytest.mark.parametrize("case", ["small_cluster", "rack_violated_cluster", "dead_broker_cluster",
                                  "jbod_cluster", "padded", "wide"])
def test_partition_replica_table_matches_jax(case):
    from cruise_control_tpu.analyzer.engine import partition_replica_table as j_table
    from cruise_control_tpu.models.builder import pad_state as j_pad
    from cruise_control_tpu.models.state import ShapeBucketPolicy as JPolicy
    from cruise_control_tpu.testing import fixtures as jf
    from cruise_control_tpu_torch.analyzer.engine import partition_replica_table

    js = getattr(jf, case if case not in ("padded", "wide") else "rack_violated_cluster")()
    max_rf = None
    if case == "padded":
        js = j_pad(js, JPolicy(growth=1.5, floor=7).bucket_shape(js.shape))
        assert js.shape.R > int(np.asarray(js.replica_valid).sum())
    if case == "wide":
        max_rf = 5
    ts = _port_state(js)
    want = j_table(js, max_rf)
    _same(partition_replica_table(ts, max_rf), want, case)
    host = {f: getattr(ts, f).numpy() for f in ("replica_valid", "replica_partition", "replica_pos")}
    _same(partition_replica_table(ts, max_rf, host=host), want, f"{case} host=")
    if case == "wide":
        assert want.shape[1] == 5


def _same_results(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for xs, ys in ((ra.partition_samples, rb.partition_samples), (ra.broker_samples, rb.broker_samples)):
            assert [dataclasses.astuple(s.entity) for s in xs] == [dataclasses.astuple(s.entity) for s in ys]
            assert [s.time_ms for s in xs] == [s.time_ms for s in ys]
            for s, t in zip(xs, ys):
                _same(s.values, t.values, "stored sample values")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_sample_store_files_cross_load(writer, tmp_path):
    """npz files one package's FileSampleStore writes load in the other's
    with the same samples; a warm restart from the JAX package's files
    gives the JAX package's own warm-restart model, byte for byte."""
    from cruise_control_tpu.monitor import FileSampleStore as JStore
    from cruise_control_tpu_torch.monitor import FileSampleStore as TStore

    jp = _jax_package()
    d = str(tmp_path / "store")
    src_pkg, src_store = (jp, JStore(d)) if writer == "jax" else (PORT, TStore(d))
    _monitored(src_pkg, store=src_store, **({} if writer == "jax" else dict(device="cpu")))
    loaded_t, loaded_j = TStore(d).load(), JStore(d).load()
    assert len(loaded_t) == 4
    _same_results(loaded_t, loaded_j)
    if writer != "jax":
        return
    topo = synthetic_topology(num_brokers=6, topics={"T0": 12, "T1": 12}, seed=2)
    jtopo = jp["synthetic_topology"](num_brokers=6, topics={"T0": 12, "T1": 12}, seed=2)
    models = []
    for pkg, store, tp, kw in ((PORT, TStore(d), topo, dict(device="cpu")), (jp, JStore(d), jtopo, {})):
        agg = pkg["Aggregator"](num_windows=3, window_ms=WINDOW_MS, min_samples_per_window=1,
                                metric_def=pkg["METRIC_DEF"])
        fetcher = pkg["MetricFetcherManager"](None, agg, None, sample_store=store)
        assert fetcher.load_samples() == 4 * 24
        mon = pkg["LoadMonitor"](pkg["StaticMetadataProvider"](tp), pkg["FixedCapacityResolver"](CAPACITY),
                                 agg, **kw)
        models.append((mon.cluster_model(pkg["Requirements"](**REQ2)), mon.last_catalog))
    _same_model(*models[0], *models[1])
