"""The JAX package's tests/test_controller.py, pointed at the port on the CPU,
and the port's own controller tests.

tests/test_torch_prior.py holds seven of the JAX file's 28 tests (the cold
and warm prior, the prior's rebind, its placeholder, fitting, decay and
churn); the other 21 are here, each under its JAX name.  Where another port
test already holds the case under another name, the docstring says so.

The port's own: `DispatchMeter.total`; a published result served the same
before and after the next window's scatter into the live loads (the port
scatters in place where the JAX package donates); a failed fused cycle
counted by the loop and followed by a re-flatten ("failed-cycle"); a stop
while a cycle holds `kernels.graph_lock`; a fused cycle only on an engine
bound to its own live state (`Engine.bound_to`), after a re-flatten and
between two clusters of a fleet that share a bucket.
"""

import dataclasses as dc
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import OptimizerConfig
from cruise_control_tpu_torch.analyzer.engine import Engine
from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.common.dispatch import count_dispatch, dispatch_meter
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.controller import StreamingController
from cruise_control_tpu_torch.models.whatif import LiveState
from cruise_control_tpu_torch.monitor.aggregator import WindowedMetricSampleAggregator
from cruise_control_tpu_torch.monitor.delta import extract_window_delta, reduce_complete_loads
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
from cruise_control_tpu_torch.monitor.sampling import PartitionEntity
from cruise_control_tpu_torch.service import main as service_main
from cruise_control_tpu_torch.service.main import build_simulated_service
from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

SMALL = RandomClusterSpec(num_brokers=12, num_partitions=200, num_racks=4, num_topics=6, skew=1.0)
CFG = OptimizerConfig(
    num_candidates=128, leadership_candidates=32, swap_candidates=16,
    steps_per_round=8, num_rounds=3, seed=0,
)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


def _placements(state):
    return tuple(getattr(state, f).numpy() for f in PLACEMENT)


def _same_placement(a, b) -> bool:
    return all(bool((x == y).all()) for x, y in zip(_placements(a), _placements(b)))


def _small(seed):
    return random_cluster_fast(SMALL, seed=seed, device="cpu")


# ---------------------------------------------------------------- dispatch


def test_dispatch_meter_total_sums_counts_and_nested_meters_see_every_count():
    """`total` is the sum of `counts`; an outer and an inner meter each see
    every count made while they are active, and `__repr__` shows it."""
    with dispatch_meter() as outer:
        count_dispatch("engine.cycle")
        with dispatch_meter() as inner:
            count_dispatch("engine.extract")
            count_dispatch("livestate.scatter", 3)
        count_dispatch("engine.cycle")
    assert inner.counts == {"engine.extract": 1, "livestate.scatter": 3}
    assert inner.total == 4 == sum(inner.counts.values())
    assert outer.counts == {"engine.cycle": 2, "engine.extract": 1, "livestate.scatter": 3}
    assert outer.total == 6 == sum(outer.counts.values())
    assert "total=6" in repr(outer)
    count_dispatch("engine.sync")  # no meter active: nothing to see it
    assert outer.total == 6


# ---------------------------------------------------------------- engine


def test_warm_start_carry_fused_and_legacy_agree():
    """The warm start threads through both round loops; at a fixed seed the
    two produce identical warm-started trajectories."""
    state = _small(3)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    first, _ = eng.run()
    init = (first.replica_broker, first.replica_is_leader, first.replica_disk)
    fused, _ = eng.run(initial_placement=init)
    legacy_eng = Engine(state, DEFAULT_CHAIN, config=dc.replace(CFG, fused_rounds=False))
    legacy, _ = legacy_eng.run(initial_placement=init)
    assert _same_placement(fused, legacy)


def test_warm_start_does_not_corrupt_the_source_placement():
    """The run's carry is seeded from the caller's placement tensors: they
    must be COPIED first, or the run scribbles over the published result's
    state_after."""
    state = _small(3)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    first, _ = eng.run()
    before = tuple(x.copy() for x in _placements(first))
    eng.run(initial_placement=(first.replica_broker, first.replica_is_leader, first.replica_disk))
    after = _placements(first)
    assert all(bool((a == b).all()) for a, b in zip(before, after))


def test_proposal_set_destination_pairs():
    """The columnar extraction must report exactly the brokers RECEIVING a
    replica they did not hold."""
    from cruise_control_tpu_torch.analyzer.proposals import extract_proposals

    state = _small(3)
    final, _ = Engine(state, DEFAULT_CHAIN, config=CFG).run()
    ps = extract_proposals(state, final)
    tids, dsts = ps.destination_pairs()
    assert len(tids) == len(dsts)
    expected = []
    for p in ps:
        old = set(p.old_replicas)
        for b in p.new_replicas:
            if b not in old:
                expected.append((int(p.topic), int(b)))
    assert sorted(zip(tids.tolist(), dsts.tolist())) == sorted(expected)


# ------------------------------------------------------- window delta path


def _agg(num_windows=4, window_ms=1000, min_samples=2):
    return WindowedMetricSampleAggregator(
        num_windows=num_windows, window_ms=window_ms,
        min_samples_per_window=min_samples, metric_def=KAFKA_METRIC_DEF,
    )


def _sample(agg, entity, t_ms, cpu=1.0, nwin=10.0, nwout=5.0, disk=100.0):
    m = agg.metric_def
    vals = np.zeros(m.num_metrics, np.float32)
    vals[m.metric_id("CPU_USAGE")] = cpu
    vals[m.metric_id("LEADER_BYTES_IN")] = nwin
    vals[m.metric_id("LEADER_BYTES_OUT")] = nwout
    vals[m.metric_id("DISK_USAGE")] = disk
    agg.add_sample(entity, t_ms, vals)


def test_delta_partial_window_does_not_read_as_traffic_drop():
    """A half-sampled window holds a partial average; the completeness mask
    keeps it out of the reduction, so the entity's loads hold steady."""
    agg = _agg(min_samples=2)
    e = PartitionEntity(0, 0)
    for w in range(3):
        _sample(agg, e, w * 1000 + 100, nwin=10.0)
        _sample(agg, e, w * 1000 + 600, nwin=10.0)
    _sample(agg, e, 3500)
    prev = agg.history_snapshot()
    _sample(agg, e, 4500)
    cur = agg.history_snapshot()
    delta = extract_window_delta(prev, cur, agg.metric_def)
    assert not delta.requires_reflatten
    red = reduce_complete_loads(cur, agg.metric_def)
    i = cur.entities.index(e)
    assert red.loads[i][Resource.NW_IN] == pytest.approx(10.0)
    if delta.entities:
        j = delta.entities.index(e)
        assert delta.loads[j][Resource.NW_IN] == pytest.approx(10.0)


def test_delta_entity_with_no_complete_window_is_stale_not_zero():
    agg = _agg(min_samples=3)
    e = PartitionEntity(0, 0)
    for w in range(3):
        _sample(agg, e, w * 1000 + 100)
    _sample(agg, e, 3500)
    prev = agg.history_snapshot()
    _sample(agg, e, 4500)
    cur = agg.history_snapshot()
    delta = extract_window_delta(prev, cur, agg.metric_def)
    assert e in delta.stale
    assert e not in delta.entities


def test_delta_mid_stream_topic_add_and_remove_force_reflatten():
    agg = _agg(min_samples=1)
    a, b = PartitionEntity(0, 0), PartitionEntity(1, 0)
    _sample(agg, a, 100)
    _sample(agg, a, 1100)
    _sample(agg, a, 2100)
    prev = agg.history_snapshot()
    _sample(agg, b, 3100)
    _sample(agg, a, 3200)
    cur = agg.history_snapshot()
    delta = extract_window_delta(prev, cur, agg.metric_def)
    assert delta.added == (b,)
    assert delta.requires_reflatten
    back = extract_window_delta(cur, prev, agg.metric_def)
    assert back.removed == (b,)
    assert back.requires_reflatten


def test_delta_reports_changed_loads_absolute():
    """Also held over whole window rolls against the JAX package by
    tests/test_torch_monitor.py::test_aggregation_history_and_delta_match_jax_over_rolls."""
    agg = _agg(min_samples=1)
    e0, e1 = PartitionEntity(0, 0), PartitionEntity(0, 1)
    for w in range(3):
        _sample(agg, e0, w * 1000 + 100, nwin=10.0)
        _sample(agg, e1, w * 1000 + 100, nwin=20.0)
    _sample(agg, e0, 3100, nwin=40.0)
    _sample(agg, e1, 3100, nwin=20.0)
    prev = agg.history_snapshot()
    _sample(agg, e0, 4100, nwin=40.0)
    _sample(agg, e1, 4100, nwin=20.0)
    cur = agg.history_snapshot()
    delta = extract_window_delta(prev, cur, agg.metric_def)
    by_e = dict(zip(delta.entities, zip(delta.loads, delta.changed)))
    l0, c0 = by_e[e0]
    l1, c1 = by_e[e1]
    assert bool(c0) and not bool(c1)
    assert l0[Resource.NW_IN] > 10.0
    assert l1[Resource.NW_IN] == pytest.approx(20.0)


# ------------------------------------------------------------- live state


def test_live_state_scatter_matches_host_update_and_preserves_rest():
    """Also held against the JAX package by
    tests/test_torch_streaming.py::test_live_state_scatter_matches_jax."""
    state = _small(9)
    live = LiveState(state)
    rows = np.asarray([0, 3, 7], np.int32)
    ll = np.full((3, 4), 42.0, np.float32)
    fl = np.full((3, 4), 21.0, np.float32)
    rb_before = state.replica_broker.numpy().copy()
    ll_before = state.replica_load_leader.numpy().copy()
    live.set_partition_loads(rows, ll, fl)
    out = live.state.replica_load_leader.numpy()
    assert (out[rows] == 42.0).all()
    assert (live.state.replica_load_follower.numpy()[rows] == 21.0).all()
    untouched = np.setdiff1d(np.arange(state.shape.R), rows)
    assert np.array_equal(out[untouched], ll_before[untouched])
    assert np.array_equal(live.state.replica_broker.numpy(), rb_before)


def test_live_state_broker_liveness_rederives_offline():
    """Also held against the JAX package by
    tests/test_torch_streaming.py::test_live_state_broker_liveness_matches_jax."""
    state = _small(9)
    live = LiveState(state)
    alive = state.broker_alive.numpy().copy()
    victim = int(state.replica_broker[0])
    alive[victim] = False
    live.set_broker_liveness(alive)
    st = live.state
    off, rb, rv = st.replica_offline.numpy(), st.replica_broker.numpy(), st.replica_valid.numpy()
    assert (off[(rb == victim) & rv]).all()


# ------------------------------------------------------- controller loop


def _controller_service(extra=None, seed=5, **kw):
    props = {
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "num.partition.metrics.windows": 3,
        "execution.progress.check.interval.ms": 100,
        "webserver.http.port": 0,
        "tpu.num.candidates": 128,
        "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 16,
        "tpu.num.rounds": 2,
        "controller.enabled": True,
        "controller.prior.min.observations": 8,
    }
    props.update(extra or {})
    return build_simulated_service(CruiseControlConfig(props), seed=seed, device="cpu", **kw)


def _replay(ctl, fetcher, sampler, windows, drift=1.05):
    parts = sampler.all_partition_entities()
    infos = []
    for w in windows:
        sampler.drift(drift)
        fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
        info = ctl.run_once()
        assert info is not None
        infos.append(info)
    return infos


@pytest.fixture(scope="module")
def default_replay():
    """One controller service at the defaults, fed windows 4-8: shared by
    the tests that only read what that replay did."""
    app, fetcher, admin, sampler = _controller_service()
    try:
        yield app, _replay(app.cc.controller, fetcher, sampler, range(4, 9))
    finally:
        app.stop()


def test_controller_replay_delta_path_and_publish(default_replay):
    app, _ = default_replay
    cc = app.cc
    ctl = cc.controller
    assert isinstance(ctl, StreamingController)
    stats = ctl.state_json()
    assert stats["fullReflattens"] == 1
    assert stats["deltaApplies"] == 4
    assert stats["proposalsPublished"] == 5
    assert stats["warmStarts"] == 4
    assert cc._valid_cache() is not None
    assert cc._cache.source == "controller"
    st = cc.state()
    assert st["ControllerState"]["windowRolls"] == 5
    assert st["AnalyzerState"]["proposalSource"] == "controller"
    assert ctl.run_once() is None


def test_controller_delta_bridges_first_seen_vs_catalog_topic_ids():
    """Aggregator entities carry FIRST-SEEN topology topic ids; the
    catalog/state ids are name-rank.  With topics first seen out of name
    order ("zeta" before "alpha"), a spike on zeta must land on ZETA's
    replica rows."""
    app, fetcher, admin, sampler = _controller_service(topics={"zeta": 6, "alpha": 6})
    try:
        cc = app.cc
        ctl = cc.controller
        parts = sampler.all_partition_entities()
        fetcher.fetch_once(parts, 4000, 4999)
        assert ctl.run_once() is not None
        catalog = cc.monitor.last_catalog
        assert catalog.topics == ("alpha", "zeta")
        zeta_id = catalog.topic_id("zeta")
        st0 = ctl._live.state
        topic = st0.replica_topic.numpy()
        valid = st0.replica_valid.numpy()
        before = st0.replica_load_leader.numpy().copy()
        sampler.drift(4.0, topic="zeta")
        fetcher.fetch_once(parts, 5000, 5999)
        info = ctl.run_once()
        assert info is not None and not info["reflattened"]
        fetcher.fetch_once(parts, 6000, 6999)
        info = ctl.run_once()
        assert info is not None and not info["reflattened"]
        assert info["delta_partitions"] > 0
        after = ctl._live.state.replica_load_leader.numpy()
        zeta_rows = valid & (topic == zeta_id)
        alpha_rows = valid & (topic != zeta_id)
        assert (after[zeta_rows, Resource.NW_IN] > before[zeta_rows, Resource.NW_IN]).all()
        assert (after[alpha_rows, Resource.NW_IN]
                < 2.0 * np.maximum(before[alpha_rows, Resource.NW_IN], 1e-9)).all()
    finally:
        app.stop()


def test_controller_cold_mode_matches_direct_optimize():
    """Cold parity: warm start off + delta off + prior mix 0 equals the
    flatten-and-anneal pipeline byte for byte."""
    app, fetcher, admin, sampler = _controller_service({
        "controller.warm.start.enabled": False,
        "controller.delta.enabled": False,
        "controller.prior.mix": 0.0,
    })
    try:
        cc = app.cc
        ctl = cc.controller
        infos = _replay(ctl, fetcher, sampler, range(4, 7))
        assert ctl.state_json()["fullReflattens"] == 3
        fresh = cc.monitor.cluster_model()
        direct = cc.optimizer.optimize(fresh, options=cc._build_options(fresh))
        assert _same_placement(infos[-1]["result"].state_after, direct.state_after)
    finally:
        app.stop()


def test_publish_supersede_keeps_freshest_generation():
    from cruise_control_tpu_torch.monitor.load_monitor import ModelGeneration

    app, fetcher, admin, sampler = _controller_service()
    try:
        cc = app.cc
        info = _replay(cc.controller, fetcher, sampler, [4])[0]
        result = info["result"]
        assert cc._valid_cache() is not None
        gen_at_publish = cc._cache.model_generation
        assert cc.publish_proposal(result) is True
        cc._cache.model_generation = ModelGeneration(
            metadata_generation=gen_at_publish.metadata_generation + 1,
            load_generation=gen_at_publish.load_generation,
        )
        assert cc.publish_proposal(result) is False
    finally:
        app.stop()


def test_controller_survives_unrelated_model_builds():
    """A detector round (or any cache-miss request) building a model bumps
    the monitor's load generation; that neither evicts the controller's
    published proposal nor sidelines its future publishes."""
    app, fetcher, admin, sampler = _controller_service()
    try:
        cc = app.cc
        ctl = cc.controller
        _replay(ctl, fetcher, sampler, [4])
        assert cc._valid_cache() is not None
        cc.monitor.cluster_model()
        assert cc._valid_cache() is not None
        assert cc._cache.source == "controller"
        info = _replay(ctl, fetcher, sampler, [5])[0]
        assert info["published"]
    finally:
        app.stop()


def test_controller_lifecycle_and_precompute_standdown():
    """start_up starts the controller thread (and not the legacy precompute
    loop beside it); shutdown joins it."""
    app, fetcher, admin, sampler = _controller_service()
    try:
        cc = app.cc
        cc.start_up(precompute=True)
        assert cc.controller.running
        assert cc._precompute_thread is None
        cc.shutdown()
        assert not cc.controller.running
    finally:
        app.stop()


def test_controller_config_keys_parse_and_gate_construction():
    cfg = CruiseControlConfig({})
    assert cfg.get("controller.enabled") is False
    with pytest.raises(Exception):
        CruiseControlConfig({"controller.prior.mix": 1.5})
    cfg2 = CruiseControlConfig({
        "tpu.compile.cache.dir": "/tmp/a", "tpu.compilation.cache.dir": "/tmp/b",
    })
    assert cfg2.compile_cache_dir() == "/tmp/a"
    assert CruiseControlConfig({}).compile_cache_dir() is not None
    app, *_ = _controller_service({"controller.enabled": False})
    try:
        assert app.cc.controller is None
    finally:
        app.stop()


# ------------------------------------------------------------ fused cycle


def test_fused_cycle_matches_staged_path_byte_for_byte(default_replay):
    """The fused scatter -> re-anneal -> extract cycle publishes the same
    placements as the staged scatter-then-anneal path, every window; a
    fused cycle counts at most two dispatches, and fusion off pins the
    staged path."""
    app, infos = default_replay
    runs = {True: ([_placements(i["result"].state_after) for i in infos], infos,
                   app.cc.controller.state_json())}
    app, fetcher, admin, sampler = _controller_service({"controller.fusion.enabled": False})
    try:
        ctl = app.cc.controller
        infos = _replay(ctl, fetcher, sampler, range(4, 9))
        runs[False] = ([_placements(i["result"].state_after) for i in infos], infos,
                       ctl.state_json())
    finally:
        app.stop()
    on_p, on_i, on_s = runs[True]
    off_p, off_i, off_s = runs[False]
    assert on_s["fusedCycles"] > 0 and off_s["fusedCycles"] == 0
    assert not on_i[0].get("fused")
    for a, b in zip(on_p, off_p):
        for x, y in zip(a, b):
            assert (x == y).all()
    for info in on_i:
        if info.get("fused"):
            assert sum(info["dispatches"].values()) <= 2
    assert on_s["lastCycleDispatches"] <= 2


def test_cold_cycle_histogram_exclusion_and_one_shot_sensors(default_replay):
    """The first published cycle (engine build and capture) and the first
    fused cycle stay OUT of the steady-state window-roll-to-publish
    histogram; each reports through its own one-shot sensor."""
    app, infos = default_replay
    n = len(infos)
    assert n == 5
    stats = app.cc.controller.state_json()
    assert stats["proposalsPublished"] == n
    assert stats["coldCycleSeconds"] is not None
    assert stats["fusedColdCycleSeconds"] is not None
    hist = app.cc.sensors.get("controller.window-roll-to-publish-seconds")
    assert hist is not None and hist.count == n - 2
    assert app.cc.sensors.gauge("controller.cold-compile-cycle-seconds").value > 0.0
    assert app.cc.sensors.gauge("controller.fused-cold-compile-cycle-seconds").value > 0.0


def test_reflatten_reason_counters(default_replay):
    """fullReflattens stays the aggregate; fullReflattensByReason breaks it
    down, and the reasons always sum to the aggregate."""
    app, fetcher, admin, sampler = _controller_service({"controller.delta.enabled": False})
    try:
        ctl = app.cc.controller
        _replay(ctl, fetcher, sampler, range(4, 7))
        stats = ctl.state_json()
        assert stats["fullReflattens"] == 3
        assert stats["fullReflattensByReason"] == {"initial": 1, "delta-disabled": 2}
        assert sum(stats["fullReflattensByReason"].values()) == stats["fullReflattens"]
    finally:
        app.stop()
    app, _ = default_replay
    assert app.cc.controller.state_json()["fullReflattensByReason"] == {"initial": 1}


# ------------------------------------------------------- delta-sized plans


def test_plan_config_quantized_ladder():
    """Delta-sized plans quantize to 1/2, 1/4 or 1/8 of full K, hold the
    brownout floors, and return the SAME config object at full K so the
    engine cache key is stable."""
    app, fetcher, admin, sampler = _controller_service({
        "tpu.num.candidates": 1024,
        "controller.plan.min.candidates": 64,
        "controller.plan.candidates.per.partition": 4,
    })
    try:
        ctl = app.cc.controller
        cfg = ctl._opt_config
        tiny = ctl._plan_config(cfg, 4)
        assert tiny.num_candidates == 128
        mid = ctl._plan_config(cfg, 64)
        assert mid.num_candidates == 256
        assert ctl._plan_config(cfg, 4) == tiny
        assert ctl._plan_config(cfg, 600) is cfg
        assert tiny.leadership_candidates >= 8
        assert tiny.swap_candidates >= 0
    finally:
        app.stop()


def test_delta_sized_plans_hold_goal_quality():
    """A delta-sized (1/8-width) steady-state plan lands the same goal
    quality as full K: equal-or-cleaner violations, objective within a few
    percent."""
    runs = {}
    for sizing in (True, False):
        app, fetcher, admin, sampler = _controller_service({
            "tpu.num.candidates": 1024,
            "tpu.num.rounds": 4,
            "tpu.steps.per.round": 24,
            "controller.plan.min.candidates": 64,
            "controller.plan.candidates.per.partition": 4,
            "controller.plan.sizing.enabled": sizing,
            "controller.fusion.enabled": False,
        })
        try:
            ctl = app.cc.controller
            infos = _replay(ctl, fetcher, sampler, range(4, 8))
            runs[sizing] = (infos[-1]["result"], ctl.state_json())
        finally:
            app.stop()
    sized_res, sized_stats = runs[True]
    full_res, full_stats = runs[False]
    assert sized_stats["planSizedCycles"] > 0
    assert full_stats["planSizedCycles"] == 0
    tol = 1e-6
    assert float(np.max(sized_res.violations_after)) <= max(float(np.max(full_res.violations_after)), tol)
    assert float(sized_res.objective_after) <= float(full_res.objective_after) * 1.05 + tol


# ------------------------------------------------------- the port's own


def _get(app, path):
    url = f"http://{app.host}:{app.port}{app.prefix}{path}"
    deadline = time.monotonic() + 60
    headers = {}
    while True:
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=30) as r:
            status, body, hdrs = r.status, json.loads(r.read()), dict(r.headers)
        if status != 202 or time.monotonic() > deadline:
            return status, body
        headers["User-Task-ID"] = hdrs["User-Task-ID"]
        time.sleep(0.02)


#: fields of a response that differ between two reads of one publish: the
#: request's ids and wall, and the cache's age
VOLATILE = {"_traceId", "_userTaskId", "wallSeconds", "cachedAgeMs", "ageMs"}


def _stable(body):
    if isinstance(body, dict):
        return {k: _stable(v) for k, v in body.items() if k not in VOLATILE}
    if isinstance(body, list):
        return [_stable(v) for v in body]
    return body


def test_published_result_serves_the_same_after_the_next_scatter(tmp_path):
    """The port scatters each window into the live load tensors in place
    (the JAX package donates them), so a published result's state_before
    shows the next window's loads.  Everything served from the publish is
    read from host-side fields: /proposals, /state's AnalyzerState and
    ControllerState, and the publish's decision record are the same before
    and after the next window's scatter."""
    app, fetcher, admin, sampler = _controller_service({"analyzer.ledger.dir": str(tmp_path / "ledger")})
    app.start()
    try:
        cc = app.cc
        ctl = cc.controller
        _replay(ctl, fetcher, sampler, range(4, 7))
        served = cc._cache
        assert served.source == "controller"
        result = served.result
        assert cc._valid_cache() is result
        assert result.state_before.replica_load_leader is ctl._live.state.replica_load_leader

        def snapshot():
            st, body = _get(app, "/proposals")
            assert st == 200
            state = cc.state(["analyzer", "controller"])
            record = cc.ledger.find(decision_id=cc._ledger_decision_id(result))
            assert record is not None and record["decision"]["source"] == "controller"
            return (_stable(body), _stable(state["AnalyzerState"]), _stable(state["ControllerState"]),
                    json.dumps(record, sort_keys=True, default=str))

        before = snapshot()
        loads_before = result.state_before.replica_load_leader.clone()
        # the next window's scatter, as a cycle makes it, without its publish
        rows = np.arange(0, ctl._live.shape.R, 3, dtype=np.int32)
        ll = ctl._live.state.replica_load_leader.numpy()[rows] * np.float32(1.5)
        fl = ctl._live.state.replica_load_follower.numpy()[rows] * np.float32(1.5)
        ctl._live.set_partition_loads(rows, ll, fl)
        assert not torch.equal(result.state_before.replica_load_leader, loads_before)
        assert cc._cache is served
        assert snapshot() == before
    finally:
        app.stop()


def test_failed_fused_cycle_is_counted_and_the_next_cycle_reflattens():
    """A fused cycle that raises is counted by the loop (loopFailures,
    lastError, controller.loop-failures) and the stale proposal keeps
    serving; its scatter into the live loads may or may not have run, so
    the next cycle re-flattens ("failed-cycle"), publishes, and the live
    loads are a fresh model's.  The JAX package's controller instead goes
    on with live loads that miss the failed window (ROADMAP queue 3)."""
    app, fetcher, admin, sampler = _controller_service({"controller.poll.interval.ms": 10})
    try:
        cc = app.cc
        ctl = cc.controller
        _replay(ctl, fetcher, sampler, range(4, 7))
        served = cc._valid_cache()
        opt = cc.optimizer
        calls = []

        def boom(*a, **kw):
            calls.append(1)
            # the loop ends after this cycle: the re-flatten below is run_once's
            ctl._stop.set()
            raise RuntimeError("CUDA out of memory (injected)")

        opt.optimize_streaming_cycle = boom
        try:
            sampler.drift(1.05)
            fetcher.fetch_once(sampler.all_partition_entities(), 7000, 7999)
            ctl.start()
            ctl._thread.join(30)
            ctl.stop()
        finally:
            del opt.optimize_streaming_cycle
        stats = ctl.state_json()
        assert calls == [1] and stats["loopFailures"] == 1
        assert "out of memory" in stats["lastError"]
        assert cc.sensors.counter("controller.loop-failures").count == 1
        assert cc._valid_cache() is served
        assert ctl._live_suspect
        info = _replay(ctl, fetcher, sampler, [8])[0]
        assert info["reflattened"] and info["reflatten_reason"] == "failed-cycle"
        assert info["published"] and not ctl._live_suspect
        assert ctl.state_json()["fullReflattensByReason"] == {"initial": 1, "failed-cycle": 1}
        fresh = cc.monitor.cluster_model()
        assert torch.equal(ctl._live.state.replica_load_leader, fresh.replica_load_leader)
        info = _replay(ctl, fetcher, sampler, [9])[0]
        assert not info["reflattened"] and info["fused"]
    finally:
        app.stop()


def test_stop_during_a_cycle_leaves_no_lock_held():
    """stop() joins for at most its timeout; a cycle in flight (here one
    that holds kernels.graph_lock, as a capture does) runs to its end on
    the loop thread, publishes, and the thread exits with the lock free."""
    app, fetcher, admin, sampler = _controller_service({"controller.poll.interval.ms": 10})
    try:
        cc = app.cc
        ctl = cc.controller
        inside, release = threading.Event(), threading.Event()
        orig = cc.optimizer.optimize

        def held(*a, **kw):
            with kernels.graph_lock():
                inside.set()
                release.wait(30)
                return orig(*a, **kw)

        cc.optimizer.optimize = held
        sampler.drift(1.05)
        fetcher.fetch_once(sampler.all_partition_entities(), 4000, 4999)
        ctl.start()
        thread = ctl._thread
        assert inside.wait(30)
        t0 = time.monotonic()
        ctl.stop(timeout_s=0.2)
        assert time.monotonic() - t0 < 5 and thread.is_alive()
        release.set()
        thread.join(30)
        assert not thread.is_alive()
        assert ctl.state_json()["proposalsPublished"] == 1
        lock = kernels.graph_lock()
        assert lock.acquire(blocking=False)
        lock.release()
    finally:
        release.set()
        app.stop()


def test_topology_reflatten_rebinds_every_plan_width_before_it_fuses():
    """A fused cycle runs on its engine's statics as the last rebind left
    them.  After a broker dies (a topology re-flatten), a plan width whose
    engine still holds the old flatten goes staged once (the optimizer's
    streaming cycle declines an engine bound to another state), which
    rebinds it, and fuses from then on: no cycle places a replica on the
    dead broker.  The JAX package's controller fuses on the stale engine
    (ROADMAP queue 3)."""
    app, fetcher, admin, sampler = _controller_service({
        "num.partition.metrics.windows": 1,
        "tpu.num.candidates": 256, "tpu.num.rounds": 3,
        "controller.plan.min.candidates": 64,
        "controller.plan.candidates.per.partition": 4,
    }, num_brokers=8, topics={"T0": 24, "T1": 24})
    try:
        sampler.spec = dc.replace(sampler.spec, jitter=0.0)
        ctl = app.cc.controller
        parts = sampler.all_partition_entities()
        dead = 0

        def roll(w):
            if w >= 5:
                sampler.drift(1.3, topic="T0")
            fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
            info = ctl.run_once()
            after = info["result"].state_after
            on_dead = int(((after.replica_broker == dead) & after.replica_valid).sum())
            return info, on_dead

        # full K reflattens and fuses; T0's 24 rows size the plan to K/2,
        # staged once, then fused
        infos = [roll(w)[0] for w in (4, 5, 6, 7)]
        assert [i["fused"] for i in infos] == [False, True, False, True]
        assert [i["delta_partitions"] for i in infos] == [0, 48, 24, 24]
        md = app.cc.monitor.metadata
        topo = md.topology()
        md.set_topology(dc.replace(topo, brokers=tuple(
            dc.replace(b, alive=b.broker_id != dead) for b in topo.brokers)))
        info, on_dead = roll(8)
        assert info["reflatten_reason"] == "topology" and on_dead == 0
        seen = []
        for w in (9, 10):
            info, on_dead = roll(w)
            assert info["delta_partitions"] == 24
            assert info["result"].state_before.broker_alive[dead].item() is False
            seen.append((info["fused"], on_dead))
        assert seen == [(False, 0), (True, 0)]
    finally:
        app.stop()


def test_engine_bound_to_tells_its_own_generation_and_options():
    """`Engine.bound_to` is True for the state of the last rebind, whatever
    its load tensors, under equal option masks; False for a state with
    another tensor (a liveness change), for other options, and once another
    state was bound."""
    state = _small(3)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    opts = OptimizationOptions()
    assert eng.bound_to(state, opts)
    loads = dc.replace(state, replica_load_leader=state.replica_load_leader * 2,
                       replica_load_follower=state.replica_load_follower.clone())
    assert eng.bound_to(loads, OptimizationOptions())
    live = LiveState(state)
    live.set_broker_liveness(np.arange(state.shape.B) != 0)
    assert not eng.bound_to(live.state, opts)
    excluded = np.zeros(state.shape.num_topics, bool)
    excluded[0] = True
    assert not eng.bound_to(state, OptimizationOptions(excluded_topics=excluded))
    eng.rebind(state, OptimizationOptions(excluded_topics=excluded))
    assert eng.bound_to(state, OptimizationOptions(excluded_topics=excluded.copy()))
    assert not eng.bound_to(state, opts)
    other = dc.replace(state, broker_capacity=state.broker_capacity.clone())
    eng.rebind(other, opts)
    assert eng.bound_to(other, opts) and not eng.bound_to(state, opts)


def test_fused_cycles_of_two_clusters_in_one_bucket_match_their_staged_cycles():
    """Two clusters of a fleet in one shape bucket: their controllers share
    one engine of the fleet's optimizer.  With cycles of the two
    interleaved, a fused cycle runs only on an engine still bound to its
    own cluster's live state; one that the other cluster rebound goes
    staged.  Each cluster's placements and proposals equal those of its
    staged cycles (fusion off), window by window."""
    from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
    from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
    from cruise_control_tpu_torch.testing.synthetic import SyntheticWorkloadSampler, synthetic_topology

    spec = dict(num_brokers=6, topics={"T0": 12, "T1": 12})
    order = [("east", 4), ("west", 4), ("east", 5), ("east", 6), ("west", 5), ("west", 6)]
    runs = {}
    for fusion in (True, False):
        backends = {}
        for i, cid in enumerate(("east", "west")):
            topo = synthetic_topology(seed=i, **spec)
            metadata = StaticMetadataProvider(topo)
            backends[cid] = (metadata, SimulatedClusterAdmin(metadata, link_rate_bytes_per_s=1e12),
                             SyntheticWorkloadSampler(topo, seed=i))
        app, fleet = service_main.build_simulated_fleet(
            {"controller.enabled": True, "controller.fusion.enabled": fusion},
            clusters={"east": spec, "west": spec}, backends=backends, device="cpu")
        try:
            opt = fleet.facade("east").optimizer
            assert fleet.facade("west").optimizer is opt
            out = []
            for cid, w in order:
                sampler = backends[cid][2]
                sampler.drift(1.05)
                fleet.contexts[cid].fetcher.fetch_once(
                    sampler.all_partition_entities(), w * 1000, (w + 1) * 1000 - 1)
                info = fleet.facade(cid).controller.run_once()
                res = info["result"]
                out.append((bool(info.get("fused")), _placements(res.state_after),
                            [p.to_json() for p in res.proposals]))
            runs[fusion] = out
        finally:
            fleet.shutdown()
            app.stop()
    assert [f for f, _, _ in runs[True]] == [False, False, False, True, False, True]
    assert not any(f for f, _, _ in runs[False])
    for (_, pa, ja), (_, pb, jb) in zip(runs[True], runs[False]):
        assert all((x == y).all() for x, y in zip(pa, pb))
        assert ja == jb
