"""The port's planner (planner/{scenario,forecast,rightsizer}.py) against the
JAX package's, on tests/test_planner.py's fixtures.

Bars: `apply_scenario` and `plan_shape` array for array equal to the JAX
package's for every kind of edit (kill rack, remove, demote, adds inside
the padding and beyond it, topic factors, the load factor, the delta, a
composition); the identity scenario a byte-identical state and an
identical anneal; the forecaster's trends within 1e-12 of the JAX
package's for both fitters, clamping and skipping alike; the rightsizer's
four cases of tests/test_planner.py with the same verdict, `minBrokers`,
`searchedRange`, `annealsRun` and candidate feasibilities.  The JAX
reference runs once per module (module-scoped fixtures); the port runs on
the CPU.
"""

import dataclasses
import functools

import numpy as np
import pytest

from cruise_control_tpu.analyzer import GoalChain as JChain
from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer import ScenarioEvaluator as JEvaluator
from cruise_control_tpu.models.builder import BrokerSpec, ClusterModelBuilder, PartitionSpec
from cruise_control_tpu.models.builder import pad_state as j_pad_state
from cruise_control_tpu.models.state import ShapeBucketPolicy as JPolicy
from cruise_control_tpu.planner import LoadForecaster as JForecaster
from cruise_control_tpu.planner import Rightsizer as JRightsizer
from cruise_control_tpu.planner import Scenario as JScenario
from cruise_control_tpu.planner import apply_scenario as j_apply
from cruise_control_tpu.planner import plan_shape as j_plan
from cruise_control_tpu_torch.analyzer import GoalChain, GoalOptimizer, OptimizerConfig, ScenarioEvaluator
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.builder import ClusterCatalog, pad_state
from cruise_control_tpu_torch.models.state import STATE_FIELDS, ClusterShape, ShapeBucketPolicy, validate
from cruise_control_tpu_torch.planner import (
    BrokerAdd,
    LoadForecaster,
    Rightsizer,
    Scenario,
    apply_scenario,
    plan_shape,
)

FAST = dict(num_candidates=128, leadership_candidates=32, swap_candidates=16,
            steps_per_round=8, num_rounds=2, max_extra_rounds=2, seed=3)
POLICY = dict(growth=1.25, floor=8)
COMPACT = ["OfflineReplicaGoal", "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
           "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
           "NetworkInboundUsageDistributionGoal"]
UNDER = ["OfflineReplicaGoal", "RackAwareGoal", "DiskCapacityGoal", "ReplicaDistributionGoal"]


# ----------------------------------------------------------------------
# fixtures: tests/test_planner.py's clusters, built by the JAX package and
# converted
# ----------------------------------------------------------------------


def _catalogued():
    b = ClusterModelBuilder()
    cap = np.array([100.0, 1000.0, 1000.0, 10000.0], np.float32)
    for i in range(3):
        b.add_broker(BrokerSpec(i, rack=f"r{i}", capacity=cap))
    loads = {
        ("T1", 0): [18.0, 90.0, 100.0, 750.0],
        ("T1", 1): [15.0, 80.0, 90.0, 650.0],
        ("T2", 0): [12.0, 70.0, 80.0, 550.0],
        ("T2", 1): [10.0, 60.0, 70.0, 450.0],
    }
    for (t, p), brokers in zip(loads, ([0, 1], [0, 1], [0, 2], [0, 1])):
        b.add_partition(PartitionSpec(t, p, brokers, np.array(loads[(t, p)], np.float32)))
    return b.build(), b.catalog


def _rightsize(num_brokers=6, num_parts=12):
    b = ClusterModelBuilder()
    cap = np.array([100.0, 1000.0, 1000.0, 10000.0], np.float32)
    for i in range(num_brokers):
        b.add_broker(BrokerSpec(i, rack=f"r{i % 3}", capacity=cap))
    load = np.array([2.0, 20.0, 25.0, 100.0], np.float32)
    for p in range(num_parts):
        b.add_partition(PartitionSpec("T0", p, [p % num_brokers, (p + 1) % num_brokers], load))
    return b.build(), b.catalog


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _port_catalog(jc):
    return ClusterCatalog(topics=jc.topics, partitions=jc.partitions, racks=jc.racks, hosts=jc.hosts)


FIXTURES = {"catalogued": _catalogued, "rightsize": _rightsize}


@pytest.fixture(scope="module")
def clusters():
    out = {}
    for name, make in FIXTURES.items():
        js, jc = make()
        out[name] = (js, jc, _port(js), _port_catalog(jc))
    return out


def _same_state(ts, js) -> None:
    assert dataclasses.asdict(ts.shape) == dataclasses.asdict(js.shape)
    for f in STATE_FIELDS:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ----------------------------------------------------------------------
# scenario spec: JSON round trip + validation
# ----------------------------------------------------------------------


def test_scenario_json_round_trip():
    sc = Scenario(
        name="storm",
        add_brokers=(BrokerAdd(count=2, rack="r1", capacity=(100.0, 1e3, 1e3, 1e4)),),
        remove_brokers=(0,),
        demote_brokers=(1,),
        kill_racks=("r2",),
        topic_load_factors={"T1": 2.0, "T2": (1.0, 2.0, 2.0, 1.5)},
        load_factor=1.1,
        load_delta=(0.0, 5.0, 5.0, 10.0),
    )
    rt = Scenario.from_json(sc.to_json())
    assert rt.to_json() == sc.to_json()
    assert rt.brokers_added == 2 and not rt.is_identity
    assert Scenario().is_identity
    assert Scenario.from_json({"name": "x"}).is_identity
    # the JAX package reads the port's JSON back to the same scenario
    assert JScenario.from_json(sc.to_json()).to_json() == sc.to_json()


def test_scenario_unknown_fields_rejected():
    with pytest.raises(ValueError, match="unknown scenario fields"):
        Scenario.from_json({"removeBrokres": [1]})


def test_compose_matches_jax():
    a = {"name": "fc", "topicLoadFactors": {"T1": 2.0, "T2": [1.0, 2.0, 2.0, 1.5]},
         "loadDelta": [1.0, 2.0, 3.0, 4.0]}
    b = {"name": "n", "addBrokers": [{"count": 2}], "topicLoadFactors": {"T1": 1.5},
         "loadFactor": 1.2, "loadDelta": [0.5, 0.5, 0.5, 0.5]}
    got = Scenario.from_json(a).compose(Scenario.from_json(b), name="x").to_json()
    want = JScenario.from_json(a).compose(JScenario.from_json(b), name="x").to_json()
    assert got == want


# ----------------------------------------------------------------------
# apply_scenario / plan_shape, array for array
# ----------------------------------------------------------------------

#: scenario JSON by kind; "pad" marks a base padded by the policy first, so
#: the add lands inside the padding
KINDS = {
    "identity": ({"name": "id"}, False),
    "kill_rack": ({"name": "k", "killRacks": ["r0"]}, False),
    "remove": ({"name": "rm", "removeBrokers": [1]}, False),
    "demote": ({"name": "d", "demoteBrokers": [0]}, False),
    "add_in_padding": ({"name": "a", "addBrokers": [{"count": 2}]}, True),
    "add_beyond_padding": ({"name": "a6", "addBrokers": [{"count": 6, "rack": "r1"}]}, False),
    "add_profile": ({"name": "ap", "addBrokers": [
        {"count": 1, "capacity": [50.0, 500.0, 500.0, 4000.0], "rack": 0}]}, True),
    "topic_factors": ({"name": "t", "topicLoadFactors": {"T1": 2.0, "T2": [1.0, 2.0, 2.0, 1.5],
                                                         "T0": 3.0}}, False),
    "load_factor": ({"name": "lf", "loadFactor": 1.1}, False),
    "delta": ({"name": "dl", "loadDelta": [1.0, 10.0, 20.0, 30.0]}, False),
}


def _compose_json():
    a = JScenario.from_json({"name": "kill", "killRacks": ["r2"]})
    b = JScenario.from_json({"name": "grow", "addBrokers": [{"count": 3}],
                             "topicLoadFactors": {"T1": 1.5}, "loadFactor": 1.2})
    return a.compose(b, name="both").to_json()


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("kind", sorted(KINDS) + ["compose"])
def test_apply_scenario_matches_jax(clusters, fixture, kind):
    js, jc, ts, tc = clusters[fixture]
    if kind == "compose":
        d, pad = _compose_json(), False
    else:
        d, pad = KINDS[kind]
    topics = set(jc.topics)
    if "topicLoadFactors" in d:
        d = dict(d, topicLoadFactors={k: v for k, v in d["topicLoadFactors"].items() if k in topics})
    if pad:
        jshape = JPolicy(**POLICY).bucket_shape(js.shape)
        js = j_pad_state(js, jshape)
        ts = pad_state(ts, ClusterShape(**dataclasses.asdict(jshape)))
        _same_state(ts, js)
    want = j_apply(js, JScenario.from_json(d), jc, bucket=JPolicy(**POLICY))
    got = apply_scenario(ts, Scenario.from_json(d), tc, bucket=ShapeBucketPolicy(**POLICY))
    _same_state(got, want)
    assert validate(got) == []
    if kind == "identity":
        assert all(getattr(got, f) is getattr(ts, f) for f in STATE_FIELDS)


def test_plan_shape_matches_jax(clusters):
    js, jc, ts, tc = clusters["catalogued"]
    batches = [[], [{"name": "id"}], [{"name": "a", "addBrokers": [{"count": 2}]}],
               [{"name": "a", "addBrokers": [{"count": 2}, {"count": 3}]},
                {"name": "b", "addBrokers": [{"count": 99}]}]]
    for batch in batches:
        want = j_plan(js, [JScenario.from_json(d) for d in batch], bucket=JPolicy(**POLICY))
        got = plan_shape(ts, [Scenario.from_json(d) for d in batch], bucket=ShapeBucketPolicy(**POLICY))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_add_more_brokers_than_padding_raises_without_plan(clusters):
    _, _, ts, tc = clusters["catalogued"]
    sc = Scenario(name="add99", add_brokers=(BrokerAdd(count=99),))
    mutated = apply_scenario(ts, sc, tc, bucket=ShapeBucketPolicy(**POLICY))
    assert int(mutated.broker_valid.sum()) == 102
    with pytest.raises(ValueError, match="no padding broker rows"):
        apply_scenario(ts, sc, tc, shape=ts.shape)


def test_unknown_names_raise(clusters):
    _, _, ts, tc = clusters["catalogued"]
    with pytest.raises(ValueError, match="unknown rack"):
        apply_scenario(ts, Scenario(kill_racks=("nope",)), tc)
    with pytest.raises(ValueError, match="unknown topic"):
        apply_scenario(ts, Scenario(topic_load_factors={"nope": 2.0}), tc)


def test_identity_scenario_gives_the_same_anneal(clusters):
    """apply_scenario(state, Scenario()) is invisible: the same tensors,
    and the same anneal, bit for bit (also when a sibling pads the batch
    shape: the padded base and its identity member score alike)."""
    _, _, ts, tc = clusters["catalogued"]
    ident = apply_scenario(ts, Scenario(), tc)
    assert ident is ts
    cfg = OptimizerConfig(**FAST)
    r1 = GoalOptimizer(config=cfg, device="cpu").optimize(ts)
    r2 = GoalOptimizer(config=cfg, device="cpu").optimize(ident)
    assert r1.objective_after == r2.objective_after
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(getattr(r1.state_after, f).numpy(), getattr(r2.state_after, f).numpy())
    scs = [Scenario(name="id"), Scenario(name="add", add_brokers=(BrokerAdd(6),))]
    shape = plan_shape(ts, scs, bucket=ShapeBucketPolicy(**POLICY))
    assert shape.num_brokers > ts.shape.num_brokers
    padded = pad_state(ts, shape)
    assert apply_scenario(padded, scs[0], tc, shape=shape) is padded


# ----------------------------------------------------------------------
# forecasting
# ----------------------------------------------------------------------


def _history(n_topics=2, parts_per_topic=3, n_windows=5, slope=10.0):
    """tests/test_planner.py's synthetic WindowedHistory (the JAX package's
    aggregator): each topic's per-partition NW_IN grows `slope` per
    window, plus seeded noise so that neither fitter sees an exact line;
    other resources flat."""
    from cruise_control_tpu.monitor import KAFKA_METRIC_DEF, WindowedMetricSampleAggregator
    from cruise_control_tpu.monitor.sampling import PartitionEntity

    agg = WindowedMetricSampleAggregator(n_windows, 1000, 1, KAFKA_METRIC_DEF)
    ents = [PartitionEntity(t, p) for t in range(n_topics) for p in range(parts_per_topic)]
    nwin = KAFKA_METRIC_DEF.metric_id("LEADER_BYTES_IN")
    cpu = KAFKA_METRIC_DEF.metric_id("CPU_USAGE")
    rng = np.random.default_rng(5)
    for w in range(n_windows):
        vals = np.zeros((len(ents), KAFKA_METRIC_DEF.num_metrics), np.float32)
        vals[:, nwin] = 100.0 + slope * w + rng.uniform(0, 3, len(ents))
        vals[:, cpu] = 5.0
        agg.add_samples_columnar(ents, w * 1000 + 5, vals)
    agg.add_samples_columnar(ents, n_windows * 1000 + 5, vals)
    return agg, KAFKA_METRIC_DEF


def _same_trends(got, want) -> None:
    assert [t.topic for t in got] == [t.topic for t in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.level, b.level, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(a.slope, b.slope, rtol=1e-12, atol=1e-12)
        assert a.windows_observed == b.windows_observed


@pytest.mark.parametrize("method", ["linear", "holt"])
def test_forecaster_matches_jax(method):
    agg, mdef = _history(slope=10.0)
    history = agg.history_snapshot()
    names = {0: "A", 1: "B"}
    want = JForecaster(method=method, min_windows=3).fit(history, mdef, names)
    fc = LoadForecaster(method=method, min_windows=3)
    got = fc.fit(history, mdef, names)
    _same_trends(got, want)
    assert sorted(t.topic for t in got) == ["A", "B"]
    jf = JForecaster(method=method, min_windows=3)
    for h in (0, 2000, 3_600_000):
        a = fc.scenario_at(got, horizon_ms=h, window_ms=1000).to_json()
        b = jf.scenario_at(want, horizon_ms=h, window_ms=1000).to_json()
        assert a["name"] == b["name"]
        for k in b["topicLoadFactors"]:
            np.testing.assert_allclose(a["topicLoadFactors"][k], b["topicLoadFactors"][k],
                                       rtol=1e-12, atol=1e-12)


def test_forecaster_clamps_like_jax():
    agg, mdef = _history(slope=500.0)
    history = agg.history_snapshot()
    got = LoadForecaster(method="linear", min_windows=3, max_factor=3.0).scenarios(history, mdef, [100_000])
    want = JForecaster(method="linear", min_windows=3, max_factor=3.0).scenarios(history, mdef, [100_000])
    assert got[0].to_json() == want[0].to_json()
    for f in got[0].topic_load_factors.values():
        assert max(f) <= 3.0


def test_forecaster_skips_underobserved_topics():
    agg, mdef = _history(n_windows=3)
    history = agg.history_snapshot()
    assert LoadForecaster(min_windows=5).fit(history, mdef) == []
    assert JForecaster(min_windows=5).fit(history, mdef) == []
    with pytest.raises(ValueError, match="unknown forecast method"):
        LoadForecaster(method="arima")


# ----------------------------------------------------------------------
# rightsizer: tests/test_planner.py's four cases
# ----------------------------------------------------------------------

#: case -> (fixture kwargs, chain, Rightsizer kwargs, rightsize kwargs)
RIGHTSIZE = {
    "over": (dict(), COMPACT, dict(max_broker_factor=1.5), dict()),
    "under": (dict(num_brokers=4, num_parts=8), UNDER, dict(max_broker_factor=2.0),
              dict(load_scenario={"name": "x30", "loadFactor": 30.0})),
    "exhausted": (dict(), COMPACT, dict(max_broker_factor=1.5), dict(max_anneals=1)),
}
VERDICT_KEYS = ("provisionStatus", "currentBrokers", "minBrokers", "minBrokersUpperBound",
                "searchedRange", "annealsRun", "undecided", "degraded", "loadScenario")


@functools.lru_cache(maxsize=None)
def _evaluators(chain: tuple):
    """A JAX and a port evaluator with optimizers for `chain`, shared by
    the cases on one chain (each caches its engine)."""
    jchain = JChain.from_names(list(chain))
    jev = JEvaluator(chain=jchain, optimizer=JOptimizer(chain=jchain, config=JConfig(**FAST)),
                     max_scenarios=64)
    tchain = GoalChain.from_names(list(chain))
    tev = ScenarioEvaluator(chain=tchain, max_scenarios=64, device="cpu",
                            optimizer=GoalOptimizer(chain=tchain, config=OptimizerConfig(**FAST),
                                                    device="cpu"))
    return jev, tev


@functools.lru_cache(maxsize=None)
def _rightsize_pair(case):
    """The port's and the JAX package's answers for `case`, and the port
    Rightsizer's record of each anneal."""
    fx, chain, rs_kw, kw = RIGHTSIZE[case]
    js, jc = _rightsize(**fx)
    jev, tev = _evaluators(tuple(chain))
    jkw = dict(kw)
    tkw = dict(kw)
    if "load_scenario" in kw:
        jkw["load_scenario"] = JScenario.from_json(kw["load_scenario"])
        tkw["load_scenario"] = Scenario.from_json(kw["load_scenario"])
    want = JRightsizer(jev, **rs_kw).rightsize(js, jc, **jkw)
    rs = Rightsizer(tev, **rs_kw)
    got = rs.rightsize(_port(js), _port_catalog(jc), **tkw)
    return got, want, rs.last_anneals


@pytest.fixture(scope="module", params=sorted(RIGHTSIZE))
def rightsized(request):
    return request.param, *_rightsize_pair(request.param)[:2]


def test_rightsizer_matches_jax(rightsized):
    case, got, want = rightsized
    for k in VERDICT_KEYS:
        assert got[k] == want[k], k
    assert [(c["brokers"], c["feasible"], c["violatedHardGoals"], c["numMoves"])
            for c in got["candidates"]] == [
        (c["brokers"], c["feasible"], c["violatedHardGoals"], c["numMoves"]) for c in want["candidates"]]
    for a, b in zip(got["candidates"], want["candidates"]):
        np.testing.assert_allclose(a["objectiveAfter"], b["objectiveAfter"], rtol=1e-5)
    assert sorted(got["preMoveViolations"]) == sorted(want["preMoveViolations"])
    for n, rec in want["preMoveViolations"].items():
        assert got["preMoveViolations"][n]["violatedGoals"] == rec["violatedGoals"]
        np.testing.assert_allclose(got["preMoveViolations"][n]["objective"], rec["objective"], rtol=1e-5)


def test_rightsizer_verdicts(rightsized):
    """tests/test_planner.py's assertions, on the port's answers."""
    case, out, _ = rightsized
    if case == "over":
        assert out["provisionStatus"] == "OVER_PROVISIONED"
        assert 2 <= out["minBrokers"] < out["currentBrokers"]
        assert not out["undecided"]
        assert {c["brokers"]: c for c in out["candidates"]}[out["minBrokers"]]["feasible"]
    elif case == "under":
        assert out["provisionStatus"] in ("UNDER_PROVISIONED", "UNDECIDED")
        if out["minBrokers"] is not None:
            assert out["minBrokers"] > out["currentBrokers"]
        assert out["loadScenario"]["loadFactor"] == 30.0
    else:
        assert out["undecided"] and out["provisionStatus"] == "UNDECIDED"
        assert out["minBrokers"] is None
        assert out["minBrokersUpperBound"] == out["searchedRange"][1]
        assert out["annealsRun"] == 1


@pytest.mark.parametrize("case", sorted(RIGHTSIZE))
def test_rightsizer_keeps_each_anneal(case):
    """`last_anneals`: one record an anneal, in the order they ran, with
    the candidate's verdict and the evaluator's record of the anneal."""
    got, _, anneals = _rightsize_pair(case)
    assert len(anneals) == got["annealsRun"]
    assert sorted((a["brokers"], a["feasible"]) for a in anneals) == [
        (c["brokers"], c["feasible"]) for c in got["candidates"]]
    for a in anneals:
        assert isinstance(a["engine_cache_hit"], bool) and a["wall_s"] >= 0
        assert a["captured"] == []  # the CPU captures no graph


def test_rightsizer_floor_respects_replication(clusters):
    js, _, ts, _ = clusters["rightsize"]
    rs = Rightsizer(ScenarioEvaluator(device="cpu"), min_brokers=1)
    assert rs._floor(ts, 6) == 2
    jrs = JRightsizer(JEvaluator(), min_brokers=1)
    assert jrs._floor(js, 6) == 2
