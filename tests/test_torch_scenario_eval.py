"""The port's ScenarioEvaluator (analyzer/scenario_eval.py) against the JAX
package's, on tests/test_planner.py's catalogued cluster.

Bars: `evaluate_states` objectives within rtol 1e-5 of the JAX package's
(the goal chain's bar) with the same violated goals, and the port's batch
equal to its own `_single_eval` exactly; `evaluate(optimize=True)` builds
one engine and rebinds it N-1 times, with the JAX package's fix summaries
(move counts equal); a baseline plus three scenarios (lose a rack, add
three brokers, double a topic) gives the JAX package's outcome JSON
(objectives within rtol 1e-5, wall clocks aside).  tests/test_planner.py's
`double-T0 objective > baseline objective` is not a bar: in the JAX
package's service run that f32 objective is the baseline's bit for bit
(a hard-goal term near 625 dominates it).  The port runs on the CPU, where
the batch is the sequential loop of the same body; without a CUDA device
`ScenarioEvaluator()` raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import GoalChain as JChain
from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer import ScenarioEvaluator as JEvaluator
from cruise_control_tpu.models.builder import BrokerSpec, ClusterModelBuilder, PartitionSpec
from cruise_control_tpu.models.builder import pad_state as j_pad_state
from cruise_control_tpu.models.state import ShapeBucketPolicy as JPolicy
from cruise_control_tpu.planner import Scenario as JScenario
from cruise_control_tpu.planner import apply_scenario as j_apply
from cruise_control_tpu.planner import plan_shape as j_plan
from cruise_control_tpu_torch.analyzer import (
    GoalChain,
    GoalOptimizer,
    OptimizerConfig,
    ScenarioEvaluator,
)
from cruise_control_tpu_torch.common.dispatch import dispatch_meter
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.builder import ClusterCatalog, pad_state
from cruise_control_tpu_torch.models.state import STATE_FIELDS, ShapeBucketPolicy
from cruise_control_tpu_torch.planner import Scenario, apply_scenario, plan_shape

FAST = dict(num_candidates=128, leadership_candidates=32, swap_candidates=16,
            steps_per_round=8, num_rounds=2, max_extra_rounds=2, seed=3)
POLICY = dict(growth=1.25, floor=8)
COMPACT = ["OfflineReplicaGoal", "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
           "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
           "NetworkInboundUsageDistributionGoal"]
SCORED = [{"name": "id"}, {"name": "lose-r0", "killRacks": ["r0"]},
          {"name": "t1x2", "topicLoadFactors": {"T1": 2.0}}, {"name": "add1", "addBrokers": [{"count": 1}]},
          {"name": "demote-0", "demoteBrokers": [0]}, {"name": "delta", "loadDelta": [1.0, 10.0, 20.0, 30.0]}]
OPTIMIZED = [{"name": "id"}, {"name": "lose-r0", "killRacks": ["r0"]},
             {"name": "add2", "addBrokers": [{"count": 2}]}, {"name": "t2x3", "topicLoadFactors": {"T2": 3.0}}]
#: the facade's /simulate batch: the baseline rides first, not annealed
SIMULATE = [{"name": "__baseline__"}, {"name": "lose-rack", "killRacks": ["r0"]},
            {"name": "add-3", "addBrokers": [{"count": 3}]},
            {"name": "double-T1", "topicLoadFactors": {"T1": 2.0}}]
SIMULATE_MASK = [False, True, True, True]


def _catalogued():
    """tests/test_planner.py's `_catalogued_cluster`, built by the JAX
    package."""
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


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


class _Sensors:
    """The duck-typed sensor registry: counter / gauge / timer."""

    def __init__(self):
        self.values = {}

    def _sensor(self, name):
        values = self.values

        class S:
            def inc(self, n=1):
                values[name] = values.get(name, 0) + n

            def set(self, v):
                values[name] = v

            def update(self, v):
                values[name] = v

        return S()

    counter = gauge = timer = _sensor


@pytest.fixture(scope="module")
def cluster():
    js, jc = _catalogued()
    tc = ClusterCatalog(topics=jc.topics, partitions=jc.partitions, racks=jc.racks, hosts=jc.hosts)
    return js, jc, _port(js), tc


@pytest.fixture(scope="module")
def jax_runs(cluster):
    """The JAX package's outcomes of the optimized and simulate batches,
    one JAX optimizer for both (its engine is built once)."""
    js, jc, _, _ = cluster
    chain = JChain.from_names(COMPACT)
    jev = JEvaluator(chain=chain, optimizer=JOptimizer(chain=chain, config=JConfig(**FAST)))
    optimized = jev.evaluate(js, [JScenario.from_json(d) for d in OPTIMIZED], jc, optimize=True,
                             bucket=JPolicy(**POLICY))
    simulate = jev.evaluate(js, [JScenario.from_json(d) for d in SIMULATE], jc,
                            optimize=SIMULATE_MASK, bucket=JPolicy(**POLICY))
    return optimized, simulate


def _port_evaluator(**kw):
    chain = GoalChain.from_names(COMPACT)
    return ScenarioEvaluator(chain=chain, device="cpu", **kw), chain


def _same_fix(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "wallSeconds":
            continue
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-9, err_msg=k)
        else:
            assert got[k] == v, k


def _same_outcome(got, want) -> None:
    a, b = got.to_json(), want.to_json()
    assert sorted(a) == sorted(b)
    for k in ("name", "violatedGoals", "hardGoalsSatisfied", "brokersAlive", "balancedness"):
        assert a[k] == b[k], k
    np.testing.assert_allclose(a["objective"], b["objective"], rtol=1e-5)
    np.testing.assert_allclose(got.violations, np.asarray(want.violations), rtol=1e-5, atol=1e-9)
    assert got.degraded == want.degraded is False
    if "fix" in b:
        _same_fix(a["fix"], b["fix"])


# ----------------------------------------------------------------------
# batched scoring
# ----------------------------------------------------------------------


def test_evaluate_states_matches_jax_and_single_eval(cluster):
    js, jc, ts, tc = cluster
    jsc = [JScenario.from_json(d) for d in SCORED]
    jshape = j_plan(js, jsc, bucket=JPolicy(**POLICY))
    jbase = j_pad_state(js, jshape)
    jstates = [j_apply(jbase, sc, jc, shape=jshape) for sc in jsc]
    jobj, jviol, _ = JEvaluator(chain=JChain.from_names(COMPACT)).evaluate_states(jstates)

    ev, chain = _port_evaluator()
    tsc = [Scenario.from_json(d) for d in SCORED]
    shape = plan_shape(ts, tsc, bucket=ShapeBucketPolicy(**POLICY))
    base = pad_state(ts, shape)
    states = [apply_scenario(base, sc, tc, shape=shape) for sc in tsc]
    with dispatch_meter() as m:
        obj, viol, degraded = ev.evaluate_states(states)
    assert not degraded and obj.shape == (len(SCORED),) and viol.shape == (len(SCORED), len(COMPACT))
    np.testing.assert_allclose(obj, jobj, rtol=1e-5)
    np.testing.assert_allclose(viol, jviol, rtol=1e-5, atol=1e-9)
    names = chain.names()
    for v, w in zip(viol, jviol):
        assert [n for n, x in zip(names, v) if x > 1e-6] == [n for n, x in zip(names, w) if x > 1e-6]
    # the batch is an execution detail, never a numerics change
    for i, s in enumerate(states):
        o, v = ev._single_eval(s)
        assert float(o) == obj[i], i
        assert np.array_equal(np.asarray(v, np.float64), viol[i]), i
    assert ev.last_batch["captured"] and ev.last_batch["n"] == len(SCORED)
    assert ev.last_batch["steps"] == len(SCORED)  # the loop's counter after the batch
    assert "scenario.batch" not in m.counts  # the CPU runs the loop, launches no graph


def test_second_batch_reuses_the_program(cluster):
    """A batch of another size and other contents with the same varying
    fields takes the cached program; a batch with no varying field scores
    the base once and fans it out."""
    _, _, ts, tc = cluster
    ev, _ = _port_evaluator()
    mk = lambda ds: [apply_scenario(ts, Scenario.from_json(d), tc, shape=ts.shape) for d in ds]
    first = mk([{"name": "a", "killRacks": ["r1"]}, {"name": "b", "topicLoadFactors": {"T2": 2.0}}])
    ev.evaluate_states(first)
    assert ev.last_batch["captured"]
    second = mk([{"name": "c", "killRacks": ["r2"]}, {"name": "d", "topicLoadFactors": {"T1": 0.5}},
                 {"name": "e", "removeBrokers": [0]}])
    obj, _, _ = ev.evaluate_states(second)
    assert not ev.last_batch["captured"] and ev.last_batch["n"] == 3
    assert [float(ev._single_eval(s)[0]) for s in second] == list(obj)
    ident = mk([{"name": "x"}, {"name": "y"}])
    obj, viol, _ = ev.evaluate_states(ident)
    assert ev.last_batch["identity"] and obj[0] == obj[1] and np.array_equal(viol[0], viol[1])


def test_states_built_twice_score_as_jax(cluster):
    """The catalogued cluster built twice shares no tensor, so every field
    varies, the replica rows and the member table with them: the JAX
    package's objectives, each bit for bit the port's `_single_eval`."""
    js, _, ts, _ = cluster
    jother = _catalogued()[0]
    jobj, jviol, _ = JEvaluator(chain=JChain.from_names(COMPACT)).evaluate_states([js, jother])
    np.testing.assert_allclose(jobj, [0.05212026, 0.05212026], rtol=1e-7)
    ev, _ = _port_evaluator()
    states = [ts, _port(jother)]
    obj, viol, degraded = ev.evaluate_states(states)
    assert not degraded and not ev.last_batch["identity"]
    assert {"replica_broker", "replica_partition", "replica_pos",
            "replica_valid"} <= set(ev.last_batch["varying"])
    np.testing.assert_allclose(obj, jobj, rtol=1e-5)
    np.testing.assert_allclose(viol, jviol, rtol=1e-5, atol=1e-9)
    for i, s in enumerate(states):
        o, v = ev._single_eval(s)
        assert float(o) == obj[i], i
        assert np.array_equal(np.asarray(v, np.float64), viol[i]), i


def _placements(js):
    """Four placements of the catalogued cluster's one shape, as numpy
    field edits: the base, two replicas moved, a leadership moved, and
    partition 3's two replicas with their positions swapped (another
    member table)."""
    rb = np.asarray(js.replica_broker).copy()
    lead = np.asarray(js.replica_is_leader).copy()
    pos = np.asarray(js.replica_pos).copy()
    part = np.asarray(js.replica_partition)
    moved = rb.copy()
    moved[1], moved[5] = 2, 2  # replicas on broker 1 -> broker 2
    led = lead.copy()
    p0 = np.nonzero(part == 0)[0]
    led[p0] = ~led[p0]
    swapped = pos.copy()
    p3 = np.nonzero(part == 3)[0]
    swapped[p3] = swapped[p3][::-1]
    return [{}, {"replica_broker": moved}, {"replica_is_leader": led}, {"replica_pos": swapped}]


def test_placements_of_one_shape_score_as_jax(cluster):
    """A batch of different placements of one shape (the base and the base
    after applied moves, one with a member table of its own): each score
    bit for bit its `_single_eval`, the objectives the JAX package's on
    the same states."""
    import jax.numpy as jnp

    js, _, ts, _ = cluster
    edits = _placements(js)
    jstates = [dataclasses.replace(js, **{k: jnp.asarray(v) for k, v in e.items()}) for e in edits]
    jobj, jviol, _ = JEvaluator(chain=JChain.from_names(COMPACT)).evaluate_states(jstates)
    states = [dataclasses.replace(ts, **{k: torch.from_numpy(v) for k, v in e.items()})
              for e in edits]
    assert not torch.equal(states[3].members, ts.members)
    ev, _ = _port_evaluator()
    obj, viol, _ = ev.evaluate_states(states)
    assert set(ev.last_batch["varying"]) == {"replica_broker", "replica_is_leader", "replica_pos"}
    np.testing.assert_allclose(obj, jobj, rtol=1e-5)
    np.testing.assert_allclose(viol, jviol, rtol=1e-5, atol=1e-9)
    assert len(set(obj.tolist())) > 1  # the placements score apart
    for i, s in enumerate(states):
        o, v = ev._single_eval(s)
        assert float(o) == obj[i], i
        assert np.array_equal(np.asarray(v, np.float64), viol[i]), i
    # the same varying set again: the cached program, the tables refilled
    again, _, _ = ev.evaluate_states(states[::-1])
    assert not ev.last_batch["captured"] and list(again) == list(obj[::-1])


def test_batch_guards(cluster):
    _, _, ts, tc = cluster
    ev, _ = _port_evaluator(max_scenarios=2)
    with pytest.raises(ValueError, match="planner.max.scenarios"):
        ev.evaluate(ts, [Scenario(name=str(i)) for i in range(3)], tc)
    with pytest.raises(ValueError, match="exceed max_scenarios"):
        ev.evaluate_states([ts] * 3)
    padded = pad_state(ts, plan_shape(ts, [Scenario(add_brokers=(Scenario.from_json(
        {"addBrokers": [{"count": 9}]}).add_brokers))]))
    with pytest.raises(ValueError, match="shapes"):
        ev.evaluate_states([ts, padded])
    with pytest.raises(ValueError, match="optimize mask"):
        ev.evaluate(ts, [Scenario()], tc, optimize=[True, False])


def test_score_state_matches_jax(cluster):
    js, _, ts, _ = cluster
    jobj, jviol, jstats, jdeg = JEvaluator(chain=JChain.from_names(COMPACT)).score_state(js)
    ev, _ = _port_evaluator()
    with dispatch_meter() as m:
        obj, viol, stats, degraded = ev.score_state(ts)
    assert m.counts == {"scenario.score": 1}
    assert not degraded and not jdeg
    np.testing.assert_allclose(obj, jobj, rtol=1e-5)
    np.testing.assert_allclose(viol, jviol, rtol=1e-5, atol=1e-9)
    for f in dataclasses.fields(stats):
        np.testing.assert_allclose(getattr(stats, f.name).numpy(), np.asarray(getattr(jstats, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)


# ----------------------------------------------------------------------
# the planner pass
# ----------------------------------------------------------------------


def test_evaluate_reuses_one_engine_across_batch(cluster, jax_runs):
    """The optimize pass over a scenario batch builds ONE engine and
    rebinds it for every other scenario, with the JAX package's fixes."""
    _, _, ts, tc = cluster
    chain = GoalChain.from_names(COMPACT)
    opt = GoalOptimizer(chain=chain, config=OptimizerConfig(**FAST), device="cpu")
    sensors = _Sensors()
    ev = ScenarioEvaluator(chain=chain, optimizer=opt, sensors=sensors, device="cpu")
    outcomes = ev.evaluate(ts, [Scenario.from_json(d) for d in OPTIMIZED], tc, optimize=True,
                           bucket=ShapeBucketPolicy(**POLICY))
    assert all(o.fix is not None for o in outcomes)
    assert opt.engine_cache_misses == 1, "scenario batch rebuilt the engine"
    assert opt.engine_cache_hits == len(OPTIMIZED) - 1
    assert sensors.values["planner.scenarios-evaluated"] == len(OPTIMIZED)
    assert sensors.values["planner.last-batch-size"] == len(OPTIMIZED)
    fixes = ev.last_batch["fix"]
    assert [f["name"] for f in fixes] == [d["name"] for d in OPTIMIZED]
    assert [f["engine_cache_hit"] for f in fixes] == [False, True, True, True]
    assert fixes[0]["captured"] == []  # the CPU captures no graph
    for got, want in zip(outcomes, jax_runs[0]):
        _same_outcome(got, want)
        assert got.fix["numReplicaMovements"] == want.fix["numReplicaMovements"]
        assert got.fix["numLeaderMovements"] == want.fix["numLeaderMovements"]


def test_simulate_batch_matches_jax(cluster, jax_runs):
    """The facade's /simulate batch: a baseline that is not annealed and
    three scenarios that are; each outcome's JSON is the JAX package's."""
    _, _, ts, tc = cluster
    chain = GoalChain.from_names(COMPACT)
    opt = GoalOptimizer(chain=chain, config=OptimizerConfig(**FAST), device="cpu")
    ev = ScenarioEvaluator(chain=chain, optimizer=opt, device="cpu")
    outcomes = ev.evaluate(ts, [Scenario.from_json(d) for d in SIMULATE], tc, optimize=SIMULATE_MASK,
                           bucket=ShapeBucketPolicy(**POLICY))
    assert [o.fix is not None for o in outcomes] == SIMULATE_MASK
    for got, want in zip(outcomes, jax_runs[1]):
        _same_outcome(got, want)
    base, lose, add3, double = outcomes
    assert add3.brokers_alive == base.brokers_alive + 3
    assert lose.brokers_alive < base.brokers_alive
    assert not lose.hard_goals_satisfied and "OfflineReplicaGoal" in lose.violated_goals
    assert lose.fix["numReplicaMovements"] > 0
    assert double.brokers_alive == base.brokers_alive


def test_device_rules(cluster, monkeypatch):
    _, _, ts, _ = cluster
    ev, _ = _port_evaluator()
    with pytest.raises(ValueError, match="the evaluator on"):
        ScenarioEvaluator(device="meta").evaluate_states([ts])
    with pytest.raises(ValueError, match="the optimizer runs on"):
        ScenarioEvaluator(device="meta", optimizer=GoalOptimizer(device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScenarioEvaluator()
