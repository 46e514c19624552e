"""The JBOD path: intra-broker disk goals in the candidate deltas and the
intra-broker candidate kind (rebalance_disk), against the JAX package's.

- The intra kind's plain version against `_intra_disk_candidates` on one
  step of `jbod_cluster` and of a 6-broker, 4-logdir random cluster:
  sources, destination logdirs, feasibility and payload exact, deltas
  within rtol 1e-6, with and without the sampling plan, from the same
  carry, plan and key.  Its keys are the intra kind's split (`k_r`
  itself, not its first split).
- Whole `intra_broker=True` runs and runs of BASELINE configuration 3's
  chain (inter-broker moves with disk terms in every delta) on the small
  JBOD fixtures: the JAX package's placements, rounds and proposals.
- The port's twin of tests/test_optimizer.py::test_intra_broker_disk_rebalance.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER as J_INTRA
from cruise_control_tpu.analyzer.objective import GoalChain as JChain
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.engine import SamplingPlan
from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
from cruise_control_tpu_torch.analyzer.objective import GoalChain as TChain
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.models import validate
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import fixtures as tf

RTOL, ATOL = 1e-6, 1e-12
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
#: bench.py config_3's chain (BASELINE.md configuration 3)
CONFIG3_CHAIN = ["RackAwareGoal", "DiskCapacityGoal", "IntraBrokerDiskCapacityGoal",
                 "IntraBrokerDiskUsageDistributionGoal"]
INTRA = dict(num_candidates=128, steps_per_round=16, num_rounds=3, intra_broker=True, seed=2)
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
RANDOM_JBOD = dict(num_brokers=6, num_partitions=200, disks_per_broker=4, deviation=1.0)


def _jbod(name):
    """A JAX JBOD cluster by name."""
    if name == "jbod_cluster":
        return jf.jbod_cluster()
    return jf.random_cluster_fast(jf.RandomClusterSpec(**RANDOM_JBOD), seed=7)


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _words(k) -> tuple[int, int]:
    return tuple(int(x) for x in np.asarray(k))


def test_intra_keys_match_jax_split():
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    keys = cand_k.StepKeys.of(Key(*_words(jkey)), intra=True)
    row = cand_k.key_table(Key(*_words(jkey)), 2, intra=True)[0]
    assert [int(x) for x in row] == keys.words()
    _, k_r, k_s, k_l, k_u = jax.random.split(jkey, 5)
    assert [k.words for k in keys.rel_src] == [_words(w) for w in jax.random.split(k_r, 4)]
    # the other kinds' keys are the inter-broker step's
    plain = cand_k.StepKeys.of(Key(*_words(jkey)))
    assert (keys.swap_src, keys.swap_q, keys.lead, keys.u) == \
        (plain.swap_src, plain.swap_q, plain.lead, plain.u)


def test_intra_engine_splits_k():
    ts = _port(jf.jbod_cluster())
    eng = TEngine(ts, TChain.from_names(DEFAULT_INTRA_BROKER_GOAL_ORDER), config=TConfig(**INTRA))
    assert (eng.K_r, eng.K_s, eng.K_l) == (128, 0, 0)
    assert eng.cand.intra


@pytest.fixture(scope="module", params=["jbod_cluster", "random_jbod"])
def intra_engines(request):
    js = _jbod(request.param)
    j_chain = JChain.from_names(J_INTRA)
    t_chain = TChain.from_names(DEFAULT_INTRA_BROKER_GOAL_ORDER)
    je = JEngine(js, j_chain, config=JConfig(**INTRA))
    te = TEngine(_port(js), t_chain, config=TConfig(**INTRA))
    jc = je._jit_init(je.statics, jax.random.PRNGKey(9))
    return je, jc, je._jit_plan(je.statics, jc), te, te.init_carry(Key.from_seed(9))


@pytest.mark.parametrize("with_plan", [False, True])
def test_intra_candidates_match_reference(intra_engines, with_plan):
    je, jc, jp, te, tc = intra_engines
    jsx = je.statics
    jplan = jp if with_plan else None
    tplan = SamplingPlan(**{f.name: torch.from_numpy(np.asarray(getattr(jp, f.name)).copy())
                            for f in dataclasses.fields(SamplingPlan)}) if with_plan else None
    _, k_r, _, _, _ = jax.random.split(jc.key, 5)
    jg = je._globals(jsx, jc)
    delta, feas, src, dst, part, pay = je._intra_disk_candidates(jsx, jc, k_r, jg, jplan)
    keys = cand_k.StepKeys.of(tc.key, intra=True)
    # the step globals within rtol 1e-6 (sums over brokers), the total
    # disk load bit for bit (the plain version adds it in the reference's
    # order; an intra delta is a difference of two terms that divide by it)
    g = te._globals(tc)
    for k, v in jg.items():
        np.testing.assert_allclose(g[k].numpy(), np.asarray(v), rtol=1e-6, err_msg=k)
    assert float(g["total_disk_load"]) == float(jg["total_disk_load"])
    t_delta, t_feas, t_src, t_dst, t_part, t_pay = cand_k._intra_candidates(
        te.cand, te.statics, tc, keys, g, tplan)
    for got, want, what in ((t_feas, feas, "feas"), (t_src, src, "src"), (t_dst, dst, "dst"),
                            (t_part, part, "part")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)
    for f in ("r", "dst", "d_src", "d_dst", "is_lead", "load", "pot", "lbin"):
        np.testing.assert_array_equal(t_pay[f].numpy(), np.asarray(pay[f]), err_msg=f)
    np.testing.assert_allclose(t_delta.numpy(), np.asarray(delta), rtol=RTOL, atol=ATOL)
    # the case must exercise the kind: feasible moves, and some of them
    # improving
    assert bool(t_feas.any()) and bool((t_delta[t_feas] < 0).any())
    assert bool((t_pay["d_dst"] != t_pay["d_src"]).any())
    # the whole bundle: relocation rows only, src == dst
    prop = cand_k.candidates_plain(te.cand, te.statics, tc, keys, g, tplan, 0.0)
    assert prop["nr"] == te.K_r and prop["ns"] == 0 and prop["payl"]["rf"].numel() == 0
    assert torch.equal(prop["src"], prop["dst"])
    assert torch.equal(prop["payr"]["src"], prop["payr"]["dst"])


def _same_runs(t_final, t_hist, j_final, j_hist):
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                      err_msg=f)
    rounds = lambda h: [(r["round"], r["accepted"], r.get("early_stop"), r.get("extra"))  # noqa: E731
                        for r in h if "round" in r]
    assert rounds(t_hist) == rounds(j_hist)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["jbod_cluster", "random_jbod"])
def test_intra_runs_match_jax(name, fused):
    js = _jbod(name)
    cfg = dict(INTRA, fused_rounds=fused)
    j_final, j_hist = JEngine(js, JChain.from_names(J_INTRA), config=JConfig(**cfg)).run()
    t_final, t_hist = TEngine(_port(js), TChain.from_names(DEFAULT_INTRA_BROKER_GOAL_ORDER),
                              config=TConfig(**cfg)).run()
    _same_runs(t_final, t_hist, j_final, j_hist)
    # disk moves only
    ts = _port(js)
    assert torch.equal(t_final.replica_broker, ts.replica_broker)
    assert torch.equal(t_final.replica_is_leader, ts.replica_is_leader)
    assert not torch.equal(t_final.replica_disk, ts.replica_disk)


@pytest.mark.parametrize("name", ["jbod_cluster", "random_jbod"])
def test_config3_chain_matches_jax(name):
    """BASELINE configuration 3's chain in the inter-broker mode: the disk
    terms ride every relocation, swap and leadership delta."""
    js = _jbod(name)
    jr = JOptimizer(chain=JChain.from_names(CONFIG3_CHAIN), config=JConfig(**FAST)).optimize(js)
    tr = TOptimizer(chain=TChain.from_names(CONFIG3_CHAIN), config=TConfig(**FAST),
                    device="cpu").optimize(_port(js))
    _same_runs(tr.state_after, tr.history, jr.state_after, jr.history)
    key = lambda res: sorted((p.partition, p.old_leader, p.new_leader, p.old_replicas,  # noqa: E731
                              p.new_replicas, p.disk_moves) for p in res.proposals)
    assert key(tr) == key(jr) and len(tr.proposals) > 0
    np.testing.assert_allclose(tr.violations_after, jr.violations_after, rtol=1e-5, atol=1e-9)
    assert tr.violated_goals_after() == jr.violated_goals_after()


def test_intra_broker_disk_rebalance():
    """rebalance_disk: the JBOD logdirs balance without any inter-broker
    movement (the port's twin of tests/test_optimizer.py's test)."""
    state = tf.random_cluster_fast(tf.RandomClusterSpec(**RANDOM_JBOD), seed=7, device="cpu")
    chain = TChain.from_names(DEFAULT_INTRA_BROKER_GOAL_ORDER)
    obj0, _, _ = chain.evaluate(state)
    opt = TOptimizer(chain=chain, config=TConfig(num_candidates=128, steps_per_round=16, num_rounds=3,
                                                 intra_broker=True), device="cpu")
    res = opt.optimize(state)
    assert validate(res.state_after) == []
    assert res.objective_after < float(obj0)
    assert torch.equal(state.replica_broker, res.state_after.replica_broker)
    assert torch.equal(state.replica_is_leader, res.state_after.replica_is_leader)
    assert any(p.disk_moves for p in res.proposals)
    for p in res.proposals:
        assert sorted(p.old_replicas) == sorted(p.new_replicas)
