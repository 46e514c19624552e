"""The learned move-acceptance prior of the port against the JAX package's,
on the CPU.

- The JAX package's pins (tests/test_controller.py:53-120) on the port: a
  cold prior (prior_enabled, mix 0) reproduces the uniform draw stream
  bit for bit, placements and accepted counts; a warm prior steers the
  draws and the anneal stays valid and improving; a new prior through
  `rebind` or `rebind_prior` is data (the same statics tensors, no new
  workspace); an engine without the prior carries the f32[1, 1]
  placeholder and mix 0.
- Against the JAX package: the step keys' prior keys equal
  `split(fold_in(rel_dst, 1))` of `jax.random` word for word, and the
  prior-off key table is the prior table's first columns; the statics'
  prior CDF and mix equal the reference's `_prior_fields` bit for bit (a
  numpy computation in both); one step's destination draws and
  took-the-prior mask equal the reference's `_sample_dests` exactly; and a
  peaked prior's whole run gives the reference's placements and history on
  the small fixtures, both routes, also through `GoalOptimizer.optimize`.
- The port's copy of controller/prior.py against the pins of
  tests/test_controller.py:175-219 (fitting, decay, churn) and the JAX
  package's tables on the same observations.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.engine import build_statics as j_build_statics
from cruise_control_tpu.analyzer.options import DEFAULT_OPTIONS as J_OPTIONS
from cruise_control_tpu.controller.prior import MoveAcceptancePrior as JPrior
from cruise_control_tpu.models.builder import ClusterCatalog as JCatalog
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import DEFAULT_OPTIONS
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.engine import build_statics
from cruise_control_tpu_torch.controller import MoveAcceptancePrior, PriorTable
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.models import validate
from cruise_control_tpu_torch.models.builder import ClusterCatalog
from cruise_control_tpu_torch.models.state import STATE_FIELDS, ClusterShape
from cruise_control_tpu_torch.testing import fixtures as tf

SMALL = dict(num_brokers=12, num_partitions=200, num_racks=4, num_topics=6, skew=1.0)
#: test_controller's search config
CFG = dict(num_candidates=128, leadership_candidates=32, swap_candidates=16, steps_per_round=8,
           num_rounds=3, seed=0)
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
CASES = {
    "SMALL": (lambda: jf.random_cluster_fast(jf.RandomClusterSpec(**SMALL), seed=3), CFG),
    "small_cluster": (jf.small_cluster, FAST),
    "rack_violated_cluster": (jf.rack_violated_cluster, FAST),
    "dead_broker_cluster": (jf.dead_broker_cluster, FAST),
    "jbod_cluster": (jf.jbod_cluster, FAST),
}
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _small():
    return tf.random_cluster_fast(tf.RandomClusterSpec(**SMALL), seed=3, device="cpu")


def _same_port_placement(a, b) -> bool:
    return all(bool(torch.equal(getattr(a, f), getattr(b, f))) for f in PLACEMENT)


def _same_placement(t_state, j_state):
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f)),
                                      err_msg=f)


def _rounds(history):
    return [h for h in history if "round" in h]


class Peaked:
    """A peaked prior (tests/test_controller.py:69-92): every topic's mass
    on broker 0, half the topics' also on one more broker."""

    def __init__(self, shape, mix=1.0):
        self.mix = mix
        self.weights = np.zeros((shape.num_topics, shape.B), np.float32)
        self.weights[:, 0] = 1.0
        self.weights[::2, shape.B // 2] = 2.0


# ------------------------------------------------------------------ engine


def test_cold_prior_is_byte_identical_to_uniform_draws():
    """tests/test_controller.py:53 on the port."""
    state = _small()
    base, hist0 = TEngine(state, T_CHAIN, config=TConfig(**CFG)).run()
    prior_on, hist = TEngine(state, T_CHAIN, config=TConfig(**CFG, prior_enabled=True)).run()
    assert _same_port_placement(base, prior_on)
    assert [h.get("accepted") for h in hist] == [h.get("accepted") for h in hist0]


def test_warm_prior_biases_destinations_and_stays_valid():
    """tests/test_controller.py:69 on the port."""
    state = _small()
    eng = TEngine(state, T_CHAIN, config=TConfig(**CFG, prior_enabled=True), prior=Peaked(state.shape))
    final, _ = eng.run()
    base, _ = TEngine(state, T_CHAIN, config=TConfig(**CFG)).run()
    assert not _same_port_placement(final, base)
    assert validate(final, strict=False) == []
    assert float(T_CHAIN.evaluate(final)[0]) <= float(T_CHAIN.evaluate(state)[0])


def test_prior_rebind_is_data_only():
    """tests/test_controller.py:95 on the port: a refreshed prior through
    rebind (same model generation) and through rebind_prior lands in the
    statics' own tensors; the workspace (and, on the card, the captured
    graphs) stays."""
    state = _small()
    eng = TEngine(state, T_CHAIN, config=TConfig(**CFG, prior_enabled=True))
    assert float(eng.statics.prior_mix) == 0.0
    eng.run()
    ws, statics, cdf = eng._ws, eng.statics, eng.statics.prior_cdf

    class P:
        mix = 0.25
        weights = np.ones((state.shape.num_topics, state.shape.B), np.float32)

    eng.rebind(state, prior=P)
    assert eng._ws is ws and eng.statics.prior_cdf is cdf
    assert all(getattr(eng.statics, f) is getattr(statics, f) for f in ("part_replicas", "gen"))
    assert float(eng.statics.prior_mix) == 0.25
    assert tuple(eng.statics.prior_cdf.shape) == (state.shape.num_topics, state.shape.B)
    want = build_statics(state, DEFAULT_OPTIONS, prior=P, prior_full_shape=True).prior_cdf
    assert torch.equal(cdf, want)
    eng.rebind_prior(Peaked(state.shape, mix=0.5))
    assert eng._ws is ws and eng.statics.prior_cdf is cdf and float(eng.statics.prior_mix) == 0.5
    final, _ = eng.run()
    fresh, _ = TEngine(state, T_CHAIN, config=TConfig(**CFG, prior_enabled=True),
                       prior=Peaked(state.shape, mix=0.5)).run()
    assert _same_port_placement(final, fresh)
    # an engine without the prior ignores rebind_prior
    off = TEngine(state, T_CHAIN, config=TConfig(**CFG))
    off.rebind_prior(P)
    assert float(off.statics.prior_mix) == 0.0


def test_prior_disabled_statics_carry_placeholder():
    """tests/test_controller.py:116 on the port."""
    sx = build_statics(_small(), DEFAULT_OPTIONS)
    assert tuple(sx.prior_cdf.shape) == (1, 1)
    assert float(sx.prior_mix) == 0.0


def test_prior_weights_must_fit_the_model():
    state = _small()
    bad = PriorTable(weights=np.ones((2, 3), np.float32), mix=0.5, observations=1.0)
    with pytest.raises(ValueError, match="prior weights shape"):
        TEngine(state, T_CHAIN, config=TConfig(**CFG, prior_enabled=True), prior=bad)
    with pytest.raises(ValueError, match="mix"):
        TEngine(state, T_CHAIN, config=TConfig(**CFG, prior_enabled=True),
                prior=dataclasses.replace(tf.prior_table(state.shape), mix=1.5))


# ------------------------------------------------------ against the JAX package


def _words(k) -> tuple[int, int]:
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 4, 2**40 + 3])
def test_step_keys_prior_match_jax(seed):
    """The prior's two keys, `split(fold_in(rel_dst, 1))` as the
    reference's `_sample_dests` derives them, word for word; the key
    table's prior columns; the prior-off table is the first KEY_WORDS
    columns of the prior one."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    keys = cand_k.StepKeys.of(Key(*_words(jkey)), prior=True)
    _, k_r, _, _, _ = jax.random.split(jkey, 5)
    _, r_dst = jax.random.split(k_r)
    k_m, k_p = jax.random.split(jax.random.fold_in(r_dst, 1))
    assert (keys.prior_m.words, keys.prior_p.words) == (_words(k_m), _words(k_p))
    table = cand_k.key_table(Key(*_words(jkey)), 3, prior=True)
    assert table.shape == (3, cand_k.KEY_WORDS + cand_k.PRIOR_KEY_WORDS)
    assert [int(x) for x in table[0]] == keys.words()
    assert np.array_equal(cand_k.key_table(Key(*_words(jkey)), 3), table[:, :cand_k.KEY_WORDS])
    assert cand_k.StepKeys.from_words(table[0]) == dataclasses.replace(keys, next=None)


@pytest.mark.parametrize("name", ["SMALL", "dead_broker_cluster"])
def test_prior_statics_match_jax(name):
    """The statics' prior CDF and mix are the reference's bit for bit: a
    warm table, a table with unseen topics, a cold engine."""
    js = CASES[name][0]()
    ts = _port(js)
    for prior in (Peaked(js.shape, 0.5), tf.prior_table(ts.shape, 3, 0.75), None):
        jsx = j_build_statics(js, J_OPTIONS, prior=prior, prior_full_shape=True)
        tsx = build_statics(ts, DEFAULT_OPTIONS, prior=prior, prior_full_shape=True)
        assert np.array_equal(tsx.prior_cdf.numpy(), np.asarray(jsx.prior_dst_cdf))
        assert tsx.prior_mix.tolist() == [float(jsx.prior_mix)]


@pytest.mark.parametrize("mix", [0.0, 0.5, 1.0])
def test_sample_dests_match_jax(mix):
    """One step's relocation destinations and took-the-prior mask: the
    plain candidates against the reference's `_sample_dests(with_mask)`
    on the same sources and key, exactly."""
    js = CASES["SMALL"][0]()
    prior = tf.prior_table(js.shape, 5, mix)
    je = JEngine(js, J_CHAIN, config=JConfig(**CFG, prior_enabled=True), prior=prior)
    te = TEngine(_port(js), T_CHAIN, config=TConfig(**CFG, prior_enabled=True), prior=prior)
    key = Key.from_seed(11)
    keys = cand_k.StepKeys.of(key, prior=True)
    r = torch.from_numpy(np.random.default_rng(2).integers(0, js.shape.R, te.K_r).astype(np.int32))
    pos, use = cand_k._sample_dests(te.cand, te.statics, keys, te.K_r, r)
    jpos, juse = je._sample_dests(je.statics, np.asarray(keys.rel_dst.words, np.uint32), te.K_r,
                                  r.numpy(), with_mask=True)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(use.numpy(), np.asarray(juse))
    assert int(use.sum()) == {0.0: 0, 1.0: te.K_r}.get(mix, int(use.sum()))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("name", CASES)
def test_warm_prior_matches_jax(name, fused):
    """A peaked prior's whole run: the reference's placements and round
    records (the temperatures within rtol 1e-6)."""
    build, cfg = CASES[name]
    js = build()
    c = dict(cfg, prior_enabled=True, fused_rounds=fused)
    prior = Peaked(js.shape, mix=0.5)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**c), prior=prior).run()
    t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**c), prior=prior).run()
    _same_placement(t_final, j_final)
    tr, jr = _rounds(t_hist), _rounds(j_hist)
    assert [{k: v for k, v in h.items() if k != "temperature"} for h in tr] == \
        [{k: v for k, v in h.items() if k != "temperature"} for h in jr]
    np.testing.assert_allclose([h["temperature"] for h in tr], [h["temperature"] for h in jr],
                               rtol=1e-6)


def test_optimize_with_prior_matches_jax():
    """GoalOptimizer.optimize(prior=) against the JAX package's: the prior
    reaches the engine on a miss and, rebound, on a hit; proposals and
    placements equal the reference's; a cold call after a warm one is the
    prior-off run."""
    js = jf.small_cluster()
    ts = _port(js)
    prior = Peaked(js.shape, mix=0.5)
    jopt = JOptimizer(config=JConfig(**FAST, prior_enabled=True))
    topt = TOptimizer(config=TConfig(**FAST, prior_enabled=True), device="cpu")
    for p in (prior, prior, None):
        jr, tr = jopt.optimize(js, prior=p), topt.optimize(ts, prior=p)
        _same_placement(tr.state_after, jr.state_after)
        assert len(tr.proposals) == len(jr.proposals)
    assert topt.engine_cache_misses == 1 and topt.engine_cache_hits == 2
    off = TOptimizer(config=TConfig(**FAST), device="cpu").optimize(ts)
    assert _same_port_placement(tr.state_after, off.state_after)


# ------------------------------------------------------------- the prior


def _catalog(cls, topics=("A", "B")):
    return cls(topics=tuple(topics), partitions=tuple((t, i) for t in topics for i in range(2)))


def _proposal(topic_id, old, new):
    from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal

    return ExecutionProposal(partition=0, topic=topic_id, old_leader=old[0], new_leader=new[0],
                             old_replicas=tuple(old), new_replicas=tuple(new))


def _shape(T, B):
    return ClusterShape(num_replicas=8, num_brokers=B, num_partitions=4, num_topics=T, num_racks=2,
                        num_hosts=B, max_disks_per_broker=1)


def test_prior_fits_accepted_destinations_and_gates_on_observations():
    """tests/test_controller.py:175 on the port's copy."""
    cat = _catalog(ClusterCatalog)
    prior = MoveAcceptancePrior(mix=0.5, decay=1.0, min_observations=3)
    assert prior.table(cat, _shape(T=2, B=4)).mix == 0.0  # cold
    prior.observe_proposals([_proposal(0, (1, 2), (3, 2))], cat)
    assert prior.table(cat, _shape(T=2, B=4)).mix == 0.0  # still < min
    prior.observe_proposals([_proposal(0, (1, 2), (3, 2)), _proposal(1, (0, 1), (2, 1))], cat)
    t = prior.table(cat, _shape(T=2, B=4))
    assert t.mix == 0.5
    assert t.weights[0, 3] == pytest.approx(2.0)
    assert t.weights[1, 2] == pytest.approx(1.0)
    assert t.weights[0, 2] == 0.0


def test_prior_decay_fades_and_executed_weighs_more():
    """tests/test_controller.py:195 on the port's copy."""
    cat = _catalog(ClusterCatalog)
    prior = MoveAcceptancePrior(mix=1.0, decay=0.5, min_observations=0)
    prior.observe_proposals([_proposal(0, (1,), (3,))], cat)
    prior.observe_executed([_proposal(1, (0,), (2,))], cat)
    t = prior.table(cat, _shape(T=2, B=4))
    assert t.weights[0, 3] == pytest.approx(0.5)
    assert t.weights[1, 2] == pytest.approx(4.0)


def test_prior_survives_topic_churn():
    """tests/test_controller.py:208 on the port's copy."""
    prior = MoveAcceptancePrior(mix=1.0, decay=1.0, min_observations=0)
    prior.observe_proposals([_proposal(0, (1,), (3,))], _catalog(ClusterCatalog, ("OLD", "B")))
    t = prior.table(_catalog(ClusterCatalog, ("NEW", "B")), _shape(T=2, B=4))
    assert t.weights.sum() == 0.0


def test_prior_tables_match_jax_on_proposal_sets():
    """The port's prior fitted on a real ProposalSet (columnar
    destination_pairs) equals the JAX package's fitted on the reference's
    ProposalSet of the same run: weights, mix and observations, over two
    decayed batches."""
    js = jf.small_cluster()
    topics = tuple(f"t{t}" for t in range(js.shape.num_topics))
    jcat, tcat = JCatalog(topics=topics, partitions=()), ClusterCatalog(topics=topics, partitions=())
    jres = JOptimizer(config=JConfig(**FAST)).optimize(js)
    tres = TOptimizer(config=TConfig(**FAST), device="cpu").optimize(_port(js))
    jp, tp = JPrior(mix=0.5, decay=0.9, min_observations=2), MoveAcceptancePrior(mix=0.5, decay=0.9,
                                                                                 min_observations=2)
    for _ in range(2):
        assert tp.observe_proposals(tres.proposals, tcat) == jp.observe_proposals(jres.proposals, jcat) > 0
    jt, tt = jp.table(jcat, js.shape), tp.table(tcat, _port(js).shape)
    assert np.array_equal(tt.weights, jt.weights) and (tt.mix, tt.observations) == (jt.mix, jt.observations)
    assert tp.state_json() == jp.state_json()
