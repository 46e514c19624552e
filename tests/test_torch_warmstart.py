"""Warm start: `Engine.run(initial_placement=)` and
`GoalOptimizer.optimize(initial_placement=)` against the JAX package's.

The start placement of each fixture is the JAX package's result of a cold
run with another seed (the streaming controller's case: the last accepted
proposal).  On the four small fixtures at FAST, both routes give the JAX package's
placements and round records exactly (temperatures rtol 1e-6, verbose
objectives rtol 1e-5, as in tests/test_torch_fused.py); the proposals
diff against the cluster's own placement, as the reference's do.  A warm
start from the statics' own placement is the cold run; the caller's
tensors are never written; movement pricing counts against the statics'
placement, not the start's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.controller import PriorTable
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.models.state import STATE_FIELDS

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FIXTURES = ["small_cluster", "rack_violated_cluster", "dead_broker_cluster", "jbod_cluster"]
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _rounds(history):
    return [h for h in history if "round" in h]


def _same_records(t_hist, j_hist):
    tr, jr = _rounds(t_hist), _rounds(j_hist)
    drop = ("objective", "temperature")
    assert [{k: v for k, v in h.items() if k not in drop} for h in tr] == \
        [{k: v for k, v in h.items() if k not in drop} for h in jr]
    np.testing.assert_allclose([h["temperature"] for h in tr], [h["temperature"] for h in jr],
                               rtol=1e-6)
    for a, b in zip(tr, jr):
        if "objective" in a:
            np.testing.assert_allclose(a["objective"], b["objective"], rtol=1e-5)


def _start(js):
    """The JAX package's cold result with seed 7 (host numpy arrays)."""
    final, _ = JEngine(js, J_CHAIN, config=JConfig(**dict(FAST, seed=7))).run()
    return tuple(np.array(getattr(final, f)) for f in PLACEMENT)


def _torch(placement):
    return tuple(torch.from_numpy(a.copy()) for a in placement)


@pytest.fixture(scope="module", params=FIXTURES)
def fixture_and_start(request):
    js = getattr(jf, request.param)()
    return js, _start(js)


@pytest.mark.parametrize("fused", [True, False])
def test_engine_warm_start_matches_jax(fixture_and_start, fused):
    js, start = fixture_and_start
    cfg = dict(FAST, fused_rounds=fused)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**cfg)).run(
        verbose=True, initial_placement=start)
    t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**cfg)).run(
        verbose=True, initial_placement=_torch(start))
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                      err_msg=f)
    _same_records(t_hist, j_hist)
    timing = t_hist[-1]
    assert timing["fused"] is fused
    if fused:
        assert timing["blocking_syncs"] == 1


def test_optimize_warm_start_matches_jax(fixture_and_start):
    js, start = fixture_and_start
    jr = JOptimizer(config=JConfig(**FAST)).optimize(js, initial_placement=start)
    tr = TOptimizer(config=TConfig(**FAST), device="cpu").optimize(_port(js),
                                                                   initial_placement=_torch(start))
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tr.state_after, f).numpy(),
                                      np.asarray(getattr(jr.state_after, f)), err_msg=f)
    key = lambda res: sorted((p.partition, p.old_leader, p.new_leader, p.old_replicas,  # noqa: E731
                              p.new_replicas, p.disk_moves) for p in res.proposals)
    assert key(tr) == key(jr)
    assert [(h["accepted"], h.get("early_stop")) for h in _rounds(tr.history)] == \
        [(h["accepted"], h.get("early_stop")) for h in _rounds(jr.history)]
    np.testing.assert_allclose(tr.objective_before, jr.objective_before, rtol=1e-5)
    np.testing.assert_allclose(tr.objective_after, jr.objective_after, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["small_cluster", "dead_broker_cluster"])
def test_warm_start_from_own_placement_is_the_cold_run(name, fused):
    ts = _port(getattr(jf, name)())
    cfg = TConfig(**dict(FAST, fused_rounds=fused))
    eng = TEngine(ts, T_CHAIN, config=cfg)
    cold, h_cold = eng.run(verbose=True)
    own = tuple(getattr(ts, f).clone() for f in PLACEMENT)
    warm, h_warm = eng.run(verbose=True, initial_placement=own)
    for f in PLACEMENT:
        assert torch.equal(getattr(cold, f), getattr(warm, f)), f
    assert _rounds(h_cold) == _rounds(h_warm)
    # and a cold run after a warm one on the same engine starts from the
    # statics again
    other = _torch(_start(getattr(jf, name)()))
    eng.run(initial_placement=other)
    again, h_again = eng.run(verbose=True)
    for f in PLACEMENT:
        assert torch.equal(getattr(cold, f), getattr(again, f)), f
    assert _rounds(h_cold) == _rounds(h_again)


@pytest.mark.parametrize("fused", [True, False])
def test_caller_tensors_are_copied_not_written(fused):
    js = jf.dead_broker_cluster()
    ts = _port(js)
    start = _torch(_start(js))
    before = tuple(t.clone() for t in start)
    eng = TEngine(ts, T_CHAIN, config=TConfig(**dict(FAST, fused_rounds=fused)))
    final, _ = eng.run(initial_placement=start)
    for t, b in zip(start, before):
        assert torch.equal(t, b)
    for f, t in zip(PLACEMENT, start):
        assert getattr(final, f).data_ptr() != t.data_ptr()
    # a second run, warm from the first one's result, leaves that result
    kept = tuple(getattr(final, f).clone() for f in PLACEMENT)
    eng.run(initial_placement=tuple(getattr(final, f) for f in PLACEMENT))
    for f, k in zip(PLACEMENT, kept):
        assert torch.equal(getattr(final, f), k)


def test_init_carry_from_prices_against_the_statics():
    """A warm carry's relocation deltas differ from those of a cold engine
    whose statics hold the start placement by exactly the pricing term
    counted against the statics' placement."""
    js = jf.small_cluster()
    ts = _port(js)
    start = _torch(_start(js))
    assert not torch.equal(start[0], ts.replica_broker)
    moved = dataclasses.replace(ts, replica_broker=start[0], replica_is_leader=start[1],
                                replica_disk=start[2])
    cfg = TConfig(**FAST)
    key = Key.from_seed(5)
    props = []
    for state, placement in ((ts, start), (moved, None)):
        eng = TEngine(state, T_CHAIN, config=cfg)
        carry = eng.init_carry(key) if placement is None else eng.init_carry_from(key, placement)
        plan = eng.plan(carry)
        keys = cand_k.StepKeys.of(key)
        props.append((cand_k.candidates_plain(eng.cand, eng.statics, carry, keys, eng._globals(carry),
                                              plan, 0.0), plan))
    (warm, plan_w), (cold, plan_c) = props
    assert torch.equal(plan_w.replica_cost, plan_c.replica_cost)
    n = eng.K_r
    r, src, dst = warm["payr"]["r"][:n].long(), warm["src"][:n], warm["dst"][:n]
    f32 = torch.float32

    def stray(orig):
        return (dst != orig).to(f32) - (src != orig).to(f32)

    want = plan_w.replica_cost * (stray(ts.replica_broker[r]) - stray(start[0][r]))
    # where |delta| < 1 the price (~6e-6 here) is well above the deltas'
    # f32 spacing; an infeasible duplicate's delta is ~6e2
    small = cold["delta"][:n].abs() < 1.0
    np.testing.assert_allclose((warm["delta"][:n] - cold["delta"][:n])[small].numpy(),
                               want[small].numpy(), rtol=1e-3, atol=1e-9)
    assert bool((want[small] != 0).any())


@pytest.mark.parametrize("bad", ["length", "dtype", "shape", "type"])
def test_initial_placement_is_checked(bad):
    ts = _port(jf.small_cluster())
    rb, il, dk = (getattr(ts, f).clone() for f in PLACEMENT)
    placement = {
        "length": (rb, il),
        "dtype": (rb.to(torch.int64), il, dk),
        "shape": (rb, il[:-1], dk),
        "type": (rb.numpy(), il, dk),
    }[bad]
    eng = TEngine(ts, T_CHAIN, config=TConfig(**FAST))
    with pytest.raises(ValueError, match="initial_placement"):
        eng.run(initial_placement=placement)
    with pytest.raises(ValueError, match="initial_placement"):
        TOptimizer(config=TConfig(**FAST), device="cpu").optimize(ts, initial_placement=placement)


def test_the_prior_still_raises():
    """The prior is ported (the name is kept from when it raised):
    `optimize(prior=)` with a warm prior and a warm start together runs as
    the JAX package's does, placements and proposals; the modes that
    raised before build and run through optimize."""
    js = jf.small_cluster()
    ts = _port(js)
    start = _start(js)
    prior = PriorTable(weights=np.zeros((js.shape.num_topics, js.shape.B), np.float32), mix=0.5,
                       observations=1.0)
    prior.weights[:, 0] = 1.0
    cfg = dict(FAST, prior_enabled=True)
    jr = JOptimizer(config=JConfig(**cfg)).optimize(js, prior=prior, initial_placement=start)
    tr = TOptimizer(config=TConfig(**cfg), device="cpu").optimize(ts, prior=prior,
                                                                  initial_placement=_torch(start))
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tr.state_after, f).numpy(),
                                      np.asarray(getattr(jr.state_after, f)), err_msg=f)
    assert len(tr.proposals) == len(jr.proposals)
    for kw in (dict(prior_enabled=True), dict(diagnostics=True), dict(score_dtype="bfloat16")):
        res = TOptimizer(config=TConfig(**FAST, **kw), device="cpu").optimize(ts)
        assert res.objective_after < res.objective_before
    assert not hasattr(TConfig(**FAST), "check_ported")
