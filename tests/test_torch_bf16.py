"""bf16 scoring (score_dtype="bfloat16") of the port against the JAX
package's, on the CPU.

- The JAX package's pins (tests/test_optimizer.py:466-525) on the port:
  score_dtype is validated; an explicit float32 is bitwise the default
  (placements, objective, and `GoalChain.evaluate` itself); a bf16 run
  converges to a valid placement whose objective is within
  analyzer.precision.tolerance of the f32 run's, and the bf16 chain
  objective of one state within it of the f32 one, violations f32.
- `broker_terms` in bf16 against the reference's compiled `_broker_terms`
  (what the engine runs): bit for bit, on perturbed broker rows of the
  small fixtures, with the same globals.  XLA:CPU rounds each term and
  each add to bf16 but the last add, whose f32 result it keeps (it drops
  the bf16 round trip before the final cast); the port does the same.
- The chain's bf16 objective against the reference's compiled
  `GoalChain.evaluate`, on the same violations and scores: XLA keeps the
  products in f32, sums in f32 and rounds each sum to bf16 once; the port
  does the same, and the two are bitwise but where XLA contracts the last
  multiply-add (the tiebreak term) into an FMA: within one f32 ulp there,
  on at most 1% of random cases (ROADMAP queue 3 records the first case).
  On the fixtures' own states: violations within rtol 1e-5, as in
  tests/test_torch_goals.py, the objective within two bf16 ulps.
- Whole bf16 runs give the reference's placements and round records on the
  small fixtures, both routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.objective import GoalChain as JGoalChain
from cruise_control_tpu.config.app_config import CruiseControlConfig
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.objective import GoalChain as TGoalChain
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import move_delta as md
from cruise_control_tpu_torch.models import validate
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import fixtures as tf

SMALL = dict(num_brokers=12, num_partitions=200, num_racks=4, num_topics=6, skew=1.0)
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
BF16 = dict(score_dtype="bfloat16")


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _bits(state):
    return [getattr(state, f).numpy() for f in PLACEMENT]


def _rounds(history):
    return [h for h in history if "round" in h]


def test_score_dtype_validation():
    for bad in ("float16", "f32"):
        with pytest.raises(ValueError):
            TConfig(score_dtype=bad)
    with pytest.raises(ValueError):
        T_CHAIN.evaluate(tf.small_cluster("cpu"), score_dtype="float16")


def test_f32_scoring_pin_is_bit_for_bit():
    """tests/test_optimizer.py:473 on the port."""
    state = tf.small_cluster("cpu")
    default = TOptimizer(config=TConfig(**FAST), device="cpu").optimize(state)
    explicit = TOptimizer(config=TConfig(**FAST, score_dtype="float32"), device="cpu").optimize(state)
    for a, b in zip(_bits(default.state_after), _bits(explicit.state_after)):
        assert (a == b).all()
    assert np.float32(default.objective_after) == np.float32(explicit.objective_after)
    a = T_CHAIN.evaluate(state)
    b = T_CHAIN.evaluate(state, score_dtype="float32")
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_bf16_scoring_holds_tolerance_gate():
    """tests/test_optimizer.py:499 on the port: the tolerance is the JAX
    package's analyzer.precision.tolerance."""
    tol = CruiseControlConfig({}).get("analyzer.precision.tolerance")
    state = tf.small_cluster("cpu")
    f32 = TOptimizer(config=TConfig(**FAST), device="cpu").optimize(state)
    bf16 = TOptimizer(config=TConfig(**FAST, **BF16), device="cpu").optimize(state)
    assert validate(bf16.state_after) == []
    assert bf16.objective_after < bf16.objective_before
    ref = float(f32.objective_after)
    assert abs(float(bf16.objective_after) - ref) <= tol * max(abs(ref), 1e-6)
    obj_f, _, _ = T_CHAIN.evaluate(state)
    obj_b, viol_b, _ = T_CHAIN.evaluate(state, score_dtype="bfloat16")
    assert viol_b.dtype == torch.float32
    assert abs(float(obj_b) - float(obj_f)) <= tol * max(abs(float(obj_f)), 1e-6)
    # the reports stay f32 whatever the config's score_dtype
    assert bf16.objective_before == f32.objective_before


@pytest.mark.parametrize("name", CASES)
def test_broker_terms_bf16_match_jax_compiled(name):
    """The bf16 broker terms of perturbed broker rows (loads x U(0.3, 3),
    counts +-6, leader bytes x U(0.3, 3)) against the reference's compiled
    `_broker_terms` with the same globals: bit for bit."""
    build, cfg = CASES[name]
    js = build()
    je = JEngine(js, J_CHAIN, config=JConfig(**cfg, **BF16))
    te = TEngine(_port(js), T_CHAIN, config=TConfig(**cfg, **BF16))
    assert te.tp.bf16
    carry = te.init_carry(Key.from_seed(0))
    g = te._globals(carry)
    B = js.shape.B
    rng = np.random.default_rng(B)
    ins = dict(
        load=carry.broker_load.numpy() * rng.uniform(0.3, 3.0, (B, 4)).astype(np.float32),
        rcount=carry.broker_replica_count.numpy() + rng.integers(-6, 7, B).astype(np.int32),
        lcount=carry.broker_leader_count.numpy() + rng.integers(-6, 7, B).astype(np.int32),
        pot=carry.broker_potential_nw_out.numpy() * rng.uniform(0.3, 3.0, B).astype(np.float32),
        lbin=carry.broker_leader_bytes_in.numpy() * rng.uniform(0.3, 3.0, B).astype(np.float32),
    )
    b = np.arange(B, dtype=np.int32)
    jg = {k: jnp.asarray(v.numpy()) for k, v in g.items() if isinstance(v, torch.Tensor)}
    want = jax.jit(je._broker_terms)(je.statics, b, *(jnp.asarray(v) for v in ins.values()), jg)
    got = md.broker_terms(te.tp, te.statics, torch.from_numpy(b),
                          *(torch.from_numpy(v) for v in ins.values()), g)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    # f32 accumulation differs: the bf16 mode is really on
    f32 = md.broker_terms(dataclasses.replace(te.tp, bf16=False), te.statics, torch.from_numpy(b),
                          *(torch.from_numpy(v) for v in ins.values()), g)
    assert not torch.equal(f32, got)


class _Given:
    """A goal whose violation and score are entry i of the vectors the
    chain is evaluated on (the `state` argument): the chain's weighted sum
    alone, in both packages."""

    hard = False

    def __init__(self, i):
        self.i, self.name = i, f"given{i}"

    def violation(self, state, agg, constraint):
        return state[0][self.i]

    def score(self, state, agg, constraint):
        return state[1][self.i]


def test_chain_bf16_sum_matches_jax_compiled():
    """The bf16 objective of 16 goals with the default chain's weights, on
    2,000 random violation and score vectors (violations 0 half the time,
    else spread over nine decades): the port's against the reference's
    compiled `GoalChain.evaluate`, bitwise on at least 99% of the cases and
    within one f32 ulp on all (XLA's FMA of the tiebreak term)."""
    weights = J_CHAIN.weights
    goals = [_Given(i) for i in range(len(weights))]
    jchain = JGoalChain(goals=tuple(goals), weights=weights)
    tchain = TGoalChain(goals=tuple(goals), weights=weights)
    rng = np.random.default_rng(1)
    n, G = 2000, len(weights)
    V = (rng.uniform(0, 1, (n, G)) * (rng.uniform(0, 1, (n, G)) < 0.5)
         * 10.0 ** rng.uniform(-9, 0, (n, G))).astype(np.float32)
    S = rng.uniform(0, 1, (n, G)).astype(np.float32)
    jobj = jax.jit(lambda v, s: jchain.evaluate((v, s), agg=0, score_dtype="bfloat16")[0])
    want = np.array([float(jobj(v, s)) for v, s in zip(V, S)], np.float32)
    got = np.array([float(tchain.evaluate((torch.from_numpy(v), torch.from_numpy(s)), agg=0,
                                          score_dtype="bfloat16")[0]) for v, s in zip(V, S)], np.float32)
    differ = got != want
    assert int(differ.sum()) <= n // 100
    assert bool((np.abs(got - want) <= np.spacing(np.abs(want))).all())
    if differ.any():
        i = int(np.nonzero(differ)[0][0])
        print(f"first divergence: case {i}: XLA {want[i]!r}, port {got[i]!r}")


@pytest.mark.parametrize("name", CASES)
def test_chain_bf16_on_fixture_states(name):
    """The bf16 chain objective of each fixture's state against the
    reference's compiled one: violations f32 and within rtol 1e-5, the
    objective within two bf16 ulps (its violations' own f32 roundings can
    move a bf16 rounding)."""
    js = CASES[name][0]()
    ts = _port(js)
    jobj, jviol, _ = jax.jit(lambda s: J_CHAIN.evaluate(s, score_dtype="bfloat16"))(js)
    tobj, tviol, _ = T_CHAIN.evaluate(ts, score_dtype="bfloat16")
    assert tviol.dtype == torch.float32
    np.testing.assert_allclose(tviol.numpy(), np.asarray(jviol), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(float(tobj), float(jobj), rtol=2 * 2.0 ** -8)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("name", CASES)
def test_bf16_run_matches_jax(name, fused):
    """A whole bf16 run: the reference's placements and round records
    (temperatures within rtol 1e-6)."""
    build, cfg = CASES[name]
    js = build()
    c = dict(cfg, fused_rounds=fused, **BF16)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**c)).run()
    t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**c)).run()
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                      err_msg=f)
    tr, jr = _rounds(t_hist), _rounds(j_hist)
    assert [{k: v for k, v in h.items() if k != "temperature"} for h in tr] == \
        [{k: v for k, v in h.items() if k != "temperature"} for h in jr]
    np.testing.assert_allclose([h["temperature"] for h in tr], [h["temperature"] for h in jr],
                               rtol=1e-6)
