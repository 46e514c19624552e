"""The port's greedy oracle (analyzer/greedy.py) against the JAX package's.

Both draw from `np.random.default_rng(seed)` in the same order and accept a
move on the same test (the goal's violation falls by more than 1e-12 and no
earlier goal rises by more than 1e-9).  The port scores candidates op by op,
as the JAX package's op-by-op evaluation does; the JAX oracle scores them
with one compiled program, which XLA:CPU reassociates, so a few violations
differ from the op-by-op ones in the last bits (ROADMAP queue 3).  Hence:

- on `small_cluster`, `dead_broker_cluster` and `jbod_cluster` no
  acceptance flips, and the port's final placements and move counts equal
  the JAX package's own oracle;
- on all five cases (those three, `rack_violated_cluster`, and
  tests/test_optimizer.py's `random_cluster(8/80, seed 21)` with its
  parameters) the JAX package's search, fed the port's violations, makes
  exactly the port's moves;
- on the two cases where an acceptance flips, the port's violations equal
  the JAX package's op-by-op evaluation bit for bit on the start and final
  states;
- on `rack_violated_cluster` and the 8/80 case the compiled oracle's flips
  show as one move more (4 against 3, 75 against 74), which the op-by-op
  evaluation does not make.

The port scores on the CPU here (`device="cpu"`); without a CUDA device,
`device=None` raises.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.greedy as jg
from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.config.balancing import DEFAULT_CONSTRAINT as J_CONSTRAINT
from cruise_control_tpu.models.aggregates import compute_aggregates as j_aggregates
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import OptimizationOptions
from cruise_control_tpu_torch.analyzer import greedy as tg
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT as T_CONSTRAINT
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS

PLACEMENT = ("replica_broker", "replica_is_leader", "replica_offline")
R8 = dict(max_moves_per_goal=12, candidate_dests=6, seed=21)
#: the fixtures and the oracle's arguments; the 8/80 case is the oracle run
#: of tests/test_optimizer.py::test_tpu_beats_or_matches_greedy_oracle
CASES = {
    "small_cluster": (jf.small_cluster, dict(seed=0)),
    "rack_violated_cluster": (jf.rack_violated_cluster, dict(seed=0)),
    "dead_broker_cluster": (jf.dead_broker_cluster, dict(seed=0)),
    "jbod_cluster": (jf.jbod_cluster, dict(seed=0)),
    "random_8_80": (
        lambda: jf.random_cluster(jf.RandomClusterSpec(num_brokers=8, num_partitions=80, skew=1.5), seed=21),
        R8,
    ),
}
#: where the JAX package's compiled oracle flips an acceptance against its
#: op-by-op evaluation: (its moves, the op-by-op and the port's moves)
FLIPS = {"rack_violated_cluster": (4, 3), "random_8_80": (75, 74)}


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _same_placement(tstate, jstate) -> None:
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                      err_msg=f)


def _j_op_by_op(js) -> np.ndarray:
    """The JAX package's violations of `js`, evaluated op by op."""
    with jax.disable_jit():
        agg = j_aggregates(js)
        return np.asarray(jnp.stack([g.violation(js, agg, J_CONSTRAINT) for g in J_CHAIN.goals]),
                          np.float64)


def _port_scored_eval(start):
    """A drop-in for the JAX oracle's `_make_eval`, for a search from the
    JAX state `start`: the port's violations of each candidate (the
    start's arrays with the candidate's placement columns)."""
    base = _port(start)
    score = tg._make_eval(T_CHAIN, T_CONSTRAINT, base.members)

    def make(chain, constraint):
        def eval_fn(js):
            return score(dataclasses.replace(
                base, **{f: torch.from_numpy(np.array(getattr(js, f))) for f in PLACEMENT}))

        return eval_fn

    return make


@functools.lru_cache(maxsize=None)
def _run(name):
    """The JAX fixture of case `name` and the port's oracle run on it."""
    make, kw = CASES[name]
    js = make()
    tfinal, tinfo = tg.greedy_optimize(_port(js), T_CHAIN, return_info=True, device="cpu", **kw)
    return js, kw, tfinal, tinfo


@pytest.fixture(params=sorted(CASES))
def case(request):
    return (request.param, *_run(request.param))


def test_jax_search_on_port_scores_makes_the_port_moves(case, monkeypatch):
    """The JAX package's search code, fed the port's violations, makes
    exactly the port's moves: the draws, the neighbourhood, the acceptance
    test and the move applicators are the same."""
    _, js, kw, tfinal, tinfo = case
    make, calls = _port_scored_eval(js), []

    def counted(*a):
        fn = make(*a)

        def eval_fn(s):
            calls.append(1)
            return fn(s)

        return eval_fn

    monkeypatch.setattr(jg, "_make_eval", counted)
    jfinal, jinfo = jg.greedy_optimize(js, J_CHAIN, return_info=True, **kw)
    _same_placement(tfinal, jfinal)
    assert (tinfo["moves"], tinfo["converged"]) == (jinfo["moves"], jinfo["converged"])
    assert tinfo["moves"] > 0
    # the port's count of scored states is the JAX search's own
    assert tinfo["evaluations"] == len(calls)


@pytest.mark.parametrize("name", sorted(FLIPS))
def test_violations_equal_op_by_op_reference(name):
    """Where the compiled oracle flips an acceptance, the port's candidate
    score is the JAX package's op-by-op evaluation, bit for bit, on the
    start state and on the port's final state."""
    js, _, tfinal, _ = _run(name)
    st = _port(js)
    score = tg._make_eval(T_CHAIN, T_CONSTRAINT, st.members)
    np.testing.assert_array_equal(score(st), _j_op_by_op(js))
    jfinal = dataclasses.replace(js, **{f: jnp.asarray(getattr(tfinal, f).numpy()) for f in PLACEMENT})
    np.testing.assert_array_equal(score(tfinal), _j_op_by_op(jfinal))


def test_against_the_jax_oracle(case):
    """The JAX package's own (compiled) oracle: identical placements and
    moves where no acceptance flips; where one does, it makes the one move
    more that the op-by-op evaluation does not."""
    name, js, kw, tfinal, tinfo = case
    jfinal, jinfo = jg.greedy_optimize(js, J_CHAIN, return_info=True, **kw)
    if name in FLIPS:
        assert (jinfo["moves"], tinfo["moves"]) == FLIPS[name]
        return
    _same_placement(tfinal, jfinal)
    assert (tinfo["moves"], tinfo["converged"]) == (jinfo["moves"], jinfo["converged"])


def test_options_restrict_the_search():
    """An excluded destination receives nothing and an excluded topic
    stays put, as in the JAX package's oracle."""
    st = _port(CASES["random_8_80"][0]())
    excluded = np.zeros(st.shape.B, bool)
    excluded[0] = True
    topics = np.zeros(st.shape.num_topics, bool)
    topics[0] = True
    opts = OptimizationOptions(excluded_brokers_for_replica_move=excluded, excluded_topics=topics)
    final = tg.greedy_optimize(st, T_CHAIN, device="cpu", options=opts, **dict(R8, max_moves_per_goal=3))
    before, after = st.replica_broker.numpy(), final.replica_broker.numpy()
    moved = (before != after) & st.replica_valid.numpy()
    assert moved.any()
    assert not (after[moved] == 0).any()
    assert not (st.replica_topic.numpy()[moved] == 0).any()


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.greedy_optimize(_port(jf.small_cluster()), T_CHAIN)


def test_state_on_another_device_raises():
    with pytest.raises(ValueError, match="the search runs on"):
        tg.greedy_optimize(_port(jf.small_cluster()), T_CHAIN, device="meta")
