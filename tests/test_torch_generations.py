"""A model generation is data to the engine: one engine rebound through the
generations of one shape keeps every tensor its graphs read.

One port engine and one JAX engine are rebound through the same sequence
of generations of one padded JBOD cluster, each changing one thing the
engine derives from a generation: the loads, liveness (n_alive), a broker's
capacity (the capacity totals and their weights), a logdir's capacity
(total_disk_cap), offline rows (a dead logdir), n_valid with the replicas
still front-packed, n_source with a hole in the replica rows, n_dest (the
options' excluded brokers), n_brokers (a padding broker made real) and
shared_hosts (two brokers on one host).  After each rebind no tensor of
the statics, of the engine's state or of the generation block is
replaced (`data_ptr` unchanged), the block holds the generation's values,
and the run is byte for byte a fresh engine's on the same generation and
the JAX package's `Engine.rebind` run.  A generation with a wider member
table (max_rf) reallocates.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.models.builder import pad_state as j_pad_state
from cruise_control_tpu.models.builder import prewarm_state as j_prewarm_state
from cruise_control_tpu.models.state import ClusterShape as JShape
from cruise_control_tpu.models.state import ClusterState as JState
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
from cruise_control_tpu_torch.analyzer.objective import GoalChain
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions as TOptions
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.models.state import ClusterShape as TShape
from cruise_control_tpu_torch.testing.fixtures import (
    generation_sequence,
    prior_table,
    set_offline_rows,
)

#: the port's parity tests' search config (tests/test_torch_fused.py)
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
#: a shorter search for the comparisons within the port
SHORT = dict(num_candidates=128, leadership_candidates=32, steps_per_round=6, num_rounds=2,
             max_extra_rounds=2, seed=1)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
SPEC = jf.RandomClusterSpec(num_brokers=8, num_racks=3, num_topics=4, num_partitions=30,
                            skew=1.0, disks_per_broker=2, replica_capacity=96)


def _base() -> tuple[dict, dict]:
    """The base generation's arrays and shape: SPEC padded by two brokers
    (one of them made real by the n_brokers generation)."""
    js = jf.random_cluster(SPEC, seed=5)
    s = js.shape
    js = j_pad_state(js, dataclasses.replace(s, num_brokers=s.num_brokers + 2,
                                             num_hosts=s.num_hosts + 2))
    return {f: np.array(getattr(js, f)) for f in STATE_FIELDS}, dataclasses.asdict(js.shape)


def _shared_hosts(a: dict, num_hosts: int) -> int:
    """1 where a host in range holds more than one valid broker."""
    host = a["broker_host"][a["broker_valid"]]
    return int((np.bincount(host[(host >= 0) & (host < num_hosts)], minlength=1) > 1).any())


def _jax_state(a: dict, shape: dict) -> JState:
    return JState(**{f: jnp.asarray(v) for f, v in a.items()}, shape=JShape(**shape))


def _tensors(eng) -> dict:
    """Every tensor the engine's graphs read of its statics, its state and
    its generation block, by name."""
    sx = eng.statics
    out = {f"state.{f}": getattr(sx.state, f) for f in STATE_FIELDS}
    for f in dataclasses.fields(sx):
        v = getattr(sx, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
    out["gen.words"] = sx.gen.words
    out["host_groups.seg"] = sx.host_groups.seg
    for f in ("count", "start", "order"):
        out[f"host_groups.{f}"] = getattr(sx.host_groups.group, f)
    return out


def _ptrs(eng) -> dict:
    return {k: t.data_ptr() for k, t in _tensors(eng).items()}


def _rounds(history):
    return [{k: v for k, v in h.items() if k not in ("temperature", "objective")}
            for h in history if "round" in h]


def _same(a, b) -> None:
    for f in PLACEMENT:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


def test_generations_of_one_shape_are_data():
    base, shape = _base()
    te = TEngine(from_jax_arrays(base, "cpu", shape=shape), T_CHAIN, config=TConfig(**FAST))
    je = JEngine(_jax_state(base, shape), J_CHAIN, config=JConfig(**FAST))
    te.run()
    ws, ptrs = te._ws, _ptrs(te)
    seen = set()
    for name, a, opts in generation_sequence(base):
        ts = from_jax_arrays(a, "cpu", shape=shape)
        te.rebind(ts, TOptions(**opts))
        je.rebind(_jax_state(a, shape), JOptions(**opts))
        assert te._ws is ws, name
        assert _ptrs(te) == ptrs, name
        sx = te.statics
        got = sx.gen.values()
        for f in ("n_valid", "n_alive", "total_disk_cap", "n_source", "n_dest", "n_brokers"):
            assert got[f] == np.asarray(getattr(je.statics, f)).item(), (name, f)
        assert got["shared_hosts"] == _shared_hosts(a, shape["num_hosts"]), name
        np.testing.assert_array_equal(sx.total_cap.numpy(), np.asarray(je.statics.total_cap))
        seen.add((got["n_valid"], got["n_alive"], got["n_source"], got["n_dest"],
                  got["n_brokers"], got["shared_hosts"], got["total_disk_cap"],
                  tuple(got["w_cap_tc"])))
        t_final, t_hist = te.run()
        f_final, f_hist = TEngine(ts, T_CHAIN, options=TOptions(**opts),
                                  config=TConfig(**FAST)).run()
        j_final, j_hist = je.run()
        _same(t_final, f_final)
        assert _rounds(t_hist) == _rounds(f_hist), name
        _same(t_final, j_final)
        assert _rounds(t_hist) == _rounds(j_hist), name
    # every value the block holds took another value in some generation
    assert all(len({v[i] for v in seen}) > 1 for i in range(8))


def test_a_wider_member_table_reallocates():
    base, shape = _base()
    ts = from_jax_arrays(base, "cpu", shape=shape)
    te = TEngine(ts, T_CHAIN, config=TConfig(**FAST))
    te.run()
    ptrs = _ptrs(te)
    rf = te.max_rf
    js = j_prewarm_state(JShape(**shape), max_rf=rf + 1)
    te.rebind(from_jax_arrays({f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}, "cpu",
                              shape=shape))
    assert te._ws is None and te.max_rf == rf + 1
    changed = {k for k, p in _ptrs(te).items() if ptrs[k] != p}
    assert "part_replicas" in changed and "gen.words" in changed
    t_final, _ = te.run()
    j_final, _ = JEngine(js, J_CHAIN, config=JConfig(**FAST)).run()
    _same(t_final, j_final)


@pytest.mark.parametrize("fused", [True, False])
def test_rebound_engine_is_a_fresh_engine_on_both_routes(fused):
    """The decommission of chip_smoke's phase 5 at a small size: a rebind
    that kills brokers (liveness, capacity totals, destinations and
    offline rows at once) runs what a fresh engine runs, on both routes."""
    base, shape = _base()
    cfg = TConfig(**SHORT, fused_rounds=fused)
    te = TEngine(from_jax_arrays(base, "cpu", shape=shape), T_CHAIN, config=cfg)
    te.run()
    a = {f: v.copy() for f, v in base.items()}
    a["broker_alive"][5:] = False
    a["disk_alive"] &= a["broker_alive"][:, None]
    set_offline_rows(a)
    ts = from_jax_arrays(a, "cpu", shape=shape)
    te.rebind(ts)
    t_final, t_hist = te.run()
    f_final, f_hist = TEngine(ts, T_CHAIN, config=cfg).run()
    _same(t_final, f_final)
    assert _rounds(t_hist) == _rounds(f_hist)
    assert not (np.asarray(t_final.replica_valid)
                & ~np.asarray(a["broker_alive"])[np.asarray(t_final.replica_broker)]).any()


@pytest.mark.parametrize("variant", ["prior", "intra"])
def test_variant_engines_rebind_as_fresh_engines(variant):
    """The learned prior's engine (its CDF over the generation's
    destinations refilled by each rebind) and the intra kind's (the
    rebalance_disk chain, every candidate a disk move) through the same
    generations: no tensor replaced, each run byte for byte a fresh
    engine's on the generation."""
    base, shape = _base()
    intra = variant == "intra"
    chain = GoalChain.from_names(list(DEFAULT_INTRA_BROKER_GOAL_ORDER)) if intra else T_CHAIN
    prior = None if intra else prior_table(TShape(**shape), 1, 0.5)
    cfg = TConfig(**SHORT, prior_enabled=not intra, intra_broker=intra)
    te = TEngine(from_jax_arrays(base, "cpu", shape=shape), chain, config=cfg, prior=prior)
    te.run()
    ws, ptrs = te._ws, _ptrs(te)
    for name, a, opts in generation_sequence(base):
        ts = from_jax_arrays(a, "cpu", shape=shape)
        te.rebind(ts, TOptions(**opts), prior=prior)
        assert te._ws is ws and _ptrs(te) == ptrs, name
        t_final, t_hist = te.run()
        f_final, f_hist = TEngine(ts, chain, options=TOptions(**opts), config=cfg, prior=prior).run()
        _same(t_final, f_final)
        assert _rounds(t_hist) == _rounds(f_hist), name
