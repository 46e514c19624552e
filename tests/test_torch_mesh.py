"""The port's replicated mesh layer (parallel/{ranks,mesh,sharded,portfolio,grid}.py)
on the CPU: one module-scoped rank group of 4 gloo ranks, every layout a
prefix of it.

- The JAX package's mesh tests, each case kept, pointed at the port
  (tests/test_sharded.py's 11, tests/test_parallel.py's 4,
  tests/test_bucketing.py's `test_sharded_exact_vs_bucketed_parity`,
  tests/test_ledger.py's `test_diagnostics_byte_parity_mesh`).  Where the
  JAX tests use the 8 virtual devices, these use the world's 4 ranks
  (sharded over 4, `grid:2x2` for `grid:2x4`).  The JAX package's
  `test_sharded_n1_emits_no_collective` reads XLA's HLO; the port's
  statement counts its own gather calls and packed bytes a step: 0 at n=1.
- The layout helpers, the sharding rule tables against the JAX package's,
  and the model-axis collectives over 2 gloo ranks against one process.
- The entry points that refused the sharded-model mode, segmented mesh
  runs and mesh fault tolerance before they were ported, now running them,
  and a killed rank: a typed error inside the deadline, then a rebuilt
  group.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine, GoalOptimizer, OptimizerConfig
from cruise_control_tpu_torch.analyzer.engine import SegmentContext, segmented_execution
from cruise_control_tpu_torch.models.state import validate
from cruise_control_tpu_torch.parallel import (
    MODEL_AXIS,
    RESTART_AXIS,
    GridEngine,
    MeshEngine,
    RankDiedError,
    ShardedEngine,
    close_rank_groups,
    cpu_devices,
    default_mesh,
    grid_mesh,
    model_mesh,
    normalize_mesh,
    portfolio_run,
    rank_group,
)
from cruise_control_tpu_torch.parallel.mesh import packed_bytes_per_step
from cruise_control_tpu_torch.parallel.ranks import Layout
from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster

# K_r=36 is deliberately NOT divisible by 4 (the JAX test's point, at 8
# there): the ranks' lanes past K are dropped after the gather
CFG = OptimizerConfig(num_candidates=60, leadership_candidates=16, swap_candidates=8,
                      steps_per_round=6, num_rounds=3, seed=3)
DEVS = cpu_devices(4)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


@pytest.fixture(scope="module", autouse=True)
def world():
    """The file's world: 4 gloo ranks, shared by every layout below."""
    g = rank_group(DEVS)
    yield g
    close_rank_groups()


def _state(seed=21, brokers=12, parts=160):
    return random_cluster(RandomClusterSpec(num_brokers=brokers, num_partitions=parts, skew=1.5),
                          seed=seed, device="cpu")


def _rounds(history):
    return [h for h in history if not h.get("timing")]


def _same_placement(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in PLACEMENT)


def _objective(state) -> float:
    return float(DEFAULT_CHAIN.evaluate(state)[0])


# ----------------------------------------------------------------------
# tests/test_sharded.py
# ----------------------------------------------------------------------


def test_sharded_engine_improves_and_validates():
    state = _state()
    se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=CFG)
    final, history = se.run(verbose=True)
    assert validate(final) == []
    assert _objective(final) < _objective(state)
    assert sum(h["accepted"] for h in _rounds(history)) > 0
    timing = next(h for h in history if h.get("timing"))
    assert timing["fused"] is True and timing["blocking_syncs"] == 1
    assert timing["mesh_shape"] == [1, 4]
    assert timing["collective_bytes"] > 0
    assert timing["backend"] == "gloo" and timing["ranks"] == 4
    se.release()


def test_sharded_byte_parity_plain_vs_1_vs_8_devices():
    """The mesh layer's invariant on the world's 4 ranks: the same seeded
    anneal on the plain engine, a 1-rank and a 4-rank layout gives
    byte-identical placements and per-round acceptance, and every rank's
    final carry is the plain engine's bit for bit."""
    state = _state(seed=27, brokers=10, parts=144)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    plain, hist_p = eng.run()
    s1 = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS[:1]), config=CFG)
    f1, hist_1 = s1.run()
    s4 = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=CFG)
    f4, hist_4 = s4.run()
    assert _same_placement(plain, f1) and _same_placement(plain, f4)
    acc = lambda h: [r["accepted"] for r in _rounds(h)]  # noqa: E731
    assert acc(hist_p) == acc(hist_1) == acc(hist_4)
    from cruise_control_tpu_torch.parallel.mesh import _carry_digest

    assert set(s4.carry_digests()) == {_carry_digest(eng._ws.carry)} == set(s1.carry_digests())
    s1.release()
    s4.release()


def test_sharded_n1_emits_no_collective():
    """At n=1 a rank's step is the plain engine's: no gather call, no
    packed bytes; at n=4 the ranks gather one packed buffer a step, whose
    bytes cover the lanes past K (60 -> 4 x ceil(K_x / 4) lanes a kind)."""
    state = _state(seed=5, brokers=8, parts=96)
    s1 = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS[:1]), config=CFG)
    assert s1.collective_bytes_per_step == 0
    _, h1 = s1.run()
    assert s1.last_info["gather_calls"] == [0] and h1[-1]["collectives"] == 0
    s4 = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=CFG)
    assert s4.collective_bytes_per_step > 0
    assert s4.collective_bytes_per_round == s4.collective_bytes_per_step * CFG.steps_per_round
    _, h4 = s4.run()
    ran = len(_rounds(h4))
    assert s4.last_info["gather_calls"] == [ran * CFG.steps_per_round] * 4
    assert h4[-1]["collectives"] == ran * CFG.steps_per_round
    assert packed_bytes_per_step(CFG, 1) == 0
    s1.release()
    s4.release()


def test_mesh_normalization():
    m1 = normalize_mesh(Layout(tuple(DEVS), (MODEL_AXIS,), (4,)))
    assert m1.shape[RESTART_AXIS] == 1 and m1.shape[MODEL_AXIS] == 4
    m2 = normalize_mesh(Layout(tuple(DEVS), (RESTART_AXIS,), (4,)))
    assert m2.shape[RESTART_AXIS] == 4 and m2.shape[MODEL_AXIS] == 1
    m3 = normalize_mesh(grid_mesh(2, 2, DEVS))
    assert m3 is normalize_mesh(m3)  # canonical form is a fixed point
    with pytest.raises(ValueError, match="mesh axes"):
        normalize_mesh(Layout(tuple(DEVS), ("data",), (4,)))
    with pytest.raises(ValueError, match="devices <"):
        grid_mesh(4, 2, DEVS)
    assert default_mesh(DEVS).shape == {RESTART_AXIS: 4}


def test_sharded_carry_aggregates_match_unsharded():
    """The mesh carry is REPLICATED: after the same run every rank's carry
    (placement, broker aggregates, rack census, key) is the plain engine's
    bit for bit, whose aggregates are the state's own."""
    from cruise_control_tpu_torch.models.aggregates import compute_aggregates
    from cruise_control_tpu_torch.parallel.mesh import _carry_digest

    state = _state(seed=5)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    eng.run()
    agg = compute_aggregates(eng.carry_to_state(eng._ws.carry))
    assert torch.equal(eng._ws.carry.broker_replica_count, agg.broker_replica_count)
    assert torch.equal(eng._ws.carry.broker_leader_count, agg.broker_leader_count)
    se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=CFG)
    se.run()
    assert set(se.carry_digests()) == {_carry_digest(eng._ws.carry)}
    se.release()


def test_grid_engine_2d_mesh():
    """Restart portfolio OVER candidate-sharded chains on a 2x2 layout:
    chains isolated (their own keys), the winner validates, improves the
    cluster, and is the argmin chain; each model row's carries agree."""
    state = _state(seed=41, brokers=10, parts=128)
    ge = GridEngine(state, DEFAULT_CHAIN, mesh=grid_mesh(2, 2, DEVS), config=CFG)
    final, history = ge.run(verbose=True)
    info = ge.last_info
    assert info["n_chains"] == 2 and info["n_shards"] == 2
    assert len(info["objectives"]) == 2
    assert _rounds(history) and all("accepted" in h for h in _rounds(history))
    assert validate(final) == []
    assert _objective(final) < _objective(state)
    assert info["winner"] == int(np.argmin(info["objectives"]))
    d = ge.carry_digests()
    assert d[0] == d[1] and d[2] == d[3]
    ge.release()


def test_grid_engine_rejects_1d_mesh():
    state = _state(seed=43, brokers=8, parts=96)
    with pytest.raises(ValueError, match="grid mesh"):
        GridEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=CFG)


@pytest.mark.parametrize("mode", ["sharded", "grid:2x2"])
def test_goal_optimizer_parallel_modes(mode):
    """tpu.parallel.mode wires the mesh engines into the optimizer
    (GoalOptimizer -> ShardedEngine / GridEngine), and the sharded mode
    reproduces the single-device optimizer's result exactly."""
    state = _state(seed=51, brokers=10, parts=120)
    opt = GoalOptimizer(config=CFG, parallel_mode=mode, device="cpu", mesh_max_devices=4)
    res = opt.optimize(state)
    assert validate(res.state_after) == []
    assert res.objective_after < res.objective_before
    assert res.proposals
    timing = next(h for h in res.history if h.get("timing"))
    assert timing["mesh_shape"] == ([1, 4] if mode == "sharded" else [2, 2])
    if mode == "sharded":
        single = GoalOptimizer(config=CFG, device="cpu").optimize(state)
        assert torch.equal(res.state_after.replica_broker, single.state_after.replica_broker)
        assert res.objective_after == single.objective_after
        assert [str(p) for p in res.proposals] == [str(p) for p in single.proposals]


def test_goal_optimizer_mesh_max_devices():
    """tpu.mesh.max.devices caps the layout (on the CPU it names the rank
    count): sharded at 2 runs a 2-rank row, 1 degenerates to the
    single-device path, and a grid needing more ranks is refused."""
    state = _state(seed=51, brokers=10, parts=120)
    res = GoalOptimizer(config=CFG, parallel_mode="sharded", device="cpu",
                        mesh_max_devices=2).optimize(state)
    assert next(h for h in res.history if h.get("timing"))["mesh_shape"] == [1, 2]
    assert GoalOptimizer(config=CFG, parallel_mode="sharded", device="cpu",
                         mesh_max_devices=1).parallel_mode == "single"
    with pytest.raises(ValueError, match="devices"):
        GoalOptimizer(config=CFG, parallel_mode="grid:2x4", device="cpu", mesh_max_devices=4)


def test_parallel_engine_rebind_honors_new_options():
    """A cached mesh engine rebound with NEW options honours them."""
    from cruise_control_tpu_torch.analyzer import OptimizationOptions

    state = _state(seed=61, brokers=10, parts=120)
    opt = GoalOptimizer(config=CFG, parallel_mode="sharded", device="cpu", mesh_max_devices=4)
    opt.optimize(state)
    excluded = np.zeros(state.shape.B, bool)
    excluded[0] = True
    res = opt.optimize(state, options=OptimizationOptions(excluded_brokers_for_replica_move=excluded))
    assert next(h for h in res.history if h.get("timing"))["engine_cache_hit"] is True
    before, after = res.state_before, res.state_after
    moved = (before.replica_broker != after.replica_broker) & before.replica_valid
    assert not (after.replica_broker[moved] == 0).any()


def test_parallel_prewarm_through_shared_pool():
    """GoalOptimizer.prewarm covers mesh engines: the ranks' captures run
    on the shared warm pool and the next optimize() is a cache hit."""
    state = _state(seed=71, brokers=10, parts=120)
    opt = GoalOptimizer(config=CFG, parallel_mode="sharded", device="cpu", mesh_max_devices=4)
    opt.prewarm(state)
    assert opt.has_engine_for(state.shape, config=CFG)
    res = opt.optimize(state)
    assert next(h for h in res.history if h.get("timing"))["engine_cache_hit"] is True


# ----------------------------------------------------------------------
# tests/test_parallel.py
# ----------------------------------------------------------------------


def test_portfolio_runs_on_mesh():
    state = random_cluster(RandomClusterSpec(num_brokers=10, num_partitions=150, skew=1.5), seed=11,
                           device="cpu")
    cfg = OptimizerConfig(num_candidates=64, leadership_candidates=16, steps_per_round=6)
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    final, info = portfolio_run(eng, default_mesh(DEVS), np.full((6,), 0.05, np.float32), seed=4)
    assert info["n_chains"] == 4
    assert np.unique(np.round(info["objectives"], 3)).size > 1  # chains explore differently
    assert validate(final) == []
    assert _objective(final) <= _objective(state)


def test_portfolio_winner_matches_best_chain():
    state = random_cluster(RandomClusterSpec(num_brokers=8, num_partitions=100, skew=1.0), seed=13,
                           device="cpu")
    cfg = OptimizerConfig(num_candidates=32, leadership_candidates=8, steps_per_round=4)
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    final, info = portfolio_run(eng, default_mesh(DEVS), np.zeros((4,), np.float32), seed=5)
    obj_final = _objective(final)
    # identical placement, two evaluation paths (carry aggregates vs goals)
    assert abs(obj_final - float(info["objectives"].min())) < max(1e-3, 1e-3 * abs(obj_final))


def test_portfolio_multi_round_device_resident():
    """A [rounds, steps] schedule runs every chain's rounds with a refresh
    and a new plan between them, and never ends worse than its own first
    round."""
    state = random_cluster(RandomClusterSpec(num_brokers=10, num_partitions=150, skew=1.5), seed=19,
                           device="cpu")
    cfg = OptimizerConfig(num_candidates=64, leadership_candidates=16, steps_per_round=6)
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    temps = np.zeros((3, 6), np.float32)
    final, info = portfolio_run(eng, default_mesh(DEVS), temps, seed=4)
    assert validate(final) == []
    assert info["n_chains"] == 4 and info["accepted"].shape == (4, 3)
    obj_multi = _objective(final)
    assert obj_multi < _objective(state)
    final_1, _ = portfolio_run(eng, default_mesh(DEVS), temps[0], seed=4)
    obj_1 = _objective(final_1)
    assert obj_multi <= obj_1 + max(1e-5, abs(obj_1) * 1e-3)


def test_mesh_modes_after_device_committed_service_run():
    """The JAX package's r4 regression, in the port's terms: a service's
    single-device run in this process, THEN every mesh mode on the ranks,
    in that order, in one process."""
    from cruise_control_tpu_torch.service.main import build_simulated_service
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, _fetcher, _admin, _sampler = build_simulated_service(seed=1, device="cpu")
    try:
        assert app.cc.proposals(OperationProgress()).proposals is not None
    finally:
        app.cc.shutdown()
    state = random_cluster(RandomClusterSpec(num_brokers=10, num_partitions=120, skew=1.5), seed=23,
                           device="cpu")
    cfg = OptimizerConfig(num_candidates=64, leadership_candidates=16, steps_per_round=4,
                          num_rounds=2)
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    eng.run()
    final, info = portfolio_run(eng, default_mesh(DEVS), np.zeros((2, 4), np.float32), seed=1)
    assert validate(final) == [] and info["n_chains"] == 4
    se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=cfg)
    assert validate(se.run()[0]) == []
    ge = GridEngine(state, DEFAULT_CHAIN, mesh=grid_mesh(2, 2, DEVS), config=cfg)
    assert validate(ge.run()[0]) == []
    se.release()
    ge.release()


# ----------------------------------------------------------------------
# tests/test_bucketing.py:140, tests/test_ledger.py:186
# ----------------------------------------------------------------------


def test_sharded_exact_vs_bucketed_parity():
    """The replicated ShardedEngine over a bucketed state: the engine pads
    its input to the bucket before the split, so the exact and the bucketed
    build anneal identically and keep the caller's replica axis."""
    from cruise_control_tpu_torch.analyzer.objective import GoalChain
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.state import ShapeBucketPolicy

    policy = ShapeBucketPolicy(growth=1.25, floor=8)
    exact = random_cluster(RandomClusterSpec(num_brokers=10, num_partitions=120, skew=1.5), seed=61,
                           device="cpu")
    bucketed = pad_state(exact, policy.bucket_shape(exact.shape))
    cfg = OptimizerConfig(num_candidates=48, leadership_candidates=12, swap_candidates=6,
                          steps_per_round=4, num_rounds=2, seed=1)
    chain = GoalChain.from_names([
        "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
        "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
    ])
    se1 = ShardedEngine(exact, chain, mesh=model_mesh(DEVS), config=cfg, bucket=policy)
    se2 = ShardedEngine(bucketed, chain, mesh=model_mesh(DEVS), config=cfg, bucket=policy)
    assert se1.shape == se2.shape  # both padded to the same bucket before the split
    f1, _ = se1.run()
    f2, _ = se2.run()
    n = int(exact.replica_valid.sum())
    assert torch.equal(f1.replica_broker[:n], f2.replica_broker[:n])
    assert torch.equal(f1.replica_is_leader[:n], f2.replica_is_leader[:n])
    assert f1.shape == exact.shape and f2.shape == bucketed.shape
    se1.release()
    se2.release()


def test_diagnostics_byte_parity_mesh():
    from cruise_control_tpu_torch.testing.fixtures import random_cluster_fast

    state = random_cluster_fast(RandomClusterSpec(num_brokers=12, num_partitions=200, num_racks=3,
                                                  num_topics=6, skew=1.2), seed=7, device="cpu")
    cfg = OptimizerConfig(num_candidates=128, leadership_candidates=32, steps_per_round=8,
                          num_rounds=3, seed=2)
    off, _ = Engine(state, DEFAULT_CHAIN, config=cfg).run()
    me = MeshEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS),
                    config=dataclasses.replace(cfg, diagnostics=True))
    mstate, mhist = me.run()
    assert _same_placement(off, mstate)
    timing = next(h for h in mhist if h.get("timing"))
    assert timing["convergence"]["rounds"] >= 1
    rounds = _rounds(mhist)
    assert all("goal_violations" in r and "accepted_by_kind" in r for r in rounds)
    assert all(r["accepted"] == sum(r["accepted_by_kind"].values()) for r in rounds)
    me.release()


# ----------------------------------------------------------------------
# layouts, rule tables, collectives
# ----------------------------------------------------------------------


def test_sharding_rule_tables_name_the_jax_fields():
    """The port's rule tables shard the same fields of the engine's statics
    and carry as the JAX package's tables do of its pytrees."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
    from cruise_control_tpu.analyzer import Engine as JEngine
    from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
    from cruise_control_tpu.models import sharding as js
    from cruise_control_tpu.testing import fixtures as jf
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.models import sharding as ts

    j_eng = JEngine(jf.small_cluster(), J_CHAIN, config=JConfig(num_candidates=32,
                                                                  leadership_candidates=8))
    carry_av = jax.eval_shape(j_eng._init_impl, j_eng.statics_avals(),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))

    def j_sharded(rules, tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        specs = jax.tree_util.tree_leaves(js.match_partition_rules(rules, tree),
                                          is_leaf=lambda x: isinstance(x, P))
        return {js._path_str(p) for (p, _), spec in zip(flat, specs) if "model" in tuple(spec)}

    t_eng = Engine(_state(seed=3, brokers=6, parts=40), DEFAULT_CHAIN, config=CFG)
    t_carry = t_eng.init_carry(Key.from_seed(0))

    def t_sharded(rules, obj):
        return {p for p, lay in ts.match_partition_rules(rules, ts.field_paths(obj)).items()
                if "model" in lay}

    assert t_sharded(ts.statics_partition_rules("model"), t_eng.statics) == j_sharded(
        js.statics_partition_rules("model"), j_eng.statics)
    assert t_sharded(ts.carry_partition_rules("restart", "model"), t_carry) == j_sharded(
        js.carry_partition_rules("restart", "model"), carry_av)
    shape = t_eng.shape
    for n in (1, 3, 8):
        j = js.shard_multiple_shape(jf.small_cluster().shape, n)
        t = ts.shard_multiple_shape(jf.small_cluster().shape, n)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert ts.shard_multiple_shape(shape, 1) is shape


def _collectives_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    import json

    import torch.distributed as dist

    from cruise_control_tpu_torch.common import collectives as cc

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    rng = np.random.default_rng(11)
    rows = 12
    ints = torch.from_numpy(rng.integers(-50, 50, size=(rows, 3)).astype(np.int32))
    # quantized floats (multiples of 1/8) add exactly in any order
    floats = torch.from_numpy((rng.integers(-80, 80, size=(rows, 4)) / 8.0).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 5, size=rows).astype(np.int64))
    flags = torch.from_numpy(rng.random(rows) < 0.3)
    lo, hi = rank * rows // world, (rank + 1) * rows // world
    with cc.model_axis_scope(dist.group.WORLD):
        got = dict(
            gsum_int=cc.gsum(ints[lo:hi]), gsum_float=cc.gsum(floats[lo:hi]),
            gsum_bool=cc.gsum(flags[lo:hi]),
            seg_int=cc.gsegment_sum(ints[lo:hi], ids[lo:hi], 5),
            seg_float=cc.gsegment_sum(floats[lo:hi], ids[lo:hi], 5),
            scatter=cc.gscatter_rows(ints * (rank + 1)),
        )
    want = dict(
        gsum_int=ints.sum(), gsum_float=floats.sum(), gsum_bool=flags.sum(),
        seg_int=torch.zeros((5, 3), dtype=torch.int32).index_add_(0, ids, ints),
        seg_float=torch.zeros((5, 4)).index_add_(0, ids, floats),
        scatter=(ints * sum(range(1, world + 1)))[lo:hi],
    )
    result = {k: bool(torch.equal(got[k].to(want[k].dtype), want[k])) for k in want}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def test_collectives_over_two_gloo_ranks_match_one_process(tmp_path):
    """gsum, gsegment_sum and gscatter_rows under a model-axis scope over 2
    gloo ranks give the single process's values: ints and bools exact,
    floats exact where their partial sums add exactly (quantized values,
    the JAX docstring's condition); with no scope they are the plain ops."""
    import torch.multiprocessing as tmp

    from cruise_control_tpu_torch.common import collectives as cc
    from cruise_control_tpu_torch.parallel.ranks import _free_port

    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([0, 2, 2, 1])
    assert cc.model_axis() is None
    assert torch.equal(cc.gsum(x), x.sum())
    assert torch.equal(cc.gsegment_sum(x, ids, 3), torch.zeros(3, 3).index_add_(0, ids, x))
    assert cc.gscatter_rows(x) is x
    import json

    tmp.spawn(_collectives_rank, args=(2, f"tcp://127.0.0.1:{_free_port()}", str(tmp_path)),
              nprocs=2)
    got = {r: json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)}
    assert all(all(v.values()) for v in got.values()), got


# ----------------------------------------------------------------------
# the entry points that refused before items 10b and 10c, and a killed rank
# ----------------------------------------------------------------------


def test_model_shard_mode_runs_from_its_threshold():
    state = _state(seed=9, brokers=8, parts=96)
    sh = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS[:2]), config=CFG,
                       model_shard_min_partitions=1)
    assert sh.model_sharded
    final, hist = sh.run()
    assert validate(final) == [] and hist[-1]["model_sharded"] is True
    sh.release()
    # below the threshold the replicated mode runs
    se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS[:2]), config=CFG,
                       model_shard_min_partitions=10 ** 6)
    assert not se.model_sharded
    assert validate(se.run()[0]) == []
    se.release()
    opt = GoalOptimizer(config=CFG, parallel_mode="sharded", device="cpu", mesh_max_devices=2,
                        model_shard_min_partitions=1)
    res = opt.optimize(state)
    timing = next(h for h in res.history if h.get("timing"))
    assert timing["model_sharded"] is True and timing["mesh_shape"] == [1, 2]
    assert validate(res.state_after) == [] and not res.degraded


def test_segmented_and_resumed_mesh_runs_match_the_one_launch_run():
    state = _state(seed=9, brokers=8, parts=96)
    se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS[:2]), config=CFG)
    whole, _ = se.run()
    snaps = []
    ctx = SegmentContext(1e-3, snapshot_every=1, snapshot_sink=snaps.append)
    with segmented_execution(ctx):
        sliced, hist = se.run()
    ctx.wait_snapshot()
    assert hist[-1]["segmented"] is True and hist[-1]["segments"] >= 2
    assert _same_placement(whole, sliced)
    resumed, hist_r = se.run(resume=snaps[0])
    assert hist_r[-1]["resumed_from_round"] == snaps[0].base
    assert _same_placement(whole, resumed)
    se.release()


def test_mesh_ft_enabled_runs_the_ladder():
    from cruise_control_tpu_torch.common.device_watchdog import DeviceSupervisor
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.service.main import build_simulated_service

    on = CruiseControlConfig({"tpu.parallel.mode": "sharded"}).mesh_ft_controller()
    assert on.enabled
    state = _state(seed=9, brokers=8, parts=96)
    sup = DeviceSupervisor(op_timeout_s=120.0, max_retries=0, device="cpu")
    opt = GoalOptimizer(config=CFG, parallel_mode="sharded", device="cpu", mesh_max_devices=2,
                        mesh_ft=on, supervisor=sup)
    assert opt.parallel_mode == "sharded" and opt._mesh_ft is on
    res = opt.optimize(state)
    plain = GoalOptimizer(config=CFG, parallel_mode="sharded", device="cpu",
                          mesh_max_devices=2).optimize(state)
    assert not res.degraded and _same_placement(res.state_after, plain.state_after)
    assert not any(h.get("mesh_ft") for h in res.history)  # no degrade, no record
    app, *_ = build_simulated_service(CruiseControlConfig({"tpu.parallel.mode": "grid:2x2",
                                                           "tpu.mesh.max.devices": 4}),
                                      device="cpu")
    ft = app.cc.optimizer._mesh_ft
    assert ft is not None and ft.enabled and app.cc.optimizer.parallel_mode == "grid:2x2"
    app.cc.shutdown()


def test_killed_rank_raises_a_typed_error_then_the_group_is_rebuilt():
    """A rank killed under an engine makes the next call raise RankDiedError
    well inside the deadline (the caller watches the processes, never
    waits out a collective), tears the group down, and the call after it
    rebuilds the group and the engine and answers as before."""
    state = _state(seed=13, brokers=8, parts=96)
    se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=CFG, timeout_s=60)
    before, _ = se.run()
    group = rank_group(DEVS)
    old_pids = group.pids
    group.kill_rank(2)
    t0 = time.monotonic()
    with pytest.raises(RankDiedError) as e:
        se.run()
    assert time.monotonic() - t0 < 10.0 and e.value.rank == 2
    assert not group.alive
    assert all(not _alive(pid) for pid in old_pids)
    after, hist = se.run()  # a new group, the engine rebuilt on it
    assert _same_placement(before, after)
    new = rank_group(DEVS)
    assert new is not group and new.pids != old_pids
    assert [a["rank"] for a in new.call("probe")] == [0, 1, 2, 3]
    se.release()


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split()[2] != "Z"
