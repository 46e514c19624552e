"""The sharded-model mode on FLOAT loads is a function of (state, seed,
config, mesh width) alone (parallel/model_shard.py, common/collectives.py).

- (a) `all_reduce_sum` of a float over n = 2 and n = 4 gloo ranks is the
  numpy left fold of the ranks' partials in rank order, bit for bit, on
  every rank, where other associations of the same partials give other
  bits; integers still go through all_reduce; `gscatter_rows` refuses a
  float and `gsegment_sum` a float off the CPU under a model axis; and a
  rank's refresh, plan and hops issue the collectives, by kind and bytes,
  that `refresh_sum_words`, `psum_bytes_per_step` and
  `psum_bytes_per_round` count.
- (b) On a small fixture with float loads, padded to the shard multiple,
  the 1x4 mode gives the same placements and objective, bit for bit, in a
  repeated run of one engine, a run of a fresh engine and a run on a fresh
  rank group (new rank processes); after each run the four ranks hold the
  same replicated carry.
- (c) The same run holds goal quality against the JAX package's
  sharded-model mode 1x4 on the conftest's virtual CPU devices.
- The broker CDF's scan on the card (`scan_fixed_order`) adds in an order
  fixed by each element's index (PyTorch's CUDA cumsum does not).
- A rank group whose store port was taken starts again on another.

Integer loads: tests/test_torch_model_shard.py (`test_three_way_byte_parity`,
`test_gsegment_sum_over_gloo_is_exact`).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.engine import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.objective import DEFAULT_CHAIN as JCHAIN
from cruise_control_tpu.models.builder import pad_state as j_pad
from cruise_control_tpu.models.sharding import shard_multiple_shape as j_multiple
from cruise_control_tpu.parallel.mesh import MeshEngine as JMesh
from cruise_control_tpu.parallel.mesh import grid_mesh as j_grid
from cruise_control_tpu.testing.fixtures import RandomClusterSpec as JSpec
from cruise_control_tpu.testing.fixtures import random_cluster_fast as j_cluster
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, OptimizerConfig
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.parallel import MeshEngine, close_rank_groups, cpu_devices, grid_mesh

N = 4
#: the float-load runs: enough steps that the fixture converges (every
#: goal met), which goal quality needs
CFG = dict(num_candidates=256, leadership_candidates=64, steps_per_round=16, num_rounds=4, seed=3)
#: the collective counts' run: any few rounds do
COUNTS_CFG = dict(num_candidates=48, leadership_candidates=16, swap_candidates=8,
                  steps_per_round=4, num_rounds=2, seed=3)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
#: (c)'s bar on the objective, chip_smoke.py `goal_quality`'s: the two
#: modes' broker sums add in other orders, so their trajectories may part;
#: both end converged, at ~1e-8 on this fixture, so the bar is the
#: violation threshold's, not relative
OBJECTIVE_ATOL = 1e-6
#: the float partials of (a): rows of [W] floats a rank, magnitudes over
#: six decades, so that any other order of the additions rounds otherwise
ROWS, W = 8, 512


def _left_fold(parts):
    acc = parts[0].copy()
    for p in parts[1:]:
        acc = (acc + p).astype(np.float32)
    return acc


def _rows(rank: int) -> np.ndarray:
    rng = np.random.default_rng(40 + rank)
    return (rng.lognormal(0.0, 3.0, (ROWS, W)) * rng.choice([-1.0, 1.0], (ROWS, W))).astype(np.float32)


def _counts_run(rank: int, world: int, group) -> dict:
    """A rank's ModelShardEngine run on a small float-load fixture, with
    each refresh's, plan's and step's collective counts."""
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS
    from cruise_control_tpu_torch.common import collectives
    from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.parallel.mesh import kind_split
    from cruise_control_tpu_torch.parallel.model_shard import (
        PLAN_OBJECTIVE_WORDS, ModelShardEngine, psum_bytes_per_round, psum_bytes_per_step,
        refresh_sum_words)
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    st = random_cluster_fast(RandomClusterSpec(num_brokers=12, num_partitions=160, skew=1.5), seed=21,
                             device="cpu")
    st = pad_state(st, shard_multiple_shape(st.shape, world))
    cfg = OptimizerConfig(**COUNTS_CFG)
    eng = ModelShardEngine(st, DEFAULT_CHAIN, DEFAULT_CONSTRAINT, DEFAULT_OPTIONS, cfg,
                           key=Key.from_seed(cfg.seed), shard=(rank, world), group=group,
                           device=torch.device("cpu"))
    calls: dict = {"refresh": [], "plan": [], "gather_bundles": []}

    def counted(name):
        fn = getattr(eng, name)

        def call(*a, **k):
            before = collectives.counts()
            res = fn(*a, **k)
            calls[name].append({k: v - before[k] for k, v in collectives.counts().items()})
            return res

        setattr(eng, name, call)

    for name in calls:
        counted(name)
    eng._run_fused()
    s = eng.gshape
    split = kind_split(cfg)
    return dict(calls=calls, refresh_words=list(refresh_sum_words(s)), B=s.B,
                plan_words=2 * s.B + PLAN_OBJECTIVE_WORDS,
                step_bytes=psum_bytes_per_step(*split, eng.max_rf, s.num_racks),
                round_bytes=psum_bytes_per_round(s, cfg, split, eng.max_rf))


def _float_sum_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist

    from cruise_control_tpu_torch.common import collectives

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    pair = dist.new_group([0, 1])
    out: dict = {}
    for n, group in ((2, pair), (world, dist.group.WORLD)):
        if rank >= n:
            continue
        # each rank's partial: its rows added in row order
        partial = _left_fold(list(_rows(rank)))
        before = collectives.counts()
        got = collectives.all_reduce_sum(torch.from_numpy(partial.copy()), group).numpy()
        after = collectives.counts()
        ints = torch.from_numpy(_rows(rank)[0].astype(np.int64) % 1000)
        collectives.all_reduce_sum(ints, group)
        out[n] = dict(bits=got.view(np.int32).tolist(), int_sum=ints.tolist(),
                      counted={k: after[k] - before[k] for k in after})
    with collectives.model_axis_scope(dist.group.WORLD):
        refused = []
        for call in (lambda: collectives.gscatter_rows(torch.zeros((8, 2))),
                     lambda: collectives.gsegment_sum(torch.zeros((4, 2), device="meta"),
                                                      torch.zeros(4, dtype=torch.int64,
                                                                  device="meta"), 3)):
            try:
                call()
                refused.append(False)
            except ValueError:
                refused.append(True)
        out["refused"] = refused
    out["counts"] = _counts_run(rank, world, dist.group.WORLD)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def float_sums(tmp_path_factory):
    import torch.multiprocessing as tmp

    from cruise_control_tpu_torch.parallel.ranks import START_ATTEMPTS, _free_port

    d = tmp_path_factory.mktemp("float_sums")
    for attempt in range(START_ATTEMPTS):
        try:
            tmp.spawn(_float_sum_rank, args=(N, f"tcp://127.0.0.1:{_free_port()}", str(d)),
                      nprocs=N)
            break
        except tmp.ProcessRaisedException as e:
            # the store's port taken by another process between choice and bind
            if "EADDRINUSE" not in str(e) or attempt + 1 == START_ATTEMPTS:
                raise
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(N)]


@pytest.mark.parametrize("n", [2, 4])
def test_float_sum_is_the_left_fold_in_rank_order(float_sums, n):
    rows = [_rows(r) for r in range(n)]
    partials = [_left_fold(list(r)) for r in rows]
    want = _left_fold(partials)
    for rank in range(n):
        got = np.asarray(float_sums[rank][str(n)]["bits"], np.int32)
        np.testing.assert_array_equal(got, want.view(np.int32), err_msg=f"rank {rank}")
        # one all_gather of the partials, no all_reduce of a float
        assert float_sums[rank][str(n)]["counted"] == dict(
            all_reduce=0, reduce_scatter=0, all_gather=1, bytes=4 * W)
    # other associations of the same numbers give other bits, so the
    # check above tells the fold from them: one process's row order ...
    one_process = _left_fold([r for block in rows for r in block])
    assert (one_process.view(np.int32) != want.view(np.int32)).any()
    if n == 4:
        # ... and the partials paired, or folded from the last rank
        pairs = ((partials[0] + partials[1]).astype(np.float32)
                 + (partials[2] + partials[3]).astype(np.float32)).astype(np.float32)
        assert (pairs.view(np.int32) != want.view(np.int32)).any()
        assert (_left_fold(partials[::-1]).view(np.int32) != want.view(np.int32)).any()


@pytest.mark.parametrize("n", [2, 4])
def test_integer_sum_stays_an_all_reduce(float_sums, n):
    want = sum(_rows(r)[0].astype(np.int64) % 1000 for r in range(n))
    for rank in range(n):
        assert float_sums[rank][str(n)]["int_sum"] == want.tolist()


def test_no_float_reduce_scatter_or_card_segment_sum(float_sums):
    assert all(r["refused"] == [True, True] for r in float_sums)


def test_rank_collectives_match_the_analytic_count(float_sums):
    for rank, r in enumerate(float_sums):
        c = r["counts"]
        calls = c["calls"]
        assert calls["refresh"] and calls["plan"] and calls["gather_bundles"]
        for got in calls["refresh"]:
            # the float sums gathered, the counts all-reduced, the cells reduce-scattered
            assert got == dict(all_reduce=1, reduce_scatter=1, all_gather=1,
                               bytes=4 * sum(c["refresh_words"])), (rank, got)
        for got in calls["plan"]:
            # count_g, the carry objective's two int64 sums; `below`'s gather
            assert got == dict(all_reduce=3, reduce_scatter=0, all_gather=1,
                               bytes=4 * c["plan_words"]), (rank, got)
        for got in calls["gather_bundles"]:
            assert got == dict(all_reduce=4, reduce_scatter=0, all_gather=0,
                               bytes=c["step_bytes"]), (rank, got)
        cfg = OptimizerConfig(**COUNTS_CFG)
        assert c["round_bytes"] == (cfg.steps_per_round * c["step_bytes"]
                                    + 4 * (sum(c["refresh_words"]) + c["plan_words"] + 64))


def test_a_rank_group_whose_port_is_taken_starts_on_another(monkeypatch):
    """parallel/ranks.py: the port a group's store gets is free when
    chosen, not held, so another process may bind it first (EADDRINUSE on
    rank 0); the group then starts again on a new port."""
    import socket

    from cruise_control_tpu_torch.parallel import ranks

    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    chosen = iter([taken.getsockname()[1]])
    free = ranks._free_port
    monkeypatch.setattr(ranks, "_free_port", lambda: next(chosen, None) or free())
    try:
        g = ranks.RankGroup(cpu_devices(2))
        try:
            assert g.alive and g.probe() == {0: None, 1: None}
        finally:
            g.close()
    finally:
        taken.close()


def _hillis_steele(x: np.ndarray) -> np.ndarray:
    y, off = x.copy(), 1
    while off < y.size:
        y = np.concatenate([y[:off], (y[off:] + y[:-off]).astype(np.float32)])
        off *= 2
    return np.maximum.accumulate(y)


@pytest.mark.parametrize("n", [1, 2, 2600, 25_000])
def test_fixed_order_scan(n):
    """The card's broker-CDF scan (analyzer/engine.py `scan_fixed_order`,
    which `_cumsum_f32` takes on CUDA) adds in the Hillis-Steele order, bit
    for bit, whatever runs it: each element's sum depends on the prefix up
    to it alone, and the result is nondecreasing for non-negative terms
    (zero terms included, as the padding brokers give)."""
    from cruise_control_tpu_torch.analyzer.engine import scan_fixed_order

    rng = np.random.default_rng(n)
    x = rng.lognormal(0.0, 2.0, n).astype(np.float32)
    x[::7] = 0.0
    got = scan_fixed_order(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _hillis_steele(x).view(np.int32))
    assert (np.diff(got) >= 0).all()
    np.testing.assert_array_equal(scan_fixed_order(torch.from_numpy(x[: n // 2 + 1])).numpy(),
                                  got[: n // 2 + 1])
    seq = np.cumsum(x, dtype=np.float32)
    assert np.abs(got - seq).max() <= 1e-5 * seq[-1]


@pytest.fixture(scope="module")
def float_states():
    """tests/test_torch_model_shard.py's fixture with its float loads kept,
    padded to the shard multiple; and the port's copy of it."""
    js = j_cluster(JSpec(num_brokers=12, num_partitions=160, skew=1.5), seed=21)
    js = j_pad(js, j_multiple(js.shape, N))
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return js, from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


@pytest.fixture(scope="module")
def float_runs(float_states):
    js, ts = float_states
    mesh = grid_mesh(1, N, cpu_devices(N))
    runs = []
    try:
        me = MeshEngine(ts, DEFAULT_CHAIN, mesh=mesh, config=OptimizerConfig(**CFG),
                        model_shard_min_partitions=1)
        assert me.model_sharded
        for _ in range(2):
            runs.append((*me.run(), me.carry_digests()))
        me.release()
        fresh = MeshEngine(ts, DEFAULT_CHAIN, mesh=mesh, config=OptimizerConfig(**CFG),
                           model_shard_min_partitions=1)
        runs.append((*fresh.run(), fresh.carry_digests()))
        fresh.release()
        # new rank processes
        close_rank_groups()
        group = MeshEngine(ts, DEFAULT_CHAIN, mesh=mesh, config=OptimizerConfig(**CFG),
                           model_shard_min_partitions=1)
        runs.append((*group.run(), group.carry_digests()))
        group.release()
    finally:
        close_rank_groups()
    jme = JMesh(js, JCHAIN, mesh=j_grid(1, N, jax.devices()[:N]), config=JConfig(**CFG),
                model_shard_min_partitions=1)
    assert jme.model_sharded
    jfinal = jme.run()[0]
    jstate = from_jax_arrays({f: np.asarray(getattr(jfinal, f)) for f in STATE_FIELDS}, "cpu",
                             shape=dataclasses.asdict(jfinal.shape))
    return runs, jstate


def test_float_load_runs_are_bit_for_bit_reproducible(float_runs):
    runs, _ = float_runs
    first = runs[0][0]
    objectives = []
    for final, hist, _digests in runs:
        for f in PLACEMENT:
            assert torch.equal(getattr(final, f), getattr(first, f)), f
        objectives.append(np.float32(DEFAULT_CHAIN.evaluate(final)[0]).tobytes())
        assert [h["accepted"] for h in hist if "round" in h] == [
            h["accepted"] for h in runs[0][1] if "round" in h]
    assert len(set(objectives)) == 1
    # the moves really depend on the float loads: some move was accepted
    assert sum(h["accepted"] for h in runs[0][1] if "round" in h) > 0


def test_ranks_hold_the_same_replicated_carry(float_runs):
    runs, _ = float_runs
    for _final, _hist, digests in runs:
        assert len(digests) == N and len(set(digests)) == 1, digests


def test_float_load_goal_quality_against_the_jax_sharded_mode(float_runs):
    runs, jstate = float_runs
    hard = DEFAULT_CHAIN.hard_mask()
    o_port, v_port, _ = DEFAULT_CHAIN.evaluate(runs[0][0])
    o_jax, v_jax, _ = DEFAULT_CHAIN.evaluate(jstate)
    v_port, v_jax = v_port.numpy(), v_jax.numpy()
    assert v_port[hard].max() <= 1e-6 and v_jax[hard].max() <= 1e-6
    np.testing.assert_array_equal(v_port > 1e-6, v_jax > 1e-6)
    assert abs(float(o_port) - float(o_jax)) <= OBJECTIVE_ATOL, (float(o_port), float(o_jax))
