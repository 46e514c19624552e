"""The port's sharded-model mode (parallel/model_shard.py,
kernels/model_shard.py) on the CPU, over one module-scoped group of 4 gloo
ranks.

The port's statements of the JAX package's tests/test_model_shard.py:
- `test_three_way_byte_parity`: with integer-quantized loads, the plain
  engine, the replicated 1x4 mesh and the sharded-model 1x4 mesh give the
  same placements, objective and violations, bit for bit, and the same
  placements as the JAX package's sharded-model mode on its virtual
  devices; `test_timing_record_keys` holds its timing-record contract;
- `test_sharded_mode_gate`: the threshold;
- `test_gsegment_sum_over_gloo_is_exact`: shard-local segment sums plus an
  all_reduce over 4 gloo ranks are the one-process segment sum, bit for
  bit, on integer-quantized loads;
- `test_local_groupings_rebuild_the_global_grouped_order` stands for
  :140 and :162 (`stable_grouped_order` and its miscompile guard): the
  port's `group_by_broker` is a counting sort, and the shards' local
  groupings with `below` rebuild the global grouped order;
- `test_subthreshold_run_issues_no_model_axis_all_reduce` stands for :208
  (an HLO read): the port counts its own collective calls.

And the plain versions of the mode's kernels, on one process with n = 2
and n = 4 emulated shards (a sum of the shard bundles in place of the
all_reduce): the ownership gathers and the body against the whole model's
candidates, the offset apply against the whole apply, the local refresh
against the whole refresh; hop 4's one entry (`own_member_rows`) against
the two `own_rows` calls it merges; the assembled bundles against the JAX
package's arrays gathered at its own step's proposals; and every gather
raising, never taking its plain version, for a tensor off the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.engine import Engine as JEngine
from cruise_control_tpu.analyzer.engine import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.objective import DEFAULT_CHAIN as JCHAIN
from cruise_control_tpu.models.builder import pad_state as j_pad
from cruise_control_tpu.models.sharding import shard_multiple_shape as j_multiple
from cruise_control_tpu.parallel.mesh import MeshEngine as JMesh
from cruise_control_tpu.parallel.mesh import grid_mesh as j_grid
from cruise_control_tpu.testing.fixtures import RandomClusterSpec as JSpec
from cruise_control_tpu.testing.fixtures import random_cluster_fast as j_cluster
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine, OptimizerConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.engine import SamplingPlan
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import apply as apply_k
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.kernels import model_shard as ms_k
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.kernels.group import group_placement
from cruise_control_tpu_torch.kernels.refresh import refresh_aggregates
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.parallel import MeshEngine, close_rank_groups, cpu_devices, grid_mesh
from cruise_control_tpu_torch.parallel.model_shard import ShardPlan, shard_views
from cruise_control_tpu_torch.parallel.ranks import rank_group

N = 4
CFG = dict(num_candidates=48, leadership_candidates=16, swap_candidates=8, steps_per_round=4,
           num_rounds=2, seed=3)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
AGG = ("broker_load", "broker_replica_count", "broker_leader_count", "broker_potential_nw_out",
       "broker_leader_bytes_in", "broker_topic_count", "disk_load")


@pytest.fixture(scope="module", autouse=True)
def world():
    g = rank_group(cpu_devices(N))
    yield g
    close_rank_groups()


@pytest.fixture(scope="module")
def states():
    """The JAX package's fixture of tests/test_model_shard.py: loads scaled
    by 8 and rounded (every partial sum exact in f32), padded to the shard
    multiple (the goals normalise by the padded partition count); and the
    port's copy of it."""
    js = j_cluster(JSpec(num_brokers=12, num_partitions=160, skew=1.5), seed=21)
    js = dataclasses.replace(js, replica_load_leader=jnp.round(js.replica_load_leader * 8),
                             replica_load_follower=jnp.round(js.replica_load_follower * 8))
    js = j_pad(js, j_multiple(js.shape, N))
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return js, from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


@pytest.fixture(scope="module")
def runs(states):
    js, ts = states
    out = {}
    for name, me in (
        ("plain", Engine(ts, DEFAULT_CHAIN, config=OptimizerConfig(**CFG))),
        ("replicated", MeshEngine(ts, DEFAULT_CHAIN, mesh=grid_mesh(1, N, cpu_devices(N)),
                                  config=OptimizerConfig(**CFG))),
        ("sharded", MeshEngine(ts, DEFAULT_CHAIN, mesh=grid_mesh(1, N, cpu_devices(N)),
                               config=OptimizerConfig(**CFG), model_shard_min_partitions=1)),
    ):
        final, hist = me.run()
        obj, viol, _ = DEFAULT_CHAIN.evaluate(final)
        info = getattr(me, "last_info", None)
        out[name] = (final, float(obj), viol.numpy(), hist, info)
        me.release()
    jme = JMesh(js, JCHAIN, mesh=j_grid(1, N, jax.devices()[:N]), config=JConfig(**CFG),
                model_shard_min_partitions=1)
    assert jme.model_sharded
    out["jax_sharded"] = jme.run()
    return out


def test_three_way_byte_parity(runs):
    for f in PLACEMENT:
        a, b, c = (getattr(runs[n][0], f).numpy() for n in ("plain", "replicated", "sharded"))
        np.testing.assert_array_equal(a, b, err_msg=f"plain vs replicated: {f}")
        np.testing.assert_array_equal(b, c, err_msg=f"replicated vs sharded: {f}")
        np.testing.assert_array_equal(c, np.asarray(getattr(runs["jax_sharded"][0], f)),
                                      err_msg=f"port vs JAX sharded: {f}")
    assert runs["plain"][1] == runs["replicated"][1] == runs["sharded"][1]
    np.testing.assert_array_equal(runs["plain"][2], runs["sharded"][2])
    # the same rounds, accepting the same moves
    rounds = [[h["accepted"] for h in runs[n][3] if "round" in h]
              for n in ("plain", "replicated", "sharded")]
    assert rounds[0] == rounds[1] == rounds[2]


def test_timing_record_keys(runs):
    timing = runs["sharded"][3][-1]
    assert timing.get("model_sharded") is True
    assert timing.get("model_psum_bytes", 0) > 0
    assert timing["collective_bytes"] == timing["model_psum_bytes"]
    timing = runs["replicated"][3][-1]
    assert "model_sharded" not in timing
    assert "model_psum_bytes" not in timing


def test_sharded_mode_gate(states):
    _, ts = states
    mesh = grid_mesh(1, N, cpu_devices(N))
    cfg = OptimizerConfig(**CFG)
    built = []
    for kw, sharded in ((dict(), False), (dict(model_shard_min_partitions=10 ** 9), False),
                        (dict(model_shard_min_partitions=ts.shape.P), True),
                        (dict(model_shard_min_partitions=ts.shape.P + 1), False)):
        me = MeshEngine(ts, DEFAULT_CHAIN, mesh=mesh, config=cfg, **kw)
        built.append(me)
        assert me.model_sharded is sharded, kw
    # a model axis of 1 never shards
    one = MeshEngine(ts, DEFAULT_CHAIN, mesh=grid_mesh(1, 1, cpu_devices(1)), config=cfg,
                     model_shard_min_partitions=1)
    assert not one.model_sharded
    for me in (*built, one):
        me.release()


def _gseg_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist

    from cruise_control_tpu_torch.common.collectives import gsegment_sum, model_axis_scope

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    rng = np.random.default_rng(5)
    R, B = 2048, 24
    vals = torch.from_numpy(rng.integers(0, 512, size=(R, 4)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, B, size=R).astype(np.int64))
    ref = torch.zeros((B, 4)).index_add_(0, seg, vals)
    lo, hi = rank * (R // world), (rank + 1) * (R // world)
    with model_axis_scope(dist.group.WORLD):
        got = gsegment_sum(vals[lo:hi], seg[lo:hi], B)
    same = bool(torch.equal(got.view(torch.int32), ref.view(torch.int32)))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(same=same), f)
    dist.destroy_process_group()


def test_gsegment_sum_over_gloo_is_exact(tmp_path):
    import torch.multiprocessing as tmp

    from cruise_control_tpu_torch.parallel.ranks import _free_port

    tmp.spawn(_gseg_rank, args=(N, f"tcp://127.0.0.1:{_free_port()}", str(tmp_path)), nprocs=N)
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())["same"] for r in range(N)]
    assert all(got), got


class _Emulation:
    """n shards of a whole engine's carry on one process (the plain
    versions); the all_reduce is a sum of the shard bundles."""

    def __init__(self, eng, carry, plan, n):
        s = eng.shape
        self.blks = [ms_k.Block.of(s.R, s.P, j, n) for j in range(n)]
        self.views = [shard_views(eng.statics, carry, b) for b in self.blks]
        self.groups = [group_placement(c.replica_broker, sx.state.replica_valid, s.B)
                       for sx, c in self.views]
        counts = torch.stack([g.count for g in self.groups])
        self.plans = [ShardPlan(broker_cdf=plan.broker_cdf, order=g.order, start=g.start,
                                count=plan.count, count_local=g.count,
                                below=counts[:j].sum(0).to(torch.int32), start_global=plan.start,
                                replica_cost=plan.replica_cost, lead_cost=plan.lead_cost)
                      for j, g in enumerate(self.groups)]

    def hop(self, fn):
        return sum(fn(j, sx, c) for j, (sx, c) in enumerate(self.views))


@pytest.fixture(scope="module")
def step(states):
    _, ts = states
    eng = Engine(ts, DEFAULT_CHAIN, config=OptimizerConfig(num_candidates=256,
                                                           leadership_candidates=64, seed=1))
    carry = eng.init_carry(Key.from_seed(1))
    plan = eng.plan(carry)
    g = eng._globals(carry)
    keys = cand_k.StepKeys.of(carry.key)
    temp = torch.full((1,), float(eng.evaluate(carry)[0]) * 0.01)
    full = cand_k.candidates(eng.cand, eng.statics, carry, keys, g, plan, temp)
    return eng, carry, plan, g, keys, temp, full


@pytest.mark.parametrize("n", [2, 4])
def test_ownership_gathers_and_body_equal_the_whole_models(step, n):
    eng, carry, plan, g, keys, temp, full = step
    cp, s = eng.cand, eng.shape
    em = _Emulation(eng, carry, plan, n)
    max_rf, pw = eng.max_rf, eng.max_rf + s.num_racks
    n_rs = cp.K_r + 2 * cp.K_s
    ids = em.hop(lambda j, sx, c: ms_k.shard_sources(cp, keys, em.plans[j], sx.gen, em.blks[j], True))
    assert torch.equal(ids, torch.cat([full["payr"]["r"], full["payl"]["rt"]]).to(torch.int32))
    rows = em.hop(lambda j, sx, c: ms_k.own_rows(ids, ms_k.ROW_WORDS,
                                                 ms_k.row_columns(sx.state, c), em.blks[j]))
    whole = ms_k.Block(0, s.R, 0, s.P, 0, 1)
    cols = ms_k.row_columns(eng.statics.state, carry)
    assert torch.equal(rows, ms_k.own_rows_plain(ids, ms_k.ROW_WORDS, cols, whole))
    parts = em.hop(lambda j, sx, c: ms_k.own_parts(rows.view(-1)[1:], int(ids.shape[0]),
                                                   ms_k.ROW_WORDS, sx.part_replicas,
                                                   c.part_rack_count, em.blks[j]))
    assert torch.equal(parts, ms_k.own_parts_plain(rows[:, 1], eng.statics.part_replicas,
                                                   carry.part_rack_count, whole))
    mb = em.hop(lambda j, sx, c: ms_k.own_rows(parts, 1, ms_k.row_columns(sx.state, c),
                                               em.blks[j], m=max_rf, stride=pw, n=n_rs))
    ml = em.hop(lambda j, sx, c: ms_k.own_rows(parts[n_rs:], ms_k.ROW_WORDS,
                                               ms_k.row_columns(sx.state, c), em.blks[j],
                                               m=max_rf, stride=pw, n=cp.K_l))
    sh = cand_k.ShardBundles(ids=ids, rows=rows, parts=parts, mb=mb, ml=ml, shape=s)
    body = cand_k.candidates_shard(cp, em.views[1][0], em.views[1][1], keys, g, em.plans[1],
                                   temp, sh)
    for f in ("delta", "feas", "accept", "src", "dst", "part1", "part2"):
        assert torch.equal(body[f], full[f]), f
    for grp in ("payr", "payl"):
        for f in full[grp]:
            assert torch.equal(body[grp][f], full[grp][f]), (grp, f)


@pytest.mark.parametrize("n", [2, 4])
def test_offset_apply_writes_the_blocks_of_the_whole_apply(step, n):
    eng, carry, plan, _g, _keys, _temp, full = step
    s = eng.shape
    survive, sv_r, _ = select_k.select_survivors(
        full["accept"], full["delta"], full["src"], full["dst"], full["part1"], full["part2"],
        num_brokers=s.B, num_parts=s.P, n_r=full["nr"], n_s=full["ns"])
    assert int(survive.sum()) > 0
    sv_l = survive[full["nr"] + full["ns"]:]
    whole = carry.clone()
    apply_k.apply_moves(eng.statics, whole, sv_r, full["payr"], sv_l, full["payl"])
    em = _Emulation(eng, carry, plan, n)
    for b, (sx, c_j) in zip(em.blks, em.views):
        c = dataclasses.replace(carry.clone(), **{f: getattr(c_j, f).clone() for f in (
            *PLACEMENT, "part_rack_count")})
        apply_k.apply_moves(sx, c, sv_r, full["payr"], sv_l, full["payl"], r_off=b.r_off,
                            p_off=b.p_off)
        r0, r1, p0, p1 = b.r_off, b.r_off + b.r_local, b.p_off, b.p_off + b.p_local
        for f in PLACEMENT:
            assert torch.equal(getattr(c, f), getattr(whole, f)[r0:r1]), f
        assert torch.equal(c.part_rack_count, whole.part_rack_count[p0:p1])
        for f in (*AGG, "host_load"):
            assert torch.equal(getattr(c, f), getattr(whole, f)), f


@pytest.mark.parametrize("n", [2, 4])
def test_local_refresh_sums_to_the_whole_refresh(step, n):
    eng, carry, plan, *_ = step
    s = eng.shape
    em = _Emulation(eng, carry, plan, n)
    sums, prc = None, None
    for b, (sx, c) in zip(em.blks, em.views):
        view = dataclasses.replace(sx.state,
                                   replica_partition=torch.zeros_like(sx.state.replica_partition))
        part = {k: torch.zeros_like(getattr(carry, k)) for k in AGG}
        part["part_rack_count"] = torch.zeros((b.p_local, s.num_racks), dtype=torch.int32)
        refresh_aggregates(view, c.replica_broker, c.replica_is_leader, c.replica_disk, part,
                           members=torch.full((b.p_local, 1), -1, dtype=torch.int32))
        contrib = ms_k.shard_prc(sx.state, c.replica_broker, s.P)
        sums = part if sums is None else {k: sums[k] + part[k] for k in sums}
        prc = contrib if prc is None else prc + contrib
    for k in AGG:
        assert torch.equal(sums[k], getattr(carry, k)), k
    assert torch.equal(prc, carry.part_rack_count)


def test_local_groupings_rebuild_the_global_grouped_order(step):
    eng, carry, plan, *_ = step
    s = eng.shape
    for n in (2, 4):
        em = _Emulation(eng, carry, plan, n)
        rebuilt = torch.full((s.R,), -1, dtype=torch.int64)
        for j, (b, gp) in enumerate(zip(em.blks, em.groups)):
            c = em.views[j][1]
            k = torch.arange(int(gp.count.sum()))
            bro = c.replica_broker[gp.order[k].long()].long()
            pos = plan.start[bro] + em.plans[j].below[bro] + (k - gp.start[bro])
            rebuilt[pos] = gp.order[k].long() + b.r_off
        grouped = int(plan.count.sum())
        assert torch.equal(rebuilt[:grouped], plan.order[:grouped].long())


def test_subthreshold_run_issues_no_model_axis_all_reduce(runs):
    replicated = runs["replicated"][4]
    assert all(c == dict(all_reduce=0, reduce_scatter=0, all_gather=0, bytes=0)
               for c in replicated["model_collectives"])
    assert all(n > 0 for n in replicated["gather_calls"])  # the candidate gather is there
    sharded = runs["sharded"][4]
    assert all(c["all_reduce"] > 0 and c["reduce_scatter"] > 0 for c in sharded["model_collectives"])
    assert sharded["gather_calls"] == [0] * N


def _hop3(eng, carry, keys, em):
    """The assembled ids, rows and parts bundles of an emulated step."""
    cp = eng.cand
    ids = em.hop(lambda j, sx, c: ms_k.shard_sources(cp, keys, em.plans[j], sx.gen, em.blks[j], True))
    rows = em.hop(lambda j, sx, c: ms_k.own_rows(ids, ms_k.ROW_WORDS,
                                                 ms_k.row_columns(sx.state, c), em.blks[j]))
    parts = em.hop(lambda j, sx, c: ms_k.own_parts(rows.view(-1)[1:], int(ids.shape[0]),
                                                   ms_k.ROW_WORDS, sx.part_replicas,
                                                   c.part_rack_count, em.blks[j]))
    return ids, rows, parts


@pytest.mark.parametrize("split", ["step", "no_leadership", "leadership_only"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_hop4_entry_equals_the_two_own_rows_calls(step, n, split):
    """`own_member_rows` (hop 4 in one launch on the card) writes each
    shard's bundle as the two `own_rows` calls it replaces, one after the
    other, also with no leadership rows (K_l = 0) and with no relocation
    or swap rows (n_rs = 0); the shards' bundles sum to the whole model's."""
    eng, carry, plan, _g, keys, _temp, _full = step
    cp, s = eng.cand, eng.shape
    em = _Emulation(eng, carry, plan, n)
    _, _, parts = _hop3(eng, carry, keys, em)
    max_rf, pw = eng.max_rf, eng.max_rf + s.num_racks
    n_rs = dict(step=cp.K_r + 2 * cp.K_s, no_leadership=int(parts.shape[0]), leadership_only=0)[split]
    n_l = int(parts.shape[0]) - n_rs
    got = []
    for j, (sx, c) in enumerate(em.views):
        cols = ms_k.row_columns(sx.state, c)
        mrows = ms_k.own_member_rows(parts, n_rs, max_rf, cols, em.blks[j])
        mb = ms_k.own_rows(parts, 1, cols, em.blks[j], m=max_rf, stride=pw, n=n_rs)
        ml = ms_k.own_rows(parts[n_rs:], ms_k.ROW_WORDS, cols, em.blks[j], m=max_rf, stride=pw, n=n_l)
        assert mrows.shape == (n_rs * max_rf + n_l * max_rf * ms_k.ROW_WORDS,)
        assert torch.equal(mrows, torch.cat([mb.reshape(-1), ml.reshape(-1)]))
        buf = torch.full_like(mrows, -7)
        assert ms_k.own_member_rows(parts, n_rs, max_rf, cols, em.blks[j], out=buf) is buf
        assert torch.equal(buf, mrows)
        got.append(mrows)
    whole = ms_k.Block(0, s.R, 0, s.P, 0, 1)
    want = ms_k.own_member_rows_plain(parts, n_rs, max_rf, ms_k.row_columns(eng.statics.state, carry),
                                      whole)
    assert torch.equal(sum(got), want)


def test_hop4_entry_refuses_a_split_past_the_bundle(step):
    eng, carry, plan, _g, keys, _temp, _full = step
    em = _Emulation(eng, carry, plan, 2)
    _, _, parts = _hop3(eng, carry, keys, em)
    sx, c = em.views[0]
    cols = ms_k.row_columns(sx.state, c)
    for n_rs, max_rf in ((-1, eng.max_rf), (int(parts.shape[0]) + 1, eng.max_rf), (0, 0),
                         (0, int(parts.shape[1]) + 1)):
        with pytest.raises(ValueError, match="hop 4"):
            ms_k.own_member_rows(parts, n_rs, max_rf, cols, em.blks[0])


@pytest.fixture(scope="module")
def jax_step(states):
    """The JAX package's plain engine on the module's fixture: its step's
    proposals (the same keys as the port's `step` fixture), its plan, its
    statics and carry."""
    js, _ = states
    je = JEngine(js, JCHAIN, config=JConfig(num_candidates=256, leadership_candidates=64, seed=1))
    jc = je._jit_init(je.statics, jax.random.PRNGKey(1))
    jp = je._jit_plan(je.statics, jc)
    _, k_r, k_s, k_l, _ = jax.random.split(jc.key, 5)
    raw = je._propose_kinds(je.statics, jc, k_r, k_s, k_l, je._globals(je.statics, jc), jp)
    return je, jc, jp, je._assemble_prop(je.statics, jc, *raw)


def _gather_rows(cols: dict, ids: np.ndarray, R: int) -> np.ndarray:
    """i32[ids.size, 18]: the JAX arrays' replica rows at ids (ROW_FIELDS,
    floats as their bits), zeros at ids out of [0, R)."""
    flat = ids.reshape(-1)
    ok = (flat >= 0) & (flat < R)
    at = np.where(ok, flat, 0)
    out = np.concatenate([
        np.stack([cols[f][at].astype(np.int32) for f in ms_k.ROW_FIELDS[:10]], 1),
        cols["load_leader"][at].astype(np.float32).view(np.int32),
        cols["load_follower"][at].astype(np.float32).view(np.int32),
    ], 1)
    return np.where(ok[:, None], out, 0)


@pytest.mark.parametrize("n", [2, 4])
def test_bundles_equal_the_jax_packages_gathers(step, jax_step, n):
    """The bundles the shards assemble (the four hops, hop 4 through its
    one entry) are the JAX package's arrays gathered at its plain engine's
    step: the source ids of its proposals, their replica rows, their
    partitions' member ids and rack cells, the members' brokers and rows."""
    eng, carry, _plan, _g, keys, _temp, _full = step
    je, jc, jp, jprop = jax_step
    cp, s = eng.cand, eng.shape
    assert (cp.K_r, cp.K_s, cp.K_l) == (je.K_r, je.K_s, je.K_l)
    tplan = SamplingPlan(**{f.name: torch.from_numpy(np.asarray(getattr(jp, f.name)).copy())
                            for f in dataclasses.fields(SamplingPlan)})
    em = _Emulation(eng, carry, tplan, n)
    ids, rows, parts = _hop3(eng, carry, keys, em)
    max_rf, n_rs = eng.max_rf, cp.K_r + 2 * cp.K_s
    mrows = em.hop(lambda j, sx, c: ms_k.own_member_rows(parts, n_rs, max_rf,
                                                         ms_k.row_columns(sx.state, c), em.blks[j]))
    jst = je.statics.state
    cols = {f: np.asarray(getattr(jc if f in ("broker", "lead", "disk") else jst, a))
            for f, a in (("broker", "replica_broker"), ("part", "replica_partition"),
                         ("disk", "replica_disk"), ("topic", "replica_topic"),
                         ("valid", "replica_valid"), ("lead", "replica_is_leader"),
                         ("pos", "replica_pos"), ("orig_broker", "replica_broker"),
                         ("orig_lead", "replica_is_leader"), ("orig_disk", "replica_disk"),
                         ("load_leader", "replica_load_leader"),
                         ("load_follower", "replica_load_follower"))}
    want_ids = np.concatenate([np.asarray(jprop["payr"]["r"]), np.asarray(jprop["payl"]["rt"])])
    np.testing.assert_array_equal(ids.numpy(), want_ids.astype(np.int32))
    want_rows = _gather_rows(cols, want_ids, s.R)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    part = want_rows[:, 1]
    members = np.asarray(je.statics.part_replicas)[part]
    want_parts = np.concatenate([members, np.asarray(jc.part_rack_count)[part]], 1)
    np.testing.assert_array_equal(parts.numpy(), want_parts.astype(np.int32))
    want_mb = _gather_rows(cols, members[:n_rs], s.R)[:, 0]
    want_ml = _gather_rows(cols, members[n_rs:], s.R)
    np.testing.assert_array_equal(mrows.numpy(), np.concatenate([want_mb, want_ml.reshape(-1)]))


@pytest.mark.parametrize("gather", ["shard_sources", "own_rows", "own_member_rows", "own_parts"])
def test_gathers_raise_for_a_tensor_off_the_cpu(step, gather):
    """A gather handed a tensor that does not lie on the CPU (a "meta"
    tensor stands in for a CUDA one on this host) launches its kernel or
    raises: it never answers with its plain version."""
    eng, carry, plan, _g, keys, _temp, _full = step
    em = _Emulation(eng, carry, plan, 2)
    ids, rows, parts = _hop3(eng, carry, keys, em)
    sx, c = em.views[0]
    blk, cols = em.blks[0], ms_k.row_columns(sx.state, c)
    meta = torch.device("meta")
    calls = dict(
        shard_sources=lambda: ms_k.shard_sources(eng.cand, keys, dataclasses.replace(
            em.plans[0], count=em.plans[0].count.to(meta)), sx.gen, blk, True),
        own_rows=lambda: ms_k.own_rows(ids.to(meta), ms_k.ROW_WORDS, cols, blk),
        own_member_rows=lambda: ms_k.own_member_rows(parts.to(meta), eng.cand.K_r, eng.max_rf,
                                                     cols, blk),
        own_parts=lambda: ms_k.own_parts(rows.view(-1)[1:].to(meta), int(ids.shape[0]),
                                         ms_k.ROW_WORDS, sx.part_replicas, c.part_rack_count, blk),
    )
    with pytest.raises(ValueError, match="CUDA or all on the CPU"):
        calls[gather]()
