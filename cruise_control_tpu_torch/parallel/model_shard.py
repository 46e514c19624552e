"""Model-axis sharding: the flattened cluster model split over a model row.

`ModelShardEngine` is the rank engine's second twin (beside the replicated
`RankEngine` of parallel/mesh.py, which shards the CANDIDATE axis and
replicates the model), the port of the JAX package's
parallel/model_shard.py `_ModelShardEngine`.  Here the model itself is a
data axis: every replica-indexed tensor (placements, loads, id columns)
and every partition-indexed one (the member table, the partition x rack
cells) holds one contiguous block of rows on each rank of a model row, so
a card holds ~1/n of the O(R) and O(P) state.  Broker, host and topic
aggregates and the scalars stay replicated: they are O(B).

Layout: the padded global shape has R and P rounded up to multiples of n
(`shard_multiple_shape`); shard j owns the global rows [j Rl, (j + 1) Rl)
and [j Pl, (j + 1) Pl) (`kernels.model_shard.Block`).  Values keep global
ids, so a shard's replica_partition row holds a global partition id and
its member table global replica ids.

A step (`_step`): the draws come from the replicated key, as the plain
engine's do; each row the candidates need is resolved by ownership in
four hops (kernels/model_shard.py: source ids, their rows, their
partitions' rows, the members' rows), each one launch of an own-or-zero
gather kernel and one all_reduce over the row's process group; then the
candidates kernel's body reads the assembled bundles (csrc/candidates.cu
SHARD), `select_survivors` runs replicated over the K columns (global
partition ids), and `apply_moves` writes this shard's rows only (its row
offsets) while every shard's broker, host and topic aggregates take every
survivor.  A round (`refresh`): the aggregates of the local rows, whose
broker, topic and disk sums are summed over the row (the float ones
gathered and folded in rank order, common/collectives.py); the partition
x rack cells of the local rows counted into all P rows (`shard_prc`) and
reduce-scattered to each shard's own; `group_by_broker` over the local rows,
unchanged; the sampling plan's global counts by one all_reduce and
`below` from an all_gather (`ShardPlan`).  The objective and the goal
chain reduce their replica and partition rows over the model axis
(`model_axis_scope`, common/collectives.py).

Parity: the bundles are the plain engine's gathers bit for bit (one owner
a word), and the acceptance consumes the same inputs, so the placements
are the replicated mesh's and the plain engine's wherever the summed
float partials are exact, which integer-quantized loads make them
(tests/test_torch_model_shard.py).  On float loads the broker sums add in
another order than one device's, so the bar against the plain engine is
goal quality.  But every float sum over the row is a left fold of the
ranks' partials in rank order (`all_reduce_sum`), and every replicated
float computation a rank runs adds in a fixed order (the plan's broker CDF
too: analyzer/engine.py `scan_fixed_order`), so every rank holds the same
replicated aggregates after every round and a run is a function of
(state, seed, config, mesh width) alone: a repeated run, a fresh engine
and a fresh process give the same placements and objective, bit for bit
(tests/test_torch_model_shard_determinism.py, chip_smoke.py `--mesh`).

The port's `group_by_broker` is a counting sort (kernels/group.py), so the
JAX package's `stable_grouped_order` (a guard against an XLA:CPU
miscompile of variadic sorts) has no port.  The mode runs its rounds op
by op on the card (no captured graph: its four all_reduces a step are
issued from the host), and has no segmented variant, as in the JAX
package: a mesh failure restarts it at the reduced width.  Its ranks run
no reports: the mesh engine computes them on the caller
(parallel/mesh.py).  On the card its step runs the default kinds (no
intra-broker moves, no learned prior); the plain version runs every kind.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from cruise_control_tpu_torch.analyzer.engine import LOAD_FIELDS, build_statics
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS
from cruise_control_tpu_torch.common import collectives
from cruise_control_tpu_torch.common.collectives import all_gather_rows, all_reduce_sum, model_axis_scope
from cruise_control_tpu_torch.common.dispatch import count_dispatch
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.kernels import model_shard as ms_k
from cruise_control_tpu_torch.kernels import schedule as sched_k
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.kernels.apply import apply_moves
from cruise_control_tpu_torch.kernels.group import group_placement
from cruise_control_tpu_torch.kernels.refresh import HostGroups, refresh_aggregates
from cruise_control_tpu_torch.models.sharding import match_partition_rules, statics_partition_rules
from cruise_control_tpu_torch.models.state import STATE_FIELDS, ClusterState
from cruise_control_tpu_torch.parallel.mesh import MODEL_AXIS, RankEngine

__all__ = ["ModelShardEngine", "ShardPlan", "local_shape", "psum_bytes_per_round",
           "psum_bytes_per_step", "refresh_sum_words"]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The sampling plan of a model shard (the JAX package's ShardPlan,
    model_shard.py:136): the broker CDF and the movement prices are the
    plain plan's (replicated); the grouped index is local (`order`,
    `start`, `count_local` over this shard's rows), beside the global
    per-broker counts (`count`, one all_reduce: the slot draw j ~ U[0,
    count) must see the global group) and `below`, a broker's replicas on
    lower shards (from an all_gather): the global grouped order is the
    shards' local groups in shard order, so group position j lives on the
    shard where below[b] <= j < below[b] + count_local[b].  `start_global`
    is the global group offsets (the plain version's view of the order)."""

    broker_cdf: torch.Tensor
    order: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    count_local: torch.Tensor
    below: torch.Tensor
    start_global: torch.Tensor
    replica_cost: torch.Tensor
    lead_cost: torch.Tensor


def local_shape(shape, n: int):
    """The shape of one shard's blocks: R and P over n, the rest global."""
    return dataclasses.replace(shape, num_replicas=shape.R // n, num_partitions=shape.P // n)


def _model_rows(paths) -> set:
    """The statics' field paths the rule tables split over the model axis
    (models/sharding.py `statics_partition_rules`)."""
    rules = match_partition_rules(statics_partition_rules(MODEL_AXIS), paths)
    return {p for p, layout in rules.items() if layout == (MODEL_AXIS,)}


#: the state's fields a shard holds a block of (the replica rows)
_STATE_ROWS = _model_rows([f"state/{f}" for f in STATE_FIELDS])


def local_state(state: ClusterState, blk: ms_k.Block, device) -> ClusterState:
    """Shard `blk`'s rows of `state` (the fields the rule tables split;
    global ids kept), its broker and disk fields whole, on `device`."""
    r0, r1 = blk.r_off, blk.r_off + blk.r_local
    fields = {f: (getattr(state, f)[r0:r1] if f"state/{f}" in _STATE_ROWS else getattr(state, f))
              .to(device).contiguous() for f in STATE_FIELDS}
    return ClusterState(**fields, shape=local_shape(state.shape, blk.n))


def psum_bytes_per_step(K_r: int, K_s: int, K_l: int, max_rf: int, racks: int) -> int:
    """Bytes each rank all-reduces in one step: the four hops' bundles
    (i32 words): the source ids, their rows, their partitions' rows
    (members and every rack's cell), the members' brokers and the
    leadership members' rows."""
    n = K_r + 2 * K_s + K_l
    w = ms_k.ROW_WORDS
    return 4 * (n + n * w + n * (max_rf + racks) + (K_r + 2 * K_s) * max_rf + K_l * max_rf * w)


def refresh_sum_words(shape) -> tuple[int, int, int]:
    """The words a rank puts into a round's refresh sums: the float broker
    and disk sums (one all_gather, folded in rank order: a rank receives n
    times these), the integer counts (one all_reduce) and the partition x
    rack cells (one reduce_scatter)."""
    B, T, D = shape.B, shape.num_topics, shape.max_disks_per_broker
    return B * 6 + B * D, 2 * B + T * B, shape.P * shape.num_racks


#: the words of the plan's sums beyond its counts: its carry objective's
#: rack-excess and offline counts (an int64 all_reduce each)
PLAN_OBJECTIVE_WORDS = 4


def psum_bytes_per_round(shape, config, split, max_rf: int) -> int:
    """The bytes a rank puts into a round's collectives (the inputs,
    `collectives.COUNTS`' measure): `psum_bytes_per_step` times the steps,
    plus the refresh (`refresh_sum_words`), the plan's counts (all_reduce
    and all_gather) and its carry objective's sums, and a flat 64 words
    for the goal chain's scalar sums (a full check or an objective, when
    the schedule asks for one)."""
    refresh = sum(refresh_sum_words(shape))
    plan = shape.B + shape.B + PLAN_OBJECTIVE_WORDS
    return (psum_bytes_per_step(*split, max_rf, shape.num_racks) * config.steps_per_round
            + 4 * (refresh + plan + 64))


class ModelShardEngine(RankEngine):
    """A rank of a model row in the sharded-model mode (module note).

    `state` is the GLOBAL padded state (the mesh engine's, in shared
    memory on the host); the engine keeps shard j's blocks of it on
    `device` (`shard` = (j, n)), and `group` is the row's process group,
    which every hop's all_reduce runs over."""

    def __init__(self, state: ClusterState, chain, constraint, options, config, *, key,
                 shard: tuple[int, int], group, device):
        self.gshape = state.shape
        self.blk = ms_k.Block.of(state.shape.R, state.shape.P, int(shard[0]), int(shard[1]))
        self._global = state
        self._bufs_shard: dict | None = None
        #: CUDA events around each refresh's float sum of the current run
        self._sum_events: list = []
        super().__init__(local_state(state, self.blk, device), chain, constraint, options, config,
                         key=key, shard=shard, group=group)
        # the preferred-leader term's denominator is the global partition count
        self.cand = dataclasses.replace(self.cand, num_parts=max(1, self.gshape.P))
        self.loop_route = "eager"

    # -- the shard's statics ---------------------------------------------------

    def rebind(self, state: ClusterState, options=DEFAULT_OPTIONS, prior=None):
        """Bind a new global generation (the plain engine's `rebind`): its
        statics built from the global state (the generation block's counts
        and the member table are global), then cut to this shard's blocks
        on the device.  Engine.__init__ passes the shard's own state: its
        global one is the state the engine was built with."""
        g = state if state.shape == self.gshape else self._global
        self._wait_warm()
        layout: dict = {}
        sg = build_statics(g, options, prior=prior, prior_full_shape=self.config.prior_enabled,
                           layout_out=layout, cap_weights=self.w.cap)
        loc = local_state(g, self.blk, self.device)
        blk, dev = self.blk, self.device
        rows = _model_rows([f.name for f in dataclasses.fields(sg) if f.name != "state"])
        if rows != {"part_replicas"}:
            raise ValueError(f"the sharded-model mode cuts the member table's rows only, the "
                             f"rules name {sorted(rows)}")
        members = sg.part_replicas[blk.p_off: blk.p_off + blk.p_local].contiguous().to(dev)
        moved = {}
        for f in dataclasses.fields(sg):
            v = getattr(sg, f.name)
            if f.name == "state":
                v = loc
            elif f.name == "part_replicas":
                v = members
            elif f.name == "gen":
                v = dataclasses.replace(v, words=v.words.to(dev))
            elif f.name == "host_groups":
                v = HostGroups.of(loc.broker_valid, loc.broker_host, loc.shape.num_hosts)
            elif isinstance(v, torch.Tensor):
                v = v.to(dev)
            moved[f.name] = v
        vars(loc)["members"] = members  # the cached_property's slot
        statics = dataclasses.replace(sg, **moved)
        if self.statics is not None and statics.part_replicas.shape != self.statics.part_replicas.shape:
            self.release()
        self._global = g
        self._uses += 1
        self._bound_args = (g, options, prior)
        self._dest_idx = layout["dest_idx"]
        self._state = loc
        self.statics = statics
        # the refresh's view of the rows: its partition x rack pass writes a
        # scratch (a padding member table on the card, partition 0 on the
        # CPU); the cells come from `shard_prc`
        self._refresh_view = dataclasses.replace(
            loc, replica_partition=torch.zeros_like(loc.replica_partition))
        self._pad_members = torch.full((blk.p_local, 1), -1, dtype=torch.int32, device=dev)
        return self

    def _warm_up(self) -> None:
        # nothing is captured in this mode
        self._workspace()

    def _shard_bufs(self) -> dict:
        """The mode's fixed buffers: the step's bundles, the plan's counts,
        the refresh's scratch and packed sums."""
        if self._bufs_shard is not None:
            return self._bufs_shard
        dev, i32 = self.device, torch.int32
        K_r, K_s, K_l = self.K_r, self.K_s, self.K_l
        max_rf, racks = self.max_rf, self.shape.num_racks
        n = K_r + 2 * K_s + K_l
        n_rs = K_r + 2 * K_s
        w = ms_k.ROW_WORDS
        mrows = torch.zeros(n_rs * max_rf + K_l * max_rf * w, dtype=i32, device=dev)
        B = self.shape.B
        self._bufs_shard = dict(
            ids=torch.zeros(n, dtype=i32, device=dev),
            rows=torch.zeros((n, w), dtype=i32, device=dev),
            parts=torch.zeros((n, max_rf + racks), dtype=i32, device=dev),
            mrows=mrows,
            mb=mrows[: n_rs * max_rf].view(n_rs * max_rf, 1),
            ml=mrows[n_rs * max_rf:].view(K_l * max_rf, w),
            count_g=torch.zeros(B, dtype=i32, device=dev),
            counts=torch.zeros(self.blk.n * B, dtype=i32, device=dev),
            below=torch.zeros(B, dtype=i32, device=dev),
            start_g=torch.zeros(B, dtype=i32, device=dev),
            prc_full=torch.zeros((self.gshape.P, racks), dtype=i32, device=dev),
            prc_scratch=torch.zeros((self.blk.p_local, racks), dtype=i32, device=dev),
        )
        return self._bufs_shard

    def _workspace(self):
        fresh = self._ws is None
        ws = super()._workspace()
        if fresh and ws.sel is not None:
            # select_survivors' per-partition minima take global partition ids
            cfg = self.config
            ws.sel = select_k.select_buffers(
                self.K_r + self.K_s + self.K_l, self.K_r, self.K_s, self.shape.B, self.gshape.P,
                self.device, n_epochs=self._n_rounds() * cfg.steps_per_round)
        return ws

    # -- a round ---------------------------------------------------------------

    def refresh(self, carry, group=None):
        """Every aggregate of the carry (the plain engine's refresh over
        this shard's rows): broker, topic and disk partial sums summed over
        the row (`all_reduce_sum`: the float ones folded in rank order),
        partition x rack cells from every shard's rows reduce-scattered to
        this shard's, host load from the global broker load."""
        b = self._shard_bufs()
        st = self.statics.state
        B = self.shape.B
        row = self._row
        group = group_placement(carry.replica_broker, st.replica_valid, B, out=group)
        out = carry.aggregates()
        partial = {k: v for k, v in out.items() if k != "host_load"}
        partial["part_rack_count"] = b["prc_scratch"]
        refresh_aggregates(self._refresh_view, carry.replica_broker, carry.replica_is_leader,
                           carry.replica_disk, partial, group=group, members=self._pad_members)
        floats = ("broker_load", "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load")
        ints = ("broker_replica_count", "broker_leader_count", "broker_topic_count")
        for names in (floats, ints):
            packed = torch.cat([out[k].reshape(-1) for k in names])
            timed = names is floats and self.device.type == "cuda"
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            all_reduce_sum(packed, row)
            if timed:
                ev[1].record()
                self._sum_events.append(ev)
            at = 0
            for k in names:
                n = out[k].numel()
                out[k].view(-1).copy_(packed[at: at + n])
                at += n
        ms_k.shard_prc(st, carry.replica_broker, self.gshape.P, out=b["prc_full"])
        with model_axis_scope(row):
            carry.part_rack_count.copy_(collectives.gscatter_rows(b["prc_full"]))
        refresh_aggregates(st, carry.replica_broker, carry.replica_is_leader, carry.replica_disk,
                           dict(broker_load=out["broker_load"], host_load=out["host_load"]),
                           hosts=self.statics.host_groups, brokers=False)
        return carry

    def plan(self, carry, g=None, out=None):
        """The plain plan over the replicated aggregates, then the shard
        plan's global counts (all_reduce), `below` (all_gather) and the
        global group offsets."""
        out = super().plan(carry, g, out)
        b = self._shard_bufs()
        b["count_g"].copy_(out.count)
        all_reduce_sum(b["count_g"], self._row)
        all_gather_rows(b["counts"], out.count.contiguous(), self._row)
        per = b["counts"].view(self.blk.n, -1)
        b["below"].copy_(per[: self.blk.j].sum(0).to(torch.int32))
        b["start_g"].copy_((torch.cumsum(b["count_g"], 0) - b["count_g"]).to(torch.int32))
        return out

    def shard_plan(self, plan) -> ShardPlan:
        b = self._shard_bufs()
        return ShardPlan(broker_cdf=plan.broker_cdf, order=plan.order, start=plan.start,
                         count=b["count_g"], count_local=plan.count, below=b["below"],
                         start_global=b["start_g"], replica_cost=plan.replica_cost,
                         lead_cost=plan.lead_cost)

    def carry_objective(self, carry, g=None):
        with model_axis_scope(self._row):
            return super().carry_objective(carry, g)

    def evaluate(self, carry):
        with model_axis_scope(self._row):
            return super().evaluate(carry)

    # -- a step ----------------------------------------------------------------

    def gather_bundles(self, carry, keys, sp: ShardPlan) -> cand_k.ShardBundles:
        """The step's four hops: own-or-zero gathers, each assembled by one
        all_reduce over the row (kernels/model_shard.py)."""
        b = self._shard_bufs()
        st, blk, row = self.statics.state, self.blk, self._row
        cols = ms_k.row_columns(st, carry)
        max_rf = self.max_rf
        n_rs = self.K_r + 2 * self.K_s
        ms_k.shard_sources(self.cand, keys, sp, self.statics.gen, blk, True, out=b["ids"])
        all_reduce_sum(b["ids"], row)
        ms_k.own_rows(b["ids"], ms_k.ROW_WORDS, cols, blk, out=b["rows"])
        all_reduce_sum(b["rows"], row)
        ms_k.own_parts(b["rows"].view(-1)[1:], int(b["ids"].shape[0]), ms_k.ROW_WORDS,
                       self.statics.part_replicas, carry.part_rack_count, blk, out=b["parts"])
        all_reduce_sum(b["parts"], row)
        ms_k.own_member_rows(b["parts"], n_rs, max_rf, cols, blk, out=b["mrows"])
        all_reduce_sum(b["mrows"], row)
        return cand_k.ShardBundles(ids=b["ids"], rows=b["rows"], parts=b["parts"], mb=b["mb"],
                                   ml=b["ml"], shape=self.gshape, row_words=ms_k.ROW_WORDS)

    def shard_candidates(self, carry, keys, g, sp: ShardPlan, temperature, bufs=None) -> dict:
        """One step's candidate bundle: the hops, then the body."""
        sh = self.gather_bundles(carry, keys, sp)
        return cand_k.candidates_shard(self.cand, self.statics, carry, keys, g, sp, temperature, sh,
                                       bufs=bufs)

    def _step(self, ws, i: int) -> None:
        carry = ws.carry
        rnd, spr = ws.sched.si[sched_k.RND: sched_k.RND + 1], self.config.steps_per_round
        cursor = cand_k.KeyCursor(ws.keys, rnd, i, spr, ws.prior_keys)
        prop = self.shard_candidates(carry, cursor, self._globals(carry, ws.gbuf),
                                     self.shard_plan(ws.plan), ws.sched.value(sched_k.T_R),
                                     bufs=ws.cand)
        self._survive_apply(carry, prop, ws, select_k.Epoch(i, rnd, spr))

    def _survive_apply(self, carry, prop: dict, ws=None, epoch: select_k.Epoch = select_k.Epoch()):
        nr, ns = prop["nr"], prop["ns"]
        survive, sv_r, acc = select_k.select_survivors(
            prop["accept"], prop["delta"], prop["src"], prop["dst"], prop["part1"], prop["part2"],
            num_brokers=self.shape.B, num_parts=self.gshape.P, n_r=nr, n_s=ns,
            acc=ws.sched.acc if ws else None, bufs=ws.sel if ws else None, epoch=epoch,
            from_prior=prop.get("from_prior"), diag=bool(ws and ws.sched.stage is not None),
        )
        apply_moves(self.statics, carry, sv_r, prop["payr"], survive[nr + ns:], prop["payl"],
                    r_off=self.blk.r_off, p_off=self.blk.p_off)
        return survive, acc

    def step(self, carry, temperature, plan=None):
        raise NotImplementedError("the sharded-model mode runs the fused schedule only "
                                  "(no explicit-schedule step)")

    # -- a run -----------------------------------------------------------------

    def _run_fused(self, *, verbose: bool = False, initial_placement=None, reports: bool = False,
                   cycle=None):
        """The fused schedule op by op over this shard's rows (`_loop_eager`,
        the CPU route's loop, on the card too): returns (final state of
        this shard's rows, history, None)."""
        if reports or cycle is not None or initial_placement is not None:
            raise ValueError("a sharded-model rank runs no reports, cycles or warm starts")
        t_start = time.monotonic()
        ws = self._workspace()
        self._uses += 1
        dims = self._sched_dims(verbose)
        count_dispatch("engine.init")
        self._sum_events = []
        self._stage(ws, None)
        self._init_run(ws, dims)
        count_dispatch("engine.run")
        rounds = self._loop_eager(ws, dims, False)
        t_disp = time.monotonic()
        count_dispatch("engine.sync")
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        ys = ws.sched.ys.cpu().numpy().copy()
        count = ws.sched.count.cpu().numpy().copy()
        t_sync = time.monotonic()
        self.last_ys = ys
        self.last_syncs = 3 * rounds + 1
        history = self._fused_history(ys, verbose=verbose)
        timing = dict(
            timing=True, fused=True, blocking_syncs=self.last_syncs, graph_launches=0,
            report_graph_launches=0, captured=[], loop_iterations=int(count[sched_k.ITERS]),
            masked_rounds=int(count[sched_k.MASKED]), host_dispatch_s=round(t_disp - t_start, 6),
            device_s=round(t_sync - t_disp, 6),
        )
        if self._sum_events:
            # the refreshes' float sums (gather and fold), device ms each
            timing["float_sum_ms"] = [a.elapsed_time(b) for a, b in self._sum_events]
        conv = self._convergence_summary(ys)
        if conv is not None:
            timing["convergence"] = conv
        history.append(timing)
        return self._final_state(ws), history, None



def loads_quantized(state: ClusterState, scale: float = 8.0) -> ClusterState:
    """`state` with its loads scaled by `scale` and rounded to integers, so
    that every partial sum of them is exact in f32 (below 2^24) and the
    all-reduced aggregates of the sharded-model mode are bit for bit the
    plain engine's (the JAX package's tests/test_model_shard.py:33
    quantizes the same way)."""
    return dataclasses.replace(state, **{f: torch.round(getattr(state, f) * scale)
                                         for f in LOAD_FIELDS})


def shard_views(statics, carry, blk: ms_k.Block):
    """Shard `blk`'s (statics, carry) as views of a whole model's: its
    replica and partition rows, the broker-level tensors shared.  The
    one-card emulation of the mode (chip_smoke.py phase 30, the tests)
    runs each shard's kernels on these."""
    st = statics.state
    r0, r1 = blk.r_off, blk.r_off + blk.r_local
    p0, p1 = blk.p_off, blk.p_off + blk.p_local
    loc = ClusterState(**{f: (getattr(st, f)[r0:r1] if f.startswith("replica_") else getattr(st, f))
                          for f in STATE_FIELDS}, shape=local_shape(st.shape, blk.n))
    vars(loc)["members"] = statics.part_replicas[p0:p1]
    statics_j = dataclasses.replace(statics, state=loc, part_replicas=statics.part_replicas[p0:p1])
    carry_j = dataclasses.replace(
        carry, replica_broker=carry.replica_broker[r0:r1],
        replica_is_leader=carry.replica_is_leader[r0:r1], replica_disk=carry.replica_disk[r0:r1],
        part_rack_count=carry.part_rack_count[p0:p1])
    return statics_j, carry_j
