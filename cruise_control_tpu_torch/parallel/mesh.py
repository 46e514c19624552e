"""Mesh engine layer: ONE rank-group engine under sharded, grid and portfolio.

Every multi-device mode is a view of the same run over a 2D (restart, model)
layout of devices (parallel/ranks.py `Layout`), one rank process a device:

  * the MODEL axis shards the CANDIDATE axis of the anneal.  Each step every
    rank of a model row draws from the replicated key as the full-K step
    would, scores and accepts only its ceil(K/M) lanes of each kind (the
    candidates kernel's lane slice, kernels/candidates.py `Lanes`), packs
    the slice's bundle and payload into one buffer, and ONE all_gather over
    the row's sub-group brings back every rank's slice.  An unpack (one
    index_select over the gathered bytes) lays the full-K bundle out as
    select_survivors and apply_moves read it, and the rest of the step runs
    replicated.  Acceptance stays inside the kernel (per lane, from keys
    indexed by the global lane), so the port gathers candidates that are
    already accepted where the JAX package gathers raw columns before its
    `_accept_select_apply` (engine.py:2669); the gathered bytes count the
    accept column beside the others.
  * the RESTART axis runs independent chains: chain 0 of a one-chain layout
    uses the plain engine's PRNGKey(seed), a portfolio chain r the key
    split(PRNGKey(seed), R)[r] (the JAX package's mesh.py:608-612).  The
    caller picks the winner, argmin of the chains' carry objectives, which
    ride the run's one answer a rank.

  sharded  = (1, n)   grid:RxM = (R, M)   portfolio = (n, 1)

The model and the carry are replicated on every rank of a row, and every
rank applies the same survivors to the same carry, so the carries stay bit
for bit equal (`MeshEngine.carry_digests` shows it) and a 1-rank and an
n-rank run of the same seeded anneal give the same placements as the plain
engine.  At M=1 there is no slice and no collective: a rank's step is the
plain engine's.  The whole schedule is the plain engine's fused route
(analyzer/engine.py: on the card one launch of the loop graph, captured
once per engine), with the sliced step in the round body.  Where the card
refuses a loop graph whose body holds NCCL's captured collective, a rank
runs its rounds as a host loop over the same captured graphs
(`RankEngine._run_host_loop`, three syncs a round).

The caller's `MeshEngine` holds no engine of its own: its ranks do, one
`RankEngine` each, built, rebound, run and released by commands over the
layout's rank group (`rank_group`, shared by every engine on one device
set).  The state crosses in shared memory once a rebind; each chain's
result placement comes back in shared tensors; the ys, the objective and
the reports ride the answers.

The sharded-MODEL mode (`model_shard_min_partitions` > 0 and the real
partition count at or above it, on a model axis over 1) splits the model
itself over the model row instead: each rank holds one block of the
replica and partition rows and resolves the rows a step needs by
ownership gathers (parallel/model_shard.py `ModelShardEngine`).  Its
ranks run no reports; the caller computes them from the result
(`_caller_reports`), as it does for a segmented run.

Segmented runs (the device scheduler's preemptible grant, an ambient
SegmentContext, or `resume=` a checkpoint: mesh fault tolerance,
analyzer/optimizer.py `_optimize_mesh_ft`): the caller drives the slice
boundaries over the pipes (`_run_segmented`): each rank runs rounds up to
the slice's end as a host loop over its captured graphs (op by op on the
CPU), the plain engine's `_run_segmented` pieces, and between slices the
caller runs the scheduler's checkpoint and offers a snapshot.  A
checkpoint (`checkpoint_capture`) is the host copy of one rank a chain
(the carries of a model row are bit for bit equal), so it restores at any
model width with the same chain count (`_restore_checkpoint`); the ranks
copy it into their own tensors, never the other way.  The sharded-model
mode has no segmented variant, as in the JAX package.

Reference analog: none -- the reference optimizer is a single-threaded
Java loop (analyzer/goals/AbstractGoal.java:66-107).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import logging
import threading
import time

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.engine import (
    SEGMENT_MAX_ROUNDS,
    CarryCheckpoint,
    Engine,
    OptimizerConfig,
    SegmentContext,
    _placed_state,
    current_segment_context,
    warm_pool_submit,
)
from cruise_control_tpu_torch.analyzer.objective import GoalChain
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS, OptimizationOptions
from cruise_control_tpu_torch.common import collectives
from cruise_control_tpu_torch.common.blackbox import RECORDER as _BLACKBOX
from cruise_control_tpu_torch.common.device_watchdog import device_op
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.common.dispatch import count_dispatch
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.kernels import _build
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.kernels import schedule as sched_k
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
from cruise_control_tpu_torch.models.state import STATE_FIELDS, ClusterState
from cruise_control_tpu_torch.parallel.ranks import (
    MODEL_AXIS,
    RESTART_AXIS,
    Layout,
    default_mesh,
    grid_mesh,
    model_mesh,
    normalize_mesh,
    rank_group,
)

log = logging.getLogger(__name__)

__all__ = [
    "MODEL_AXIS", "RESTART_AXIS", "MeshEngine", "RankEngine", "RankServer", "default_mesh",
    "grid_mesh", "model_mesh", "normalize_mesh",
]

#: the step's result placement fields a chain writes into its shared slot
SLOT_FIELDS = ("replica_broker", "replica_is_leader", "replica_disk", "replica_offline",
               "replica_disk_bytes")
#: the ys columns that count (summed over chains in a mesh history)
_COUNT_YS = ("accepted", "acc_replica", "acc_swap", "acc_lead", "prior_cands", "prior_acc")


def kind_split(config: OptimizerConfig) -> tuple[int, int, int]:
    """(K_r, K_s, K_l): the engine's candidate split of `config`."""
    if config.intra_broker:
        return config.num_candidates, 0, 0
    k_l = min(config.leadership_candidates, config.num_candidates - 1)
    k_s = min(config.swap_candidates, max(0, (config.num_candidates - k_l) // 2))
    return config.num_candidates - k_l - k_s, k_s, k_l


# ----------------------------------------------------------------------
# the packed step: one buffer a rank, one all_gather, one unpack
# ----------------------------------------------------------------------


_ALIGN = 16


@dataclasses.dataclass(frozen=True)
class Packing:
    """Where each field of a launch's outputs lives in one byte buffer:
    {(group, field): (offset, shape, dtype)} and the buffer's size, each
    field 16-byte aligned (rows of four floats load whole)."""

    fields: dict
    nbytes: int

    @staticmethod
    def of(prior: bool, lanes: cand_k.Lanes) -> "Packing":
        spec = cand_k.buffer_layout(prior, lanes)
        fields, at = {}, 0
        for grp, group in spec.items():
            for name, (shape, dtype) in group.items():
                fields[(grp, name)] = (at, shape, dtype)
                n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
                at += -(-n // _ALIGN) * _ALIGN
        return Packing(fields, max(at, _ALIGN))

    def views(self, buf: torch.Tensor) -> dict:
        """{group: {field: typed view of buf}} (candidate_buffers' layout)."""
        out: dict = {}
        for (grp, name), (at, shape, dtype) in self.fields.items():
            size = torch.empty((), dtype=dtype).element_size()
            n = int(np.prod(shape, dtype=np.int64))
            out.setdefault(grp, {})[name] = buf[at: at + n * size].view(dtype).view(shape)
        return out


def unpack_index(split: tuple[int, int, int], prior: bool, n: int) -> np.ndarray:
    """int64 index of the full-K packed buffer's bytes into the n-rank
    gathered buffer (rank j's slice packing at j * slice bytes): the
    relocation, swap and leadership lanes of each field back in full-K
    order, the lanes past K dropped.  Bytes of the alignment padding read
    byte 0."""
    k_r, k_s, k_l = split
    full = cand_k.Lanes(0, k_r, 0, k_s, 0, k_l)
    sl = cand_k.Lanes.split(split, 0, n)
    pf, ps = Packing.of(prior, full), Packing.of(prior, sl)
    s_r, s_s, s_l = sl.n_r, sl.n_s, sl.n_l
    # per group: (K of the segment, lanes a rank, local offset, full offset)
    segs = {
        "out": ((k_r, s_r, 0, 0), (k_s, s_s, s_r, k_r), (k_l, s_l, s_r + s_s, k_r + k_s)),
        "payr": ((k_r, s_r, 0, 0), (k_s, s_s, s_r, k_r), (k_s, s_s, s_r + s_s, k_r + k_s)),
        "payl": ((k_l, s_l, 0, 0),),
    }
    idx = np.zeros(pf.nbytes, np.int64)
    for (grp, name), (at_f, shape, dtype) in pf.fields.items():
        at_s = ps.fields[(grp, name)][0]
        eb = torch.empty((), dtype=dtype).element_size() * int(np.prod(shape[1:], dtype=np.int64))
        parts = segs[grp] if name != "from_prior" else segs["out"][:1]
        for k, s, loc, off in parts:
            if k == 0:
                continue
            p = np.arange(k, dtype=np.int64)
            src = (p // s) * ps.nbytes + at_s + (loc + p % s) * eb
            dst = at_f + (off + p) * eb
            b = np.arange(eb, dtype=np.int64)
            idx[(dst[:, None] + b).ravel()] = (src[:, None] + b).ravel()
    return idx


def packed_bytes_per_step(config: OptimizerConfig, n: int) -> int:
    """Bytes of packed candidate columns each rank of an n-wide model row
    holds after a step's all_gather (n slices of the rank packing); 0 at
    n=1, where a step gathers nothing."""
    if n <= 1:
        return 0
    split = kind_split(config)
    prior = config.prior_enabled and not config.intra_broker
    return n * Packing.of(prior, cand_k.Lanes.split(split, 0, n)).nbytes


#: the gather calls this process made (a rank's own count; read per run)
GATHER_CALLS = [0]


def all_gather_tiled(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """out = the ranks' `inp` concatenated in rank order over `group`: the
    one helper every gather goes through (torch names it
    `all_gather_single` from 2.13 on, `all_gather_into_tensor` before)."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)
    GATHER_CALLS[0] += 1


class _StepBuffers:
    """A rank's fixed buffers of the sliced step: its packed slice (which
    the candidates kernel writes, typed views `local`), the gathered row
    and the full-K packing (`full`, the bundle select_survivors and
    apply_moves read), and the unpack index."""

    def __init__(self, split, prior: bool, j: int, n: int, device):
        self.lanes = cand_k.Lanes.split(split, j, n)
        p_loc = Packing.of(prior, self.lanes)
        p_full = Packing.of(prior, cand_k.Lanes(0, split[0], 0, split[1], 0, split[2]))
        u8 = torch.uint8
        self.send = torch.zeros(p_loc.nbytes, dtype=u8, device=device)
        self.recv = torch.zeros(n * p_loc.nbytes, dtype=u8, device=device)
        self.packed = torch.zeros(p_full.nbytes, dtype=u8, device=device)
        self.index = torch.from_numpy(unpack_index(split, prior, n)).to(device)
        self.local = p_loc.views(self.send)
        self.full = p_full.views(self.packed)


# ----------------------------------------------------------------------
# the rank side
# ----------------------------------------------------------------------


class RankEngine(Engine):
    """The plain engine of one rank of a mesh run: its chain's key
    (`_run_key`) and, on a model axis wider than 1, a step that runs this
    rank's candidate slice, gathers the row's slices and applies the
    full-K survivors (`_step`).  Everything else (the fused route, its
    captured graphs, the reports) is the plain engine's."""

    def __init__(self, state, chain, constraint, options, config, *, key: Key,
                 shard: tuple[int, int], group=None):
        self._chain_key = key
        self._shard = (int(shard[0]), int(shard[1]))
        self._row = group
        self._bufs: _StepBuffers | None = None
        self._bufs_ws = None
        #: "graph" (the loop graph) or "host" (a host loop over the captured
        #: graphs, where the card refused the loop graph with the gather in it)
        self.loop_route = "graph"
        self.loop_error: str | None = None
        self.last_syncs = 1
        super().__init__(state, chain, constraint, options, config)

    @property
    def n_model(self) -> int:
        return self._shard[1]

    def _run_key(self) -> Key:
        return self._chain_key

    def _step_buffers(self, ws) -> _StepBuffers:
        if self._bufs is None or self._bufs_ws is not ws:
            self._bufs = _StepBuffers((self.K_r, self.K_s, self.K_l), self.cand.prior,
                                      self._shard[0], self._shard[1], self.device)
            self._bufs_ws = ws
        return self._bufs

    def sliced_candidates(self, carry, keys, g, plan, temperature, bufs: _StepBuffers) -> dict:
        """This rank's lanes of a step, gathered over the row and unpacked:
        the full-K bundle in `bufs.full`, as `candidates` returns it."""
        prop = cand_k.candidates(self.cand, self.statics, carry, keys, g, plan, temperature,
                                 bufs=bufs.local, lanes=bufs.lanes)
        if self.device.type == "cpu":
            for grp, group in bufs.local.items():
                src = prop if grp == "out" else prop[grp]
                for name, view in group.items():
                    view.copy_(src[name])
        all_gather_tiled(bufs.recv, bufs.send, self._row)
        torch.index_select(bufs.recv, 0, bufs.index, out=bufs.packed)
        out = bufs.full["out"]
        return dict(out, nr=self.K_r, ns=self.K_s, payr=bufs.full["payr"], payl=bufs.full["payl"],
                    from_prior=out.get("from_prior"))

    def _step(self, ws, i: int) -> None:
        if self.n_model == 1:
            # no slice and no collective: the plain engine's step
            return super()._step(ws, i)
        carry = ws.carry
        rnd, spr = ws.sched.si[sched_k.RND: sched_k.RND + 1], self.config.steps_per_round
        cursor = cand_k.KeyCursor(ws.keys, rnd, i, spr, ws.prior_keys)
        prop = self.sliced_candidates(carry, cursor, self._globals(carry, ws.gbuf), ws.plan,
                                      ws.sched.value(sched_k.T_R), self._step_buffers(ws))
        self._survive_apply(carry, prop, ws, select_k.Epoch(i, rnd, spr))

    def step(self, carry, temperature, plan=None):
        """One eager step at `temperature` under the carry's key (the
        explicit-schedule route), sliced and gathered on a model row."""
        if self.n_model == 1:
            return super().step(carry, temperature, plan)
        keys = cand_k.StepKeys.of(carry.key, intra=self.config.intra_broker, prior=self.cand.prior)
        if self._bufs is None:
            self._bufs = _StepBuffers((self.K_r, self.K_s, self.K_l), self.cand.prior,
                                      self._shard[0], self._shard[1], self.device)
        prop = self.sliced_candidates(carry, keys, self._globals(carry), plan, temperature, self._bufs)
        return self.select_apply(carry, prop, keys.next)

    def _run_fused(self, *, verbose: bool = False, initial_placement=None, reports: bool = False,
                   cycle=None):
        self.last_syncs = 1
        if self.loop_route == "graph":
            try:
                return super()._run_fused(verbose=verbose, initial_placement=initial_placement,
                                          reports=reports, cycle=cycle)
            except _build.CudaLaunchError as e:
                if self.device.type != "cuda" or self.n_model == 1 or "loop graph build" not in str(e):
                    raise
                body = self._ws.graphs.get("body") if self._ws is not None else None
                nodes = sched_k.graph_node_types(body) if body is not None else {}
                log.warning("the card refused the loop graph with the gather in it (%s; the "
                            "round body's nodes %s): the rounds run as a host loop", e, nodes)
                self.loop_route = "host"
                self.loop_error = f"{e}; the round body's nodes by type: {nodes}"
        return self._run_host_loop(verbose=verbose, reports=reports)

    def _run_host_loop(self, *, verbose: bool, reports: bool):
        """The fused schedule with the rounds driven from the host over the
        captured init, check, body, objective and report graphs: the
        `_loop_eager` pattern, the stop decision read on the host, three
        syncs a round (GATE, DECIDE and CLOSE's flags) and one at the end."""
        t_start = time.monotonic()
        self._wait_warm()
        ws = self._workspace()
        self._uses += 1
        dims = self._sched_dims(verbose)
        count_dispatch("engine.init")
        self._stage(ws, None)
        if reports:
            self._stage_delta(ws, None)
        self._capture(ws, verbose, reports, loop=False)
        g = ws.graphs
        replays = dict.fromkeys(g, 0)

        def replay(name):
            g[name].replay()
            replays[name] += 1

        count_dispatch("engine.run")
        if reports:
            replay("pre")
        replay("init")
        rounds = self._loop_eager(ws, dims, False,
                                  pieces=(lambda: replay("eval"), lambda: replay("body"),
                                          lambda: replay("obj")))
        if reports:
            # a whole run is over when its loop ends
            replay("post")
            self._payload_to_host(ws)
        t_disp = time.monotonic()
        count_dispatch("engine.sync")
        torch.cuda.current_stream(self.device).synchronize()
        ys = ws.sched.ys.cpu().numpy().copy()
        count = ws.sched.count.cpu().numpy().copy()
        t_sync = time.monotonic()
        for name, n in replays.items():
            kernels.add_launches(ws.graph_launches[name], n)
        self.last_ys = ys
        self.last_syncs = 3 * rounds + 1
        history = self._fused_history(ys, verbose=verbose)
        timing = dict(
            timing=True, fused=True, blocking_syncs=self.last_syncs, graph_launches=0,
            report_graph_launches=2 if reports else 0, captured=[],
            loop_iterations=int(count[sched_k.ITERS]), masked_rounds=int(count[sched_k.MASKED]),
            host_dispatch_s=round(t_disp - t_start, 6), device_s=round(t_sync - t_disp, 6),
        )
        conv = self._convergence_summary(ys)
        if conv is not None:
            timing["convergence"] = conv
        history.append(timing)
        return self._final_state(ws), history, self._payload(ws) if reports else None

    def run_schedule(self, temps: np.ndarray, key: Key) -> tuple[float, np.ndarray]:
        """The explicit-schedule chain (the JAX package's `_schedule_fn`)
        from carry key `key`: f32[rounds, S] temperatures, each round's
        steps then a refresh and a new plan.  Returns (the final carry
        objective, accepted a round) and leaves the final carry in
        `schedule_carry`."""
        carry = self.init_carry(key)
        plan = self.plan(carry)
        acc = []
        for row in np.asarray(temps, np.float32):
            total = 0
            for t in row:
                carry, stats = self.step(carry, float(t), plan)
                total += int(stats["accepted"])
            self.refresh(carry)
            plan = self.plan(carry)
            acc.append(total)
        self.schedule_carry = carry
        return float(self.carry_objective(carry)), np.asarray(acc, np.int64)


def _stats_arrays(stats) -> dict:
    return {f.name: getattr(stats, f.name).numpy() for f in dataclasses.fields(stats)}


def _stats_of(arrays: dict):
    from cruise_control_tpu_torch.models.stats import ClusterStats

    return ClusterStats(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _carry_digest(carry) -> str:
    """sha1 of every tensor of a carry (its placement, aggregates, key)."""
    h = hashlib.sha1()
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if isinstance(v, torch.Tensor):
            h.update(f.name.encode())
            h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


class RankServer:
    """A rank process's command handlers (parallel/ranks.py `_rank_main`):
    its row sub-groups by model width and its engines by id."""

    def __init__(self, rank: int, world: int, device: str, pg_timeout_s: float):
        self.rank, self.world, self.device = rank, world, torch.device(device)
        self.pg_timeout_s = pg_timeout_s
        self.rows: dict[int, object] = {}
        self.engines: dict[int, dict] = {}

    def handle(self, cmd: str, args):
        return getattr(self, f"cmd_{cmd}")(args)

    def cmd_probe(self, args) -> dict:
        return dict(rank=self.rank, device=str(self.device), engines=sorted(self.engines))

    def cmd_rows(self, n_model: int) -> bool:
        import datetime

        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=self.pg_timeout_s)
        groups = [dist.new_group(list(range(r * n_model, (r + 1) * n_model)), timeout=timeout)
                  for r in range(self.world // n_model)]
        row = self.rank // n_model
        self.rows[n_model] = groups[row] if row < len(groups) else None
        if self.rows[n_model] is not None and n_model > 1:
            # one collective outside any capture initialises the row's communicator
            dist.all_reduce(torch.ones(1, device=self.device), group=self.rows[n_model])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return True

    def _state(self, shared: dict, shape) -> ClusterState:
        return ClusterState(**{f: shared[f].to(self.device) for f in STATE_FIELDS}, shape=shape)

    @staticmethod
    def _host_state(shared: dict, shape) -> ClusterState:
        """The caller's shared host copy as a state (the sharded-model mode
        cuts its own blocks from it)."""
        return ClusterState(**{f: shared[f] for f in STATE_FIELDS}, shape=shape)

    def cmd_build(self, a: dict) -> dict:
        t0 = time.monotonic()
        n_model = a["n_model"]
        common = dict(key=Key(*a["key"]), shard=(a["j"], n_model), group=self.rows.get(n_model))
        if a.get("model_sharded"):
            from cruise_control_tpu_torch.parallel.model_shard import ModelShardEngine

            eng = ModelShardEngine(self._host_state(a["state"], a["shape"]), a["chain"],
                                   a["constraint"], a["options"], a["config"], device=self.device,
                                   **common)
        else:
            eng = RankEngine(self._state(a["state"], a["shape"]), a["chain"], a["constraint"],
                             a["options"], a["config"], **common)
        self.engines[a["eid"]] = dict(engine=eng, slots=a["slots"], r=a["r"], j=a["j"])
        return dict(build_s=time.monotonic() - t0, max_rf=eng.max_rf, state_bytes=model_bytes(eng))

    def cmd_rebind(self, a: dict) -> dict:
        e = self.engines[a["eid"]]["engine"]
        t0 = time.monotonic()
        sharded = getattr(e, "blk", None) is not None
        e.rebind((self._host_state if sharded else self._state)(a["state"], a["shape"]), a["options"])
        return dict(rebind_s=time.monotonic() - t0, max_rf=e.max_rf)

    def cmd_warm(self, eid: int) -> bool:
        e = self.engines[eid]["engine"]
        e.precompile_async()
        e._wait_warm()
        return True

    def cmd_release(self, eid: int) -> bool:
        rec = self.engines.pop(eid, None)
        if rec is not None:
            rec["engine"].release()
        return True

    def cmd_digest(self, eid: int) -> str:
        e = self.engines[eid]["engine"]
        carry = getattr(e, "schedule_carry", None) if self.engines[eid].get("schedule") else None
        return _carry_digest(carry if carry is not None else e._ws.carry)

    def _write_slot(self, rec: dict, values: dict, at: int = 0) -> None:
        slots = rec["slots"]
        for f in SLOT_FIELDS:
            if f in values:
                v = torch.as_tensor(values[f])
                slots[f][rec["r"]][at: at + v.shape[0]].copy_(v)

    def cmd_run(self, a: dict) -> dict:
        rec = self.engines[a["eid"]]
        eng: RankEngine = rec["engine"]
        before = dict(kernels.LAUNCHES)
        calls = GATHER_CALLS[0]
        coll = collectives.counts()
        t0 = time.monotonic()
        final, history, payload = eng._run_fused(verbose=a["verbose"], reports=a["reports"])
        wall = time.monotonic() - t0
        out = dict(ys=eng.last_ys, timing=history[-1], wall_s=wall, syncs=eng.last_syncs,
                   loop_route=eng.loop_route, loop_error=eng.loop_error)
        rec["schedule"] = False
        if a["objective"]:
            out["objective"] = float(eng.carry_objective(eng._ws.carry))
            out["syncs"] += 1
        col = sched_k.ys_columns(eng._sched_dims(a["verbose"]))
        ran = int(eng.last_ys[:, col["ran"]].sum())
        out["collectives"] = ran * eng.config.steps_per_round if eng.n_model > 1 else 0
        out["gather_calls"] = GATHER_CALLS[0] - calls
        out["model_collectives"] = {k: v - coll[k] for k, v in collectives.counts().items()}
        out["launches"] = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
                           if v != before.get(k, 0)}
        blk = getattr(eng, "blk", None)
        if blk is not None:
            # a model shard's rows of the placement, at its block
            out["collectives"] = 0
            out["state_bytes"] = model_bytes(eng)
            self._write_slot(rec, {f: getattr(final, f) for f in SLOT_FIELDS[:3]}, at=blk.r_off)
        elif rec["j"] == 0:
            if payload is not None:
                self._write_slot(rec, payload)
                # the reports by value (numpy): a CPU tensor would cross in a
                # shared-memory segment of its own
                out["payload"] = {k: (_stats_arrays(v) if k.startswith("stats_") else v)
                                  for k, v in payload.items() if k not in SLOT_FIELDS}
            else:
                self._write_slot(rec, {f: getattr(final, f) for f in SLOT_FIELDS[:3]})
        return out

    # -- segmented runs: the caller drives the slice boundaries ------------

    def cmd_seg_init(self, a: dict) -> bool:
        """The run's init (the captured init graph on the card), then the
        checkpoint's state copied into the run's own tensors where `resume`
        holds one (this rank's chain's host arrays: only read)."""
        rec = self.engines[a["eid"]]
        eng: RankEngine = rec["engine"]
        eng._wait_warm()
        ws = eng._workspace()
        eng._uses += 1
        dims = eng._sched_dims(False)
        eng._stage(ws, None)
        replays: dict = {}
        route = "eager"
        if eng.device.type == "cuda":
            eng._capture(ws, False, False, loop=False)
            # a one-rank row runs PR 14's slice graph; a wider one a host
            # loop over the same captured graphs (the card refuses a loop
            # graph holding NCCL's nodes)
            route = "slice" if eng.n_model == 1 else "host"
            if route == "slice":
                eng._slice_graph(ws, False)
            ws.graphs["init"].replay()
            replays["init"] = 1
        else:
            eng._init_run(ws, dims)
        ck = a.get("resume")
        if ck is not None:
            carry, rest = eng._run_state(ws)
            for part, tensors in ((ck["carry"], carry), (ck["seg"], rest)):
                for k, t in tensors.items():
                    t.copy_(torch.from_numpy(np.array(part[k])))
        rec["seg"] = dict(ws=ws, dims=dims, rounds=0, slices=0, replays=replays, route=route,
                          before=dict(kernels.LAUNCHES), calls=GATHER_CALLS[0], t0=time.monotonic())
        return True

    def cmd_seg_slice(self, a: dict) -> dict:
        """Rounds up to the slice's end (the schedule's SLICE_END): the
        slice graph (one launch and one sync) or a host loop over the
        captured graphs on the card, op by op on the CPU.  Returns the ys,
        the loop's counts and the done flag."""
        rec = self.engines[a["eid"]]
        eng: RankEngine = rec["engine"]
        seg = rec["seg"]
        ws, dims, rep_n = seg["ws"], seg["dims"], seg["replays"]
        end = int(a["end"])
        if seg["route"] == "slice":
            stream = torch.cuda.current_stream(eng.device)
            ws.sched.si[sched_k.SLICE_END: sched_k.SLICE_END + 1].fill_(end)
            eng._slice_graph(ws, False).launch(stream.cuda_stream)
            stream.synchronize()
            seg["slices"] += 1
            return dict(ys=ws.ys_host.numpy().copy(), count=ws.count_host.numpy().copy(),
                        done=bool(ws.si_host.numpy()[sched_k.DONE]))
        if seg["route"] == "host":
            ws.sched.si[sched_k.SLICE_END: sched_k.SLICE_END + 1].fill_(end)

            def replay(name):
                ws.graphs[name].replay()
                rep_n[name] = rep_n.get(name, 0) + 1

            rounds = eng._loop_eager(ws, dims, False, pieces=(
                lambda: replay("eval"), lambda: replay("body"), lambda: replay("obj")))
            torch.cuda.current_stream(eng.device).synchronize()
        else:
            ws.sched.si[sched_k.SLICE_END] = end
            rounds = eng._loop_eager(ws, dims, False)
        seg["rounds"] += rounds
        seg["slices"] += 1
        si = ws.sched.si.cpu().numpy()
        return dict(ys=ws.sched.ys.cpu().numpy().copy(), count=ws.sched.count.cpu().numpy().copy(),
                    done=bool(si[sched_k.DONE]))

    def cmd_seg_snapshot(self, eid: int) -> dict:
        """This rank's run state at the slice boundary (the plain engine's
        `_run_state`) as host copies in shared memory: the pipe carries
        their handles, not their bytes (the caller copies them out)."""
        rec = self.engines[eid]
        count_dispatch("engine.snapshot")
        carry, rest = rec["engine"]._run_state(rec["seg"]["ws"])

        def host(d):
            return {k: t.detach().to("cpu", copy=True).share_memory_() for k, t in d.items()}

        return dict(carry=host(carry), seg=host(rest))

    def cmd_seg_finish(self, a: dict) -> dict:
        """The run's end: its launches counted, its placement into the
        chain's slot (rank 0 of the row), its carry objective (a portfolio
        picks the winner from it)."""
        rec = self.engines[a["eid"]]
        eng: RankEngine = rec["engine"]
        seg = rec.pop("seg")
        ws = seg["ws"]
        if seg["route"] == "slice":
            ys, count = ws.ys_host.numpy(), ws.count_host.numpy()
            eng._count_replays(ws, ys, int(count[sched_k.ITERS]), False, False,
                               exits=seg["slices"])
        else:
            for name, n in seg["replays"].items():
                kernels.add_launches(ws.graph_launches[name], n)
        syncs = seg["slices"] if seg["route"] == "slice" else 3 * seg["rounds"] + seg["slices"]
        out = dict(wall_s=time.monotonic() - seg["t0"], syncs=syncs,
                   gather_calls=GATHER_CALLS[0] - seg["calls"],
                   launches={k: v - seg["before"].get(k, 0) for k, v in kernels.LAUNCHES.items()
                             if v != seg["before"].get(k, 0)})
        if a["objective"]:
            out["objective"] = float(eng.carry_objective(ws.carry))
        rec["schedule"] = False
        if rec["j"] == 0:
            c = ws.carry
            self._write_slot(rec, dict(replica_broker=c.replica_broker,
                                       replica_is_leader=c.replica_is_leader,
                                       replica_disk=c.replica_disk))
        return out

    def cmd_schedule(self, a: dict) -> dict:
        rec = self.engines[a["eid"]]
        eng: RankEngine = rec["engine"]
        calls = GATHER_CALLS[0]
        obj, acc = eng.run_schedule(a["temps"], Key(*a["key"]))
        rec["schedule"] = True
        c = eng.schedule_carry
        if rec["j"] == 0:
            self._write_slot(rec, dict(replica_broker=c.replica_broker,
                                       replica_is_leader=c.replica_is_leader,
                                       replica_disk=c.replica_disk))
        return dict(objective=obj, accepted=acc, gather_calls=GATHER_CALLS[0] - calls)


# ----------------------------------------------------------------------
# the caller's side
# ----------------------------------------------------------------------


class _HistoryReader:
    """The plain engine's ys readers over a config and chain (no engine)."""

    _n_rounds = Engine._n_rounds
    _sched_dims = Engine._sched_dims
    _ys_keys = Engine._ys_keys
    _ys_dict = Engine._ys_dict
    _fused_history = Engine._fused_history
    _convergence_summary = Engine._convergence_summary

    def __init__(self, config: OptimizerConfig, chain: GoalChain):
        self.config, self.chain = config, chain


def model_bytes(eng: Engine) -> int:
    """Bytes of a rank's model on its device: the statics' state and member
    table, and the carry's placement and partition x rack cells (the
    O(R) and O(P) state the sharded-model mode divides by n)."""
    st = eng.statics.state
    s = st.shape
    total = sum(getattr(st, f).numel() * getattr(st, f).element_size() for f in STATE_FIELDS)
    total += eng.statics.part_replicas.numel() * 4
    return int(total + s.R * 9 + s.P * s.num_racks * 4)


def _shared(state: ClusterState) -> dict:
    """CPU copies of the state's fields in shared memory, for the ranks."""
    return {f: getattr(state, f).detach().to("cpu", copy=True).share_memory_() for f in STATE_FIELDS}


class MeshEngine:
    """One engine for every multi-device mode (sharded, grid, portfolio).

    Construction pads the input to its shape bucket (when a policy is
    given), then to equal model-axis blocks (`shard_multiple_shape`), so an
    exact and a bucketed build anneal the same; builds one `RankEngine` a
    rank of `mesh` (a `Layout`; every local card, one model row, when None)
    on the device set's rank group.  `run()` runs the plain engine's fused
    schedule on every chain (in slices under a SegmentContext or from a
    checkpoint, `resume=`); `run_reported()` adds the optimizer's reports;
    `run_schedule()` runs an explicit [rounds, steps] temperature schedule
    (the portfolio entry point).  `timeout_s` bounds each command.  With
    `model_shard_min_partitions` > 0, a state of at least that many real
    partitions on a model axis over 1 runs the sharded-model mode
    (`model_sharded`; parallel/model_shard.py)."""

    _ids = itertools.count()

    def __init__(
        self,
        state: ClusterState,
        chain: GoalChain,
        mesh: Layout | None = None,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        options: OptimizationOptions = DEFAULT_OPTIONS,
        config: OptimizerConfig = OptimizerConfig(),
        bucket=None,
        model_shard_min_partitions: int = 0,
        *,
        timeout_s: float | None = None,
    ):
        self.mesh = normalize_mesh(mesh if mesh is not None else model_mesh())
        self.n_restarts = int(self.mesh.shape[RESTART_AXIS])
        self.n = int(self.mesh.shape[MODEL_AXIS])
        # the gate reads the REAL partition count (before any padding, so
        # padding never flips the mode between generations of a cluster)
        self.model_sharded = (model_shard_min_partitions > 0 and self.n > 1
                              and int(state.shape.P) >= int(model_shard_min_partitions))
        self.chain, self.constraint, self.config = chain, constraint, config
        self.options = options
        self.timeout_s = timeout_s
        self._bucket = bucket if bucket is not None and bucket.enabled else None
        self.global_state = state
        self.state = self._padded(state)
        self.shape = self.state.shape
        self.device = state.device
        self._reader = _HistoryReader(config, chain)
        self._eid = next(MeshEngine._ids)
        self._group = None
        self._slots: dict | None = None
        self._lock = threading.RLock()
        self._warm = None
        #: diagnostics of the most recent completed run (None before and during)
        self.last_info: dict | None = None
        self.build_info: dict = {}
        self._build()

    @classmethod
    def from_engine(cls, engine: Engine, mesh: Layout, *, timeout_s: float | None = None
                    ) -> "MeshEngine":
        """A mesh engine of an EXISTING plain engine's bound state, options,
        chain, constraint and config (portfolio_run's entry); the caller's
        engine is never touched."""
        state, options, _prior = engine._bound_args
        return cls(state, engine.chain, mesh=mesh, constraint=engine.constraint, options=options,
                   config=engine.config, timeout_s=timeout_s)

    # -- layout and data ------------------------------------------------------

    @property
    def ranks(self) -> list[int]:
        return list(range(self.mesh.size))

    def _padded(self, state: ClusterState) -> ClusterState:
        shape = state.shape
        if self._bucket is not None:
            shape = self._bucket.bucket_shape(shape)
        if self.model_sharded:
            # equal contiguous row blocks a shard, on top of the bucket shape
            shape = shard_multiple_shape(shape, self.n)
        if shape == state.shape:
            return state
        from cruise_control_tpu_torch.models.builder import pad_state

        return pad_state(state, shape)

    def _keys(self) -> list[Key]:
        """Chain 0 of a one-chain layout: the plain engine's key; a
        portfolio's chains: split(PRNGKey(seed), R)."""
        base = Key.from_seed(self.config.seed)
        return [base] if self.n_restarts == 1 else base.split(self.n_restarts)

    def _build(self) -> None:
        """The ranks' engines on the live rank group of the device set
        (a new group after a failure closed the last one)."""
        t0 = time.monotonic()
        g = rank_group(self.mesh.devices)
        started = time.monotonic() - t0
        g.ensure_rows(self.n)
        R = self.shape.R
        self._slots = {
            "replica_broker": torch.zeros((self.n_restarts, R), dtype=torch.int32),
            "replica_is_leader": torch.zeros((self.n_restarts, R), dtype=torch.bool),
            "replica_disk": torch.zeros((self.n_restarts, R), dtype=torch.int32),
            "replica_offline": torch.zeros((self.n_restarts, R), dtype=torch.bool),
            "replica_disk_bytes": torch.zeros((self.n_restarts, R), dtype=torch.float32),
        }
        for t in self._slots.values():
            t.share_memory_()
        shared = _shared(self.state)
        keys = self._keys()
        per = []
        for k in self.ranks:
            r, j = divmod(k, self.n)
            per.append(dict(eid=self._eid, state=shared, shape=self.shape, chain=self.chain,
                            constraint=self.constraint, options=self.options, config=self.config,
                            key=keys[r].words, r=r, j=j, n_model=self.n, slots=self._slots,
                            model_sharded=self.model_sharded))
        answers = g.call("build", ranks=self.ranks, per_rank=per, timeout_s=self.timeout_s)
        self._group = g
        self.max_rf = int(answers[0]["max_rf"])
        self.build_info = dict(group_start_s=round(started, 6), group=g.start_info,
                               build_s=round(time.monotonic() - t0, 6),
                               rank_build_s=max(a["build_s"] for a in answers),
                               rank_state_bytes=[int(a["state_bytes"]) for a in answers])

    def _ensure(self) -> None:
        """Rebuild on a new rank group where the engine's group was closed
        by a failure."""
        if self._group is None or not self._group.alive:
            self._build()

    def rebind(self, state: ClusterState, options: OptimizationOptions = DEFAULT_OPTIONS
               ) -> "MeshEngine":
        """Swap in a new model generation of the engine's (padded) shape:
        shared with the ranks once, then each rank's engine rebinds (data,
        no capture).  A shape that no longer fits raises ValueError, the
        optimizer's signal to build a new engine."""
        padded = self._padded(state)
        if padded.shape != self.shape:
            raise ValueError(f"shape changed {self.shape} -> {padded.shape}; build a new MeshEngine")
        with self._lock:
            self._wait_warm()
            self.global_state, self.state, self.options = state, padded, options
            if self._group is None or not self._group.alive:
                self._build()
                return self
            answers = self._group.call(
                "rebind", dict(eid=self._eid, state=_shared(padded), shape=self.shape,
                               options=options), ranks=self.ranks, timeout_s=self.timeout_s)
            self.max_rf = int(answers[0]["max_rf"])
        return self

    @contextlib.contextmanager
    def locked(self):
        """Hold the engine's run lock for the block (the optimizer's
        threads take it around each rebind and run)."""
        with self._lock:
            yield self

    def release(self) -> None:
        """Free the ranks' engines (on engine-cache eviction).  Unusable after."""
        with self._lock:
            g, self._group = self._group, None
            if g is not None and g.alive:
                try:
                    g.call("release", self._eid, ranks=self.ranks, timeout_s=self.timeout_s)
                except Exception:  # noqa: BLE001 -- a dead group holds nothing
                    log.warning("mesh engine release failed", exc_info=True)
            self._slots = None
            self.global_state = self.state = None

    def precompile_async(self, *, priority: int = 0) -> None:
        """Capture the ranks' graphs ahead of use on the shared warm pool
        (each rank's `Engine.precompile_async`, waited for)."""
        if self._warm is None:
            self._warm = warm_pool_submit(
                lambda: self._group.call("warm", self._eid, ranks=self.ranks,
                                         timeout_s=self.timeout_s), priority=priority)

    def _wait_warm(self) -> None:
        """Wait for the warm pool's captures; raise their error once (the
        next run captures on its own path, on a new group if it died)."""
        warm, self._warm = self._warm, None
        if warm is not None:
            warm.result()

    # -- collective accounting ----------------------------------------------------

    @property
    def collective_bytes_per_step(self) -> int:
        """Bytes each rank holds after a step's all_gather (the run's only
        collective): M slices of the rank's packed candidate columns, the
        accept column among them (the kernel accepts before the gather).
        0 on a one-rank model axis, where nothing is gathered.  In the
        sharded-model mode, the bytes a rank all-reduces a step (the
        ownership hops; parallel/model_shard.py `psum_bytes_per_step`)."""
        if self.model_sharded:
            from cruise_control_tpu_torch.parallel.model_shard import psum_bytes_per_step

            return psum_bytes_per_step(*kind_split(self.config), self.max_rf, self.shape.num_racks)
        return packed_bytes_per_step(self.config, self.n)

    @property
    def collective_bytes_per_round(self) -> int:
        if self.model_sharded:
            from cruise_control_tpu_torch.parallel.model_shard import psum_bytes_per_round

            return psum_bytes_per_round(self.shape, self.config, kind_split(self.config),
                                        self.max_rf)
        return self.collective_bytes_per_step * self.config.steps_per_round

    # -- runs -------------------------------------------------------------------------

    @device_op("mesh.run")
    def run(self, *, verbose: bool = False, resume: CarryCheckpoint | None = None):
        """Execute (or RESUME) the fused schedule on every chain; returns
        (final_state, history) with the plain engine's history contract
        (the winner chain's rounds; `accepted` summed over chains) plus a
        timing record with `mesh_shape` and `collective_bytes`.

        Under an ambient SegmentContext, or with a `resume` checkpoint, the
        replicated modes run in slices (`_run_segmented`): the scheduler's
        preemption seam and the fault-tolerance layer's, whose checkpoints
        ride the slice boundaries; `resume` continues the remaining rounds
        from a checkpoint taken at any model width.  The sharded-model mode
        has no segmented variant: it runs whole, and a resume raises (the
        optimizer restarts it instead)."""
        return self._run_any(verbose, resume)

    @device_op("mesh.run")
    def run_reported(self, *, verbose: bool = False, resume: CarryCheckpoint | None = None):
        """`run` with the optimizer's reports; returns (final_state,
        history, payload) as `Engine.run_reported` does.  On the one-launch
        route the winner chain's ranks compute them (their before and
        after reports and device checks); a segmented or sharded-model run
        computes them on the caller from the result (`_caller_reports`)."""
        seg = current_segment_context() is not None or resume is not None
        if self.model_sharded or (seg and not verbose):
            final, history = self._run_any(verbose, resume)
            return final, history, self._caller_reports(final)
        return self._run(verbose=verbose, reports=True)

    def _run_any(self, verbose: bool, resume):
        seg_ctx = current_segment_context()
        if not verbose and not self.model_sharded and (seg_ctx is not None or resume is not None):
            if seg_ctx is None:
                # a resume outside a scheduler grant: slices for the
                # checkpoint cadence only, never for wall bounding
                seg_ctx = SegmentContext(float("inf"))
            return self._run_segmented(seg_ctx, resume=resume)
        if resume is not None:
            raise ValueError("mesh resume requires the segmented path (replicated modes, "
                             "non-verbose)")
        final, history, _ = self._run(verbose=verbose, reports=False)
        return final, history

    def _caller_reports(self, final: ClusterState) -> dict:
        """The optimizer's payload computed here, on the caller's device:
        the before and after reports of the engine's (padded) state and of
        the result placed on it, the device checks, and the result's
        replica_offline and leader disk bytes (the rank route's
        `_cycle_pre` / `_cycle_post`, by the same functions)."""
        from cruise_control_tpu_torch.models.aggregates import compute_aggregates
        from cruise_control_tpu_torch.models.state import validate_on_device
        from cruise_control_tpu_torch.models.stats import compute_stats

        st = self.state
        R = self.global_state.shape.R
        pad = st.shape.R - R
        dev = st.device

        def padded(t, fill):
            t = t.to(dev)
            return t if pad == 0 else torch.cat([t, fill[R:]])

        after = _placed_state(st, padded(final.replica_broker, st.replica_broker),
                              padded(final.replica_is_leader, st.replica_is_leader),
                              padded(final.replica_disk, st.replica_disk))
        weights = torch.tensor(self.chain.weights, dtype=torch.float32, device=dev)
        out = {}
        for when, s in (("before", st), ("after", after)):
            agg = compute_aggregates(s, s.members)
            obj, viol, _ = self.chain.evaluate(s, agg=agg, constraint=self.constraint,
                                               weights=weights)
            stats = compute_stats(s, agg)
            out[f"obj_{when}"] = np.float32(obj.cpu())
            out[f"viol_{when}"] = viol.cpu().numpy().astype(np.float32)
            out[f"stats_{when}"] = dataclasses.replace(stats, **{
                f.name: getattr(stats, f.name).cpu() for f in dataclasses.fields(stats)})
        out["checks"] = validate_on_device(after).cpu().numpy()
        for f in ("replica_broker", "replica_is_leader", "replica_disk", "replica_offline"):
            out[f] = getattr(after, f)[:R].cpu().numpy().copy()
        out["replica_disk_bytes"] = st.replica_load_leader[:R, int(Resource.DISK)].cpu().numpy().copy()
        return out

    # -- segmented runs (mesh fault tolerance) ------------------------------------

    def checkpoint_capture(self, base: int, ys_parts: list) -> CarryCheckpoint:
        """The run's state at a slice boundary (the ranks idle after the
        slice's sync): one rank a chain (a model row's carries are bit for
        bit equal) returns its run state as host arrays; chain r's are
        `carry[k][r]` / `seg[k][r]`.  No device placement in it, so a
        narrower mesh with the same chain count restores it."""
        count_dispatch("mesh.snapshot")
        leaders = [r * self.n for r in range(self.n_restarts)]
        answers = self._group.call("seg_snapshot", self._eid, ranks=leaders,
                                   timeout_s=self.timeout_s)
        carry = {k: np.stack([a["carry"][k].numpy() for a in answers]) for k in answers[0]["carry"]}
        seg = {k: np.stack([a["seg"][k].numpy() for a in answers]) for k in answers[0]["seg"]}
        return CarryCheckpoint(base=int(base), carry=carry, seg=seg,
                               ys_parts=[dict(p) for p in ys_parts], n_chains=self.n_restarts,
                               meta=dict(seed=int(self.config.seed),
                                         mesh_shape=[self.n_restarts, self.n]))

    def _restore_checkpoint(self, ckpt: CarryCheckpoint) -> list[dict]:
        """Chain r's part of `ckpt`, for each chain of this layout.  The
        ranks copy it into their own tensors (`cmd_seg_init`): the
        checkpoint is only ever read, so a second resume from it (another
        degrade in one episode, a retry at another width) finds it whole."""
        if int(ckpt.n_chains) != self.n_restarts:
            raise ValueError(f"checkpoint has {ckpt.n_chains} chains; this mesh runs "
                             f"{self.n_restarts}: a resume needs the same chains")
        return [dict(carry={k: v[r] for k, v in ckpt.carry.items()},
                     seg={k: v[r] for k, v in ckpt.seg.items()}) for r in range(self.n_restarts)]

    def _run_segmented(self, seg_ctx: SegmentContext, *, resume: CarryCheckpoint | None = None):
        """The mesh's fused schedule in wall-bounded slices (the JAX
        package's `_run_segmented`): the ranks run rounds [base, base + L)
        a slice (`cmd_seg_slice`), one command and one sync a slice, L
        growing in powers of two up to SEGMENT_MAX_ROUNDS from an EWMA of
        the per-round wall against `slice_budget_s`; between slices the
        scheduler's checkpoint, then `offer_snapshot`.  The ranks replay
        the graphs of the one-launch run on the same tensors, so the
        rounds, placements and ys are bit for bit its own, and a resume
        continues them from the checkpoint's round."""
        cfg = self.config
        self.last_info = None
        t_start = time.monotonic()
        total = cfg.num_rounds + cfg.extra_round_budget
        budget = max(1e-3, float(seg_ctx.slice_budget_s))
        R, n = self.n_restarts, self.n
        with self._lock:
            self._wait_warm()
            self._ensure()
            g = self._group
            if resume is not None:
                chains = self._restore_checkpoint(resume)
                base, ys_parts = int(resume.base), [dict(p) for p in resume.ys_parts]
            else:
                chains, base, ys_parts = None, 0, []
            count_dispatch("mesh.init")
            g.call("seg_init", ranks=self.ranks, per_rank=[
                dict(eid=self._eid, resume=None if chains is None else chains[k // n])
                for k in self.ranks], timeout_s=self.timeout_s)
            device_s, round_wall, L, slices = 0.0, None, 1, []
            answers = None
            while base < total:
                t0s = time.monotonic()
                seq = _BLACKBOX.begin("engine-slice", slice=len(slices), base_round=base, rounds=L,
                                      total_rounds=total, mesh_shape=[R, n], n_devices=R * n)
                try:
                    count_dispatch("mesh.slice")
                    answers = g.call("seg_slice", dict(eid=self._eid, end=base + L),
                                     ranks=self.ranks, timeout_s=self.timeout_s)
                    count_dispatch("mesh.sync")
                except BaseException as e:  # noqa: BLE001 -- recorded, re-raised
                    _BLACKBOX.end(seq, ok=False, error=repr(e))
                    raise
                done = all(answers[r * n]["done"] for r in range(R))
                _BLACKBOX.end(seq, done=done)
                wall = time.monotonic() - t0s
                device_s += wall
                slices.append(dict(base=base, rounds=L, wall_s=round(wall, 6)))
                ys_parts.append(dict(base=base, end=min(base + L, total)))
                base += L
                per_round = wall / L
                round_wall = per_round if round_wall is None else 0.5 * round_wall + 0.5 * per_round
                if done or base >= total:
                    break
                L = 1
                while L * 2 * round_wall <= budget and L * 2 <= SEGMENT_MAX_ROUNDS:
                    L *= 2
                if seg_ctx.checkpoint is not None:
                    seg_ctx.checkpoint()
                seg_ctx.offer_snapshot(lambda b=base, p=list(ys_parts): self.checkpoint_capture(b, p))
            finish = g.call("seg_finish", dict(eid=self._eid, objective=R > 1), ranks=self.ranks,
                            timeout_s=self.timeout_s)
            objs = np.asarray([finish[r * n].get("objective", np.nan) for r in range(R)], np.float32)
            winner = int(np.argmin(objs)) if R > 1 else 0
            final = self._final_state(winner)
        launches: dict = {}
        for a in finish:
            for k, v in a["launches"].items():
                launches[k] = launches.get(k, 0) + v
        kernels.add_launches(launches, 1)
        ys_list = [answers[r * n]["ys"] for r in range(R)] if answers is not None else []
        history = self._history(ys_list, winner, False) if ys_list else []
        timing = dict(
            timing=True, fused=True, segmented=True, segments=len(slices),
            blocking_syncs=max(a["syncs"] for a in finish), slices=slices,
            device_s=round(device_s, 6),
            host_dispatch_s=round(time.monotonic() - t_start - device_s, 6),
            mesh_shape=[R, n], collective_bytes=self.collective_bytes_per_round,
            ranks=self.mesh.size, backend=g.backend, devices=list(self.mesh.devices),
        )
        if resume is not None:
            timing["resumed_from_round"] = int(resume.base)
        if seg_ctx.snapshots_taken or seg_ctx.snapshots_skipped:
            timing["snapshots"] = seg_ctx.snapshots_taken
            timing["snapshot_s"] = round(seg_ctx.snapshot_seconds, 6)
        if cfg.diagnostics and ys_list:
            timing["convergence"] = self._reader._convergence_summary(self._mixed_ys(ys_list, winner))
        history.append(timing)
        self.last_info = dict(objectives=objs, winner=winner, n_chains=R, n_shards=n,
                              gather_calls=[int(a["gather_calls"]) for a in finish],
                              rank_walls=[a["wall_s"] for a in finish], launches=launches,
                              segments=len(slices))
        return final, history

    def _run(self, *, verbose: bool, reports: bool):
        cfg = self.config
        self.last_info = None
        t_start = time.monotonic()
        with self._lock:
            self._wait_warm()
            self._ensure()
            answers = self._group.call(
                "run", dict(eid=self._eid, verbose=verbose, reports=reports,
                            objective=self.n_restarts > 1),
                ranks=self.ranks, timeout_s=self.timeout_s)
            t_run = time.monotonic()
            leaders = [answers[r * self.n] for r in range(self.n_restarts)]
            objs = np.asarray([a.get("objective", np.nan) for a in leaders], np.float32)
            winner = int(np.argmin(objs)) if self.n_restarts > 1 else 0
            final = self._final_state(winner)
            payload = None
            if reports:
                payload = {k: (_stats_of(v) if k.startswith("stats_") else v)
                           for k, v in leaders[winner]["payload"].items()}
                for f in SLOT_FIELDS:
                    payload[f] = self._slots[f][winner][: self.global_state.shape.R].numpy().copy()
        launches: dict = {}
        for a in answers:
            for k, v in a["launches"].items():
                launches[k] = launches.get(k, 0) + v
        kernels.add_launches(launches, 1)
        history = self._history([a["ys"] for a in leaders], winner, verbose)
        w = leaders[winner]
        timing = dict(
            timing=True, fused=True, blocking_syncs=max(a["syncs"] for a in answers),
            host_dispatch_s=round(t_run - t_start, 6),
            device_s=round(max(a["wall_s"] for a in answers), 6),
            mesh_shape=[self.n_restarts, self.n],
            collective_bytes=self.collective_bytes_per_round,
            collectives=int(w["collectives"]),
            loop_route=w["loop_route"],
            captured=w["timing"].get("captured", []),
            loop_iterations=w["timing"].get("loop_iterations"),
            ranks=self.mesh.size, backend=self._group.backend,
            devices=list(self.mesh.devices),
        )
        if cfg.diagnostics:
            timing["convergence"] = self._reader._convergence_summary(self._mixed_ys(
                [a["ys"] for a in leaders], winner))
        if self.model_sharded:
            # only in this mode: the replicated records stay as they were
            timing["model_sharded"] = True
            timing["model_psum_bytes"] = int(self.collective_bytes_per_round)
            timing["model_collectives"] = answers[0]["model_collectives"]
        history.append(timing)
        self.last_info = dict(
            objectives=objs, winner=winner, n_chains=self.n_restarts, n_shards=self.n,
            model_collectives=[a["model_collectives"] for a in answers],
            state_bytes=[a.get("state_bytes") for a in answers],
            collectives=[int(a["collectives"]) for a in answers],
            gather_calls=[int(a["gather_calls"]) for a in answers],
            loop_route=[a["loop_route"] for a in answers],
            loop_error=next((a["loop_error"] for a in answers if a["loop_error"]), None),
            rank_walls=[a["wall_s"] for a in answers], launches=launches,
        )
        return final, history, payload

    def _mixed_ys(self, ys_list: list, winner: int) -> np.ndarray:
        """The winner chain's ys with each count column summed over chains."""
        ys = np.array(ys_list[winner], copy=True)
        col = sched_k.ys_columns(self._reader._sched_dims(False))
        for k in _COUNT_YS:
            if k in col:
                ys[:, col[k]] = sum(y[:, col[k]] for y in ys_list)
        return ys

    def _history(self, ys_list: list, winner: int, verbose: bool) -> list[dict]:
        """The plain engine's history from the winner chain's per-round
        flags, with counts summed over chains (the JAX package's mesh
        `_history`): a one-chain run's history is the plain engine's."""
        return self._reader._fused_history(self._mixed_ys(ys_list, winner), verbose=verbose)

    def _final_state(self, winner: int) -> ClusterState:
        """The winner's placement on the CALLER's own (unpadded) axes and
        device, with replica_offline from the cluster's health."""
        st = self.global_state
        R = st.shape.R
        rb = self._slots["replica_broker"][winner][:R].clone()
        rl = self._slots["replica_is_leader"][winner][:R].clone()
        rd = self._slots["replica_disk"][winner][:R].clone()
        alive = st.broker_alive.cpu()
        dalive = st.disk_alive.cpu()
        rbl, rdl = rb.long(), rd.long()
        offline = ~(alive[rbl] & dalive[rbl, rdl]) & st.replica_valid.cpu()
        dev = st.device
        return dataclasses.replace(st, replica_broker=rb.to(dev), replica_is_leader=rl.to(dev),
                                   replica_disk=rd.to(dev), replica_offline=offline.to(dev))

    @device_op("mesh.run")
    def run_schedule(self, temps, *, seed: int = 0):
        """Run one chain per restart row through an EXPLICIT temperature
        schedule (f32[S] or f32[rounds, S]); returns (best final state,
        {"objectives", "n_chains", "n_shards", "winner", "accepted"}).
        Chain r's key is split(PRNGKey(seed), R)[r]."""
        if self.model_sharded:
            raise ValueError("the sharded-model mode runs the fused schedule only (run_schedule "
                             "is the portfolio's entry point)")
        temps = np.asarray(temps, np.float32)
        if temps.ndim == 1:
            temps = temps[None]
        with self._lock:
            self._ensure()
            keys = Key.from_seed(seed).split(self.n_restarts)
            answers = self._group.call("schedule", ranks=self.ranks, per_rank=[
                dict(eid=self._eid, temps=temps, key=keys[k // self.n].words) for k in self.ranks],
                timeout_s=self.timeout_s)
            leaders = [answers[r * self.n] for r in range(self.n_restarts)]
            objs = np.asarray([a["objective"] for a in leaders], np.float32)
            winner = int(np.argmin(objs))
            final = self._final_state(winner)
        info = dict(objectives=objs, n_chains=self.n_restarts, n_shards=self.n, winner=winner,
                    accepted=np.stack([a["accepted"] for a in leaders]),
                    gather_calls=[int(a["gather_calls"]) for a in answers])
        self.last_info = info
        return final, info

    def carry_digests(self) -> list[str]:
        """Each rank's sha1 of its last run's final carry: equal within a
        model row (the replicated carries stay bit for bit equal)."""
        with self._lock:
            return self._group.call("digest", self._eid, ranks=self.ranks,
                                    timeout_s=self.timeout_s)

    def _blackbox_fields(self) -> dict:
        return {"mesh_shape": [self.n_restarts, self.n], "n_devices": self.mesh.size}

