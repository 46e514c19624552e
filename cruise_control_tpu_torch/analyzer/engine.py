"""Batched simulated-annealing optimization engine, single device.

Every step, K candidate moves (replica relocations, replica swaps and
leadership transfers) are sampled and their exact objective deltas are
computed in parallel in O(1) each — gathers against per-broker aggregates
plus frozen per-step globals.  Metropolis acceptance keeps a candidate if
delta < -T*log(u); a maximal non-conflicting subset of the accepted
candidates survives (best-ranked per broker and per partition), and the
survivors are scattered into the placement and the aggregates.  This
replaces the reference's single-threaded greedy goal loop (reference
analyzer/goals/AbstractGoal.java:66-107).

Rounds: between rounds the aggregates are recomputed from the placement
(washing out float drift), the importance-sampling plan is rebuilt, and
the early-stop signals are read; the temperature decays geometrically and
the last scheduled round runs at T=0, followed by up to `max_extra_rounds`
polish rounds while the full goal chain keeps improving.  The schedule is
the one the JAX package's fused program runs (its `_fused_round_step`),
driven here by one host loop with one small device sync per round.

A step is three hand-written CUDA kernels (kernels/): the candidates
(draws, gathers, feasibility, exact deltas and Metropolis acceptance,
kernels/candidates.py), the conflict resolution (select_survivors) and
the scatter (apply_moves), around the per-step globals in PyTorch ops.
The carry is updated in place by each step.

With the same cluster, configuration and seed, the draws are bit-identical
to the JAX package's and, on small clusters where float reductions agree,
so is the whole trajectory (tests/test_torch_optimizer.py).

Not in this port yet (each raises NotImplementedError when configured):
intra-broker disk moves, the learned move-acceptance prior, convergence
diagnostics, bf16 scoring, the legacy round loop; segmented execution,
ahead-of-time compilation, the streaming cycle and the mesh engines have
no entry point here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.objective import TIE_WEIGHT, GoalChain
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS, OptimizationOptions
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.kernels import apply as apply_k
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.kernels import move_delta as md
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.models.aggregates import (
    BrokerAggregates,
    compute_aggregates,
    segment_sum,
)
from cruise_control_tpu_torch.models.state import ClusterShape, ClusterState


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Search knobs; field for field the JAX package's OptimizerConfig."""

    num_candidates: int = 2048  # K sampled moves per step
    leadership_candidates: int = 512  # of which leadership transfers
    swap_candidates: int = 512  # of which replica swaps (clamped so at least
    # one plain relocation candidate remains)
    steps_per_round: int = 64
    num_rounds: int = 10  # aggregates are re-derived each round
    init_temperature_scale: float = 1e-2  # T0 = scale * initial objective
    temperature_decay: float = 0.5  # per-round geometric decay; last round T=0
    seed: int = 0
    #: movement pricing: a move away from a replica's ORIGINAL broker/leader
    #: pays, moving back refunds (reference executor/Executor.java:485-510)
    replica_move_cost: float = 0.5  # per relocated replica, / n_valid
    leadership_move_cost: float = 1.0  # per relocated leadership, / n_valid
    #: fraction of replica-move sources importance-sampled from brokers with
    #: the largest objective contribution (the rest uniform)
    importance_fraction: float = 0.5
    intra_broker: bool = False  # not ported: raises
    #: stop once the weighted goal violations fall to this level; <0 disables
    early_stop_violations: float = 1e-6
    #: extra T=0 polish rounds past num_rounds while the full goal chain
    #: still reports violations and each round keeps improving; 0 disables
    max_extra_rounds: int = 8
    #: the port has one round loop, the fused schedule; False (the JAX
    #: package's legacy loop) is not ported and raises
    fused_rounds: bool = True
    prior_enabled: bool = False  # not ported: raises
    diagnostics: bool = False  # not ported: raises
    score_dtype: str = "float32"  # "bfloat16" not ported: raises

    def __post_init__(self):
        if self.num_rounds < 1:
            raise ValueError(f"num_rounds must be >= 1, got {self.num_rounds}")
        if self.steps_per_round < 1:
            raise ValueError(f"steps_per_round must be >= 1, got {self.steps_per_round}")
        if self.max_extra_rounds < 0:
            raise ValueError(f"max_extra_rounds must be >= 0, got {self.max_extra_rounds}")
        if self.num_candidates < 1:
            raise ValueError(f"num_candidates must be >= 1, got {self.num_candidates}")
        if self.score_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"score_dtype must be 'float32' or 'bfloat16', got {self.score_dtype!r}"
            )

    @property
    def extra_round_budget(self) -> int:
        """Extra polish rounds actually runnable (they are gated on the
        early-stop signal, so disabling early stop disables them)."""
        return self.max_extra_rounds if self.early_stop_violations >= 0.0 else 0

    @property
    def early_stop_tol(self) -> float:
        """The early-stop threshold as the f32 value the checks compare against."""
        return float(np.float32(self.early_stop_violations))

    def check_ported(self) -> None:
        """Raise NotImplementedError for the modes this port lacks."""
        missing = [
            name for name, on in (
                ("intra_broker", self.intra_broker),
                ("prior_enabled", self.prior_enabled),
                ("diagnostics", self.diagnostics),
                ("score_dtype=bfloat16", self.score_dtype != "float32"),
                ("fused_rounds=False", not self.fused_rounds),
            ) if on
        ]
        if missing:
            raise NotImplementedError(f"not ported to the PyTorch engine: {', '.join(missing)}")


@dataclasses.dataclass
class EngineCarry:
    """Placement + incremental aggregates, updated in place by each step."""

    replica_broker: torch.Tensor
    replica_is_leader: torch.Tensor
    replica_disk: torch.Tensor
    broker_load: torch.Tensor  # f32[B, 4] (includes dead brokers' stranded load)
    broker_replica_count: torch.Tensor  # i32[B]
    broker_leader_count: torch.Tensor  # i32[B]
    broker_potential_nw_out: torch.Tensor  # f32[B]
    broker_leader_bytes_in: torch.Tensor  # f32[B]
    broker_topic_count: torch.Tensor  # i32[T, B]
    part_rack_count: torch.Tensor  # i32[P, num_racks]
    disk_load: torch.Tensor  # f32[B, D]
    host_load: torch.Tensor  # f32[H, 4]
    key: Key

    def clone(self) -> "EngineCarry":
        return EngineCarry(**{
            f.name: (v.clone() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)
        })


@dataclasses.dataclass(frozen=True)
class EngineStatics:
    """Per-model-generation inputs of the engine."""

    state: ClusterState
    part_replicas: torch.Tensor  # i32[P, max_rf] replica ids, padded with R
    alive: torch.Tensor  # bool[B] valid & alive
    dest_ids: torch.Tensor  # i32[B] allowed destination ids, cyclically padded
    dest_ok: torch.Tensor  # bool[B] allowed-destination mask
    lead_ok: torch.Tensor  # bool[B]
    topic_movable: torch.Tensor  # bool[T]
    host_multi: torch.Tensor  # bool[H]
    host_cap: torch.Tensor  # f32[H, 4]
    total_cap: torch.Tensor  # f32[4]
    n_alive: float  # f32 value
    n_valid: float  # f32 value
    total_disk_cap: float  # f32 value
    #: replica slots uniform source draws cover (the valid prefix when
    #: replicas are front-packed, else R)
    n_source: int
    #: real entries at the head of dest_ids
    n_dest: int
    #: valid broker count (clips the importance sampler's CDF search)
    n_brokers: int
    #: broker ids grouped by host (stable), brokers with no host in range
    #: last, and the i32[H + 2] group offsets: apply_moves' owner threads
    host_brokers: torch.Tensor
    host_start: torch.Tensor
    #: i32[2, B] scratch of apply_moves (each broker's surviving src and
    #: dst row), -1 between calls
    apply_slots: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """Per-round importance sampling + movement pricing: a source broker is
    drawn from a categorical proportional to its objective contribution,
    then a replica uniformly on it via a broker-grouped index
    (order/start/count)."""

    broker_cdf: torch.Tensor  # f32[B] inclusive cumsum of broker probabilities
    order: torch.Tensor  # i32[R] replica ids grouped by broker (invalid last)
    start: torch.Tensor  # i32[B] group offsets into order
    count: torch.Tensor  # i32[B] replicas per broker
    replica_cost: torch.Tensor  # f32 scalar: price per strayed replica
    lead_cost: torch.Tensor  # f32 scalar: price per strayed leadership


def partition_replica_table(
    valid: np.ndarray, part: np.ndarray, pos: np.ndarray, shape: ClusterShape
) -> np.ndarray:
    """i32[P, max_rf] replica indices per partition, padded with R (host
    numpy; membership never changes during optimization)."""
    P, R = shape.P, shape.R
    max_rf = 1
    counts = np.bincount(part[valid], minlength=P)
    if counts.size:
        max_rf = max(1, int(counts.max()))
    table = np.full((P, max_rf), R, np.int32)
    idx = np.nonzero(valid)[0]
    slot = np.minimum(pos[idx], max_rf - 1)
    table[part[idx], slot] = idx
    return table


def build_statics(state: ClusterState, options: OptimizationOptions) -> EngineStatics:
    """Host-side (numpy) preprocessing of one model generation."""
    s = state.shape
    dev = state.device
    h = {
        k: getattr(state, k).cpu().numpy()
        for k in (
            "broker_valid", "broker_alive", "broker_capacity", "broker_host",
            "disk_alive", "disk_capacity", "replica_valid", "replica_partition",
            "replica_pos",
        )
    }
    alive = h["broker_valid"] & h["broker_alive"]
    cap = h["broker_capacity"]
    dest = alive & options.dest_allowed(state)
    dest_idx = np.nonzero(dest)[0].astype(np.int32)
    if dest_idx.size == 0:
        dest_idx = np.nonzero(alive)[0].astype(np.int32)
    if dest_idx.size == 0:
        dest_idx = np.zeros(1, np.int32)
    # cyclic pad to [B]: uniform sampling over the padded list stays uniform
    # over the allowed set
    dest_pad = dest_idx[np.arange(s.B) % dest_idx.size]
    host = h["broker_host"]
    valid_b = h["broker_valid"]
    bph = np.bincount(host[valid_b], minlength=s.num_hosts)
    host_cap = np.zeros((s.num_hosts, NUM_RESOURCES), np.float32)
    np.add.at(host_cap, host[valid_b & alive], cap[valid_b & alive])
    dmask = h["disk_alive"] & alive[:, None]
    n_valid_int = int(h["replica_valid"].sum())
    host_group = np.where((host >= 0) & (host < s.num_hosts), host, s.num_hosts)
    host_start = np.zeros(s.num_hosts + 2, np.int32)
    host_start[1:] = np.cumsum(np.bincount(host_group, minlength=s.num_hosts + 1))
    front_packed = bool(h["replica_valid"][:n_valid_int].all())
    n_source = n_valid_int if front_packed else s.R

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return EngineStatics(
        state=state,
        part_replicas=t(partition_replica_table(
            h["replica_valid"], h["replica_partition"], h["replica_pos"], s
        )),
        alive=t(alive),
        dest_ids=t(dest_pad, torch.int32),
        dest_ok=t(dest),
        lead_ok=t(alive & options.leadership_allowed(state)),
        topic_movable=t(options.topic_movable(state)),
        host_multi=t(bph > 1),
        host_cap=t(host_cap),
        total_cap=t(((cap * alive[:, None]).sum(0) + np.float32(1e-12)).astype(np.float32)),
        n_alive=float(np.float32(max(1.0, float(alive.sum())))),
        n_valid=float(np.float32(max(1.0, float(n_valid_int)))),
        total_disk_cap=float(np.float32((h["disk_capacity"] * dmask).sum() + 1e-12)),
        n_source=max(1, n_source),
        n_dest=int(dest_idx.size),
        n_brokers=max(1, int(valid_b.sum())),
        host_brokers=t(np.argsort(host_group, kind="stable"), torch.int32),
        host_start=t(host_start),
        apply_slots=torch.full((2, s.B), -1, dtype=torch.int32, device=dev),
    )


_RES_DIST_NAMES = {
    Resource.CPU: "CpuUsageDistributionGoal",
    Resource.NW_IN: "NetworkInboundUsageDistributionGoal",
    Resource.NW_OUT: "NetworkOutboundUsageDistributionGoal",
    Resource.DISK: "DiskUsageDistributionGoal",
}
_CAP_NAMES = {
    Resource.CPU: "CpuCapacityGoal",
    Resource.NW_IN: "NetworkInboundCapacityGoal",
    Resource.NW_OUT: "NetworkOutboundCapacityGoal",
    Resource.DISK: "DiskCapacityGoal",
}


@dataclasses.dataclass(frozen=True)
class _Weights:
    """Per-term weights extracted from a GoalChain (0 = goal not in chain)."""

    offline: float
    rack: float
    replica_cap: float
    cap: tuple[float, float, float, float]  # by Resource index
    pot_nw_out: float
    replica_dist: float
    leader_dist: float
    res_dist: tuple[float, float, float, float]
    topic_dist: float
    lbin_dist: float
    pref_leader: float
    intra_cap: float
    intra_dist: float
    tie: float

    @staticmethod
    def from_chain(chain: GoalChain) -> "_Weights":
        w = {g.name: wt for g, wt in zip(chain.goals, chain.weights)}
        return _Weights(
            offline=w.get("OfflineReplicaGoal", 0.0),
            rack=w.get("RackAwareGoal", 0.0),
            replica_cap=w.get("ReplicaCapacityGoal", 0.0),
            cap=tuple(w.get(_CAP_NAMES[Resource(i)], 0.0) for i in range(4)),
            pot_nw_out=w.get("PotentialNwOutGoal", 0.0),
            replica_dist=w.get("ReplicaDistributionGoal", 0.0),
            leader_dist=w.get("LeaderReplicaDistributionGoal", 0.0),
            res_dist=tuple(w.get(_RES_DIST_NAMES[Resource(i)], 0.0) for i in range(4)),
            topic_dist=w.get("TopicReplicaDistributionGoal", 0.0),
            lbin_dist=w.get("LeaderBytesInDistributionGoal", 0.0),
            pref_leader=w.get("PreferredLeaderElectionGoal", 0.0),
            intra_cap=w.get("IntraBrokerDiskCapacityGoal", 0.0),
            intra_dist=w.get("IntraBrokerDiskUsageDistributionGoal", 0.0),
            tie=TIE_WEIGHT * min(chain.weights),
        )


#: budget of authoritative (full goal chain) early-stop checks per run when
#: the cheap O(B) gate opens but goals folded into candidate deltas still
#: have work
FULL_CHECK_BUDGET = 2


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum accumulated in f32, element after element.
    PyTorch's CPU cumsum accumulates in f64, which rounds differently from
    the reference's f32 scan; numpy's f32 cumsum is the sequential f32
    sum.  On CUDA the prefix sum is PyTorch's (a parallel scan)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.cumsum(x.numpy(), dtype=np.float32))
    return torch.cumsum(x, 0)


class Engine:
    """Optimization engine bound to one ClusterShape and device.

    Reuse one Engine across model generations of the same shape with
    `rebind(state)`.
    """

    def __init__(
        self,
        state: ClusterState,
        chain: GoalChain,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        options: OptimizationOptions = DEFAULT_OPTIONS,
        config: OptimizerConfig = OptimizerConfig(),
    ):
        config.check_ported()
        self.chain = chain
        self.constraint = constraint
        self.config = config
        self.w = _Weights.from_chain(chain)
        self.shape: ClusterShape = state.shape
        self.device = state.device
        # effective candidate split: leadership + swap carved out of K; swaps
        # never take more than half the non-leadership budget
        self.K_l = min(config.leadership_candidates, config.num_candidates - 1)
        self.K_s = min(config.swap_candidates, max(0, (config.num_candidates - self.K_l) // 2))
        self.K_r = config.num_candidates - self.K_l - self.K_s
        self.rebind(state, options)

    def rebind(self, state: ClusterState, options: OptimizationOptions = DEFAULT_OPTIONS) -> "Engine":
        """Swap in a new model generation of the same shape."""
        if state.shape != self.shape:
            raise ValueError(f"shape changed {self.shape} -> {state.shape}; build a new Engine")
        if state.device != self.device:
            raise ValueError(f"state is on {state.device}, the engine on {self.device}")
        self.statics = build_statics(state, options)
        sx = self.statics
        self.tp = md.TermParams.build(
            self.w, self.constraint, sx.total_cap.cpu().numpy(), sx.n_valid, sx.n_alive,
            sx.total_disk_cap,
        )
        cfg = self.config
        self.cand = cand_k.CandParams(
            tp=self.tp, K_r=self.K_r, K_s=self.K_s, K_l=self.K_l,
            w_rack=self.w.rack, w_offline=self.w.offline, w_topic=self.w.topic_dist,
            w_pref=self.w.pref_leader,
            topic_tt=self.constraint.topic_replica_count_balance_threshold,
            replica_move_cost=cfg.replica_move_cost, leadership_move_cost=cfg.leadership_move_cost,
            importance_fraction=cfg.importance_fraction, num_parts=max(1, self.shape.P),
        )
        return self

    # ------------------------------------------------------------------
    # state <-> carry
    # ------------------------------------------------------------------

    def init_carry(self, key: Key) -> EngineCarry:
        """Carry seeded from the statics' placement, with aggregates
        computed from it."""
        st = self.statics.state
        placement = dict(
            replica_broker=st.replica_broker.clone(),
            replica_is_leader=st.replica_is_leader.clone(),
            replica_disk=st.replica_disk.clone(),
        )
        return EngineCarry(key=key, **placement, **self._aggregates(**placement))

    def carry_to_state(self, carry: EngineCarry) -> ClusterState:
        return self._placed_state(carry.replica_broker, carry.replica_is_leader, carry.replica_disk)

    def _placed_state(self, replica_broker, replica_is_leader, replica_disk) -> ClusterState:
        """The statics' cluster with another placement."""
        st = self.statics.state
        offline = ~(st.broker_alive[replica_broker] & st.disk_alive[replica_broker, replica_disk])
        return dataclasses.replace(
            st,
            replica_broker=replica_broker,
            replica_is_leader=replica_is_leader,
            replica_disk=replica_disk,
            replica_offline=offline & st.replica_valid,
        )

    def _aggregates(self, **placement) -> dict:
        """The carry's aggregate fields, computed from a placement."""
        state = self._placed_state(**placement)
        agg = compute_aggregates(state)
        H = self.shape.num_hosts
        hseg = torch.where(state.broker_valid, state.broker_host, H)
        return dict(
            broker_load=agg.broker_load,
            broker_replica_count=agg.broker_replica_count,
            broker_leader_count=agg.broker_leader_count,
            broker_potential_nw_out=agg.broker_potential_nw_out,
            broker_leader_bytes_in=agg.broker_leader_bytes_in,
            broker_topic_count=agg.broker_topic_count,
            part_rack_count=agg.part_rack_count,
            disk_load=agg.disk_load,
            host_load=segment_sum(agg.broker_load, hseg, H + 1)[:H],
        )

    def refresh(self, carry: EngineCarry) -> EngineCarry:
        """Recompute every aggregate of the carry from its placement."""
        return dataclasses.replace(carry, **self._aggregates(
            replica_broker=carry.replica_broker,
            replica_is_leader=carry.replica_is_leader,
            replica_disk=carry.replica_disk,
        ))

    # ------------------------------------------------------------------
    # objective views
    # ------------------------------------------------------------------

    def _broker_terms(self, b, load, rcount, lcount, pot, lbin, g):
        return md.broker_terms(self.tp, self.statics, b, load, rcount, lcount, pot, lbin, g)

    def _tie_term(self, pct_sum, pct_sumsq):
        return md.tie_term(self.tp, pct_sum, pct_sumsq)

    def carry_objective(self, carry: EngineCarry, g=None) -> torch.Tensor:
        """Scalar SA objective from carry aggregates: the delta-decomposed
        objective the step optimizes (broker terms + rack + offline + tie),
        not the full goal-chain evaluation."""
        sx = self.statics
        if g is None:
            g = self._globals(carry)
        b = torch.arange(self.shape.B, device=self.device)
        terms = self._broker_terms(
            b, carry.broker_load, carry.broker_replica_count, carry.broker_leader_count,
            carry.broker_potential_nw_out, carry.broker_leader_bytes_in, g,
        ).sum()
        rack = torch.clamp(carry.part_rack_count - 1, min=0).sum().to(torch.float32)
        terms = terms + self.w.rack * rack / sx.n_valid
        st = sx.state
        offline = (
            st.replica_valid
            & ~(
                st.broker_alive[carry.replica_broker]
                & st.disk_alive[carry.replica_broker, carry.replica_disk]
            )
        ).sum().to(torch.float32)
        terms = terms + self.w.offline * offline / sx.n_valid
        return terms + self._tie_term(g["pct_sum"], g["pct_sumsq"])

    def cheap_violations(self, carry: EngineCarry) -> torch.Tensor:
        """O(B) lower-bound signal: the delta-decomposed objective minus the
        dispersion tiebreaker.  It misses goals folded into candidate deltas
        only (topic distribution), so `run` uses it to gate the
        authoritative full-chain check."""
        g = self._globals(carry)
        return self.carry_objective(carry, g) - self._tie_term(g["pct_sum"], g["pct_sumsq"])

    def evaluate(self, carry: EngineCarry):
        """(full objective, per-goal violation vector f32[G]) of the carry,
        scored by the goal chain against the carry's aggregates."""
        agg = BrokerAggregates(
            broker_load=carry.broker_load,
            broker_replica_count=carry.broker_replica_count,
            broker_leader_count=carry.broker_leader_count,
            broker_potential_nw_out=carry.broker_potential_nw_out,
            broker_leader_bytes_in=carry.broker_leader_bytes_in,
            broker_topic_count=carry.broker_topic_count,
            part_rack_count=carry.part_rack_count,
            disk_load=carry.disk_load,
        )
        obj, viol, _ = self.chain.evaluate(
            self.carry_to_state(carry), agg=agg, constraint=self.constraint
        )
        return obj, viol

    def plan(self, carry: EngineCarry) -> SamplingPlan:
        """Importance-sampling + movement-pricing plan from the aggregates."""
        sx = self.statics
        st = sx.state
        B, R = self.shape.B, self.shape.R
        g = self._globals(carry)
        b = torch.arange(B, device=self.device)
        w = self._broker_terms(
            b, carry.broker_load, carry.broker_replica_count, carry.broker_leader_count,
            carry.broker_potential_nw_out, carry.broker_leader_bytes_in, g,
        )
        # stranded replicas on dead brokers/disks carry the offline-goal mass
        dead = st.broker_valid & ~sx.alive
        w = w + self.w.offline * torch.where(
            dead, carry.broker_replica_count.to(torch.float32), 0.0
        ) / sx.n_valid
        # topic-distribution violations live in [T, B] cells the broker
        # terms cannot see
        if self.w.topic_dist != 0.0:
            tt = self.constraint.topic_replica_count_balance_threshold
            upper = torch.ceil(g["topic_avg"] * tt)[:, None]
            lower = torch.floor(g["topic_avg"] * max(0.0, 2.0 - tt))[:, None]
            cnt = carry.broker_topic_count.to(torch.float32)
            cells = _relu(cnt - upper) + _relu(lower - cnt)  # [T, B]
            w = w + self.w.topic_dist * torch.where(sx.alive, cells.sum(0), 0.0) / g["total_count"]
        w = torch.clamp(torch.where(st.broker_valid, w, 0.0), min=0.0)
        total = w.sum()
        uni = torch.where(st.broker_valid, 1.0, 0.0)
        uni = uni / torch.clamp(uni.sum(), min=1.0)
        probs = torch.where(total > 1e-12, w / torch.clamp(total, min=1e-12), uni)
        unit = self.carry_objective(carry, g) / sx.n_valid

        seg = torch.where(st.replica_valid, carry.replica_broker, B)
        count = segment_sum(torch.ones(R, dtype=torch.int32, device=self.device), seg, B + 1)[:B]
        start = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=self.device),
            torch.cumsum(count, 0)[:-1].to(torch.int32),
        ])
        return SamplingPlan(
            broker_cdf=_cumsum_f32(probs),
            order=torch.argsort(seg, stable=True).to(torch.int32),
            start=start,
            count=count,
            replica_cost=self.config.replica_move_cost * unit,
            lead_cost=self.config.leadership_move_cost * unit,
        )

    def _globals(self, carry: EngineCarry) -> dict:
        """Per-step frozen global scalars, O(B + T*B) from the aggregates."""
        sx = self.statics
        st = sx.state
        am = sx.alive
        load = torch.where(am[:, None], carry.broker_load, 0.0)
        total_load = load.sum(0)
        total_count = torch.where(am, carry.broker_replica_count, 0).sum().to(torch.float32)
        total_lcount = torch.where(am, carry.broker_leader_count, 0).sum().to(torch.float32)
        total_lbin = torch.where(am, carry.broker_leader_bytes_in, 0.0).sum()
        topic_total = torch.where(am[None, :], carry.broker_topic_count, 0).sum(1)
        dmask = st.disk_alive & am[:, None]
        total_disk_load = torch.where(dmask, carry.disk_load, 0.0).sum()
        pct = torch.where(am[:, None], carry.broker_load / (st.broker_capacity + 1e-12), 0.0)
        return dict(
            total_load=total_load,
            avg_pct=total_load / sx.total_cap,
            avg_count=total_count / sx.n_alive,
            total_count=torch.clamp(total_count, min=1.0),
            avg_lcount=total_lcount / sx.n_alive,
            total_lcount=torch.clamp(total_lcount, min=1.0),
            avg_lbin=total_lbin / sx.n_alive,
            total_lbin=total_lbin + 1e-12,
            topic_avg=topic_total.to(torch.float32) / sx.n_alive,
            total_disk_load=total_disk_load + 1e-12,
            pct_sum=pct.sum(0),
            pct_sumsq=(pct * pct).sum(0),
        )

    # ------------------------------------------------------------------
    # step: propose + evaluate + accept -> select -> apply
    # ------------------------------------------------------------------

    def step(self, carry: EngineCarry, temperature: float, plan: SamplingPlan | None = None):
        """One anneal step at `temperature` (an f32 value); updates `carry`
        in place and returns (carry, stats) with device-side counts."""
        keys = cand_k.StepKeys.of(carry.key)
        prop = cand_k.candidates(
            self.cand, self.statics, carry, keys, self._globals(carry), plan, temperature
        )
        return self.select_apply(carry, prop, keys.next)

    def select_apply(self, carry: EngineCarry, prop: dict, next_key: Key):
        """Conflict resolution + scatter of an accepted candidate bundle."""
        delta, feas = prop["delta"], prop["feas"]
        survive = select_k.select_survivors(
            prop["accept"], delta, prop["src"], prop["dst"], prop["part1"], prop["part2"],
            num_brokers=self.shape.B, num_parts=self.shape.P,
        )
        nr, ns = prop["nr"], prop["ns"]
        sv_s = survive[nr: nr + ns]
        sv_r_ext = torch.cat([survive[:nr], sv_s, sv_s])
        apply_k.apply_moves(self.statics, carry, sv_r_ext, prop["payr"], survive[nr + ns:],
                            prop["payl"])
        carry.key = next_key
        stats = dict(
            accepted=survive.sum(),
            improving=(feas & (delta < 0)).sum(),
            delta=torch.where(survive, delta, 0.0).sum(),
        )
        return carry, stats

    def round_prep(self, carry: EngineCarry):
        """Between rounds: recompute the aggregates (wash float drift),
        build the next round's sampling plan, read the cheap early-stop
        signal."""
        carry = self.refresh(carry)
        return carry, self.plan(carry), self.cheap_violations(carry)

    # ------------------------------------------------------------------
    # the round schedule
    # ------------------------------------------------------------------

    def run(self, *, verbose: bool = False):
        """Execute the annealing schedule; returns (final_state, history).

        history holds one record per round that ran (round, temperature,
        accepted, early_stop on the round whose state satisfied the full
        chain, extra on polish rounds, objective when verbose) and one
        timing record (blocking host syncs, run wall seconds).  The schedule is the JAX package's fused one: the
        main rounds' temperatures T0 * decay^round with the last main round
        at T=0; from round 1 on, a cheap O(B) signal at or below the tolerance
        opens at most FULL_CHECK_BUDGET full-chain checks that may stop the
        run; after the main rounds, polish rounds at T=0 while the worst goal
        violation exceeds the tolerance and falls by 10% or more a round.
        """
        cfg = self.config
        t_start = time.monotonic()
        syncs = 0
        carry = self.init_carry(Key.from_seed(cfg.seed))
        obj0, _ = self.evaluate(carry)
        plan = self.plan(carry)
        t0 = np.float32(obj0.item()) * np.float32(cfg.init_temperature_scale)
        syncs += 1

        n_main = cfg.num_rounds
        total = n_main + cfg.extra_round_budget
        tol_on = cfg.early_stop_violations >= 0.0
        tol = cfg.early_stop_tol
        cheap_prev = float("inf")
        checks_left = FULL_CHECK_BUDGET
        prev_v = np.float32(np.inf)
        has_prev = False
        history: list[dict] = []

        for rnd in range(total):
            is_extra = rnd >= n_main
            if tol_on:
                main_gate = (not is_extra) and rnd > 0 and checks_left > 0 and cheap_prev <= tol
                if main_gate or is_extra:
                    full_v = np.float32(self.evaluate(carry)[1].max().item())
                    syncs += 1
                else:
                    full_v = np.float32(np.inf)
                main_stop = main_gate and full_v <= tol
                if main_gate and not main_stop:
                    checks_left -= 1
                extra_stop = is_extra and (
                    full_v <= tol or (has_prev and full_v > prev_v * np.float32(0.9))
                )
                if main_stop and history:
                    history[-1]["early_stop"] = True
                if main_stop or extra_stop:
                    break
                if is_extra:
                    prev_v, has_prev = full_v, True
            if is_extra or rnd == n_main - 1:
                t_r = np.float32(0.0)
            else:
                t_r = t0 * np.float32(cfg.temperature_decay) ** np.float32(rnd)
            accepted = torch.zeros((), dtype=torch.int64, device=self.device)
            for _ in range(cfg.steps_per_round):
                carry, stats = self.step(carry, float(t_r), plan)
                accepted += stats["accepted"]
            carry, plan, cheap = self.round_prep(carry)
            # the round's one sync: both scalars in one transfer (f64 holds
            # the count and the f32 signal exactly)
            acc, cheap_prev = torch.stack([accepted.double(), cheap.double()]).tolist()
            syncs += 1
            rec = dict(round=len(history), temperature=float(t_r), accepted=int(acc))
            if is_extra:
                rec["extra"] = True
            if verbose:
                rec["objective"] = float(self.evaluate(carry)[0].item())
            history.append(rec)
        history.append(dict(
            timing=True, blocking_syncs=syncs, run_s=round(time.monotonic() - t_start, 6),
        ))
        return self.carry_to_state(carry), history
