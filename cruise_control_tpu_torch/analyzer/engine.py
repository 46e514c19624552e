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
polish rounds while the full goal chain keeps improving.

Execution model (fused rounds, the default; the JAX package's
`_run_fused`): the host issues the whole schedule without reading a device
value, then makes ONE blocking sync to fetch the per-round scalars.  On
CUDA, a run is one launch of one CUDA graph (kernels/schedule.py
`LoopGraph`): the captured init graph, then a conditional WHILE node whose
body is one round (the schedule kernel's gate, a conditional IF node around
the full-chain check, the schedule kernel's decision, a conditional IF node
around the round body, i.e. its steps and the round prep, and the schedule
kernel's close, which ends the loop once the run is done), then the
schedule kernel's exit, which writes the rounds the loop never reached as
the reference's masked rounds would.  The init, steps, round prep and goal
chain are captured once per engine, from the same code that runs eagerly,
and serve every model generation it is bound to (below).  On the CPU the
same route runs op by op: the schedule state lives in tensors, the
conditionals and the loop read its flags, and the ys are read once at the
end.

The legacy round loop (`fused_rounds=False`, the JAX package's
`_run_legacy`) drives the rounds from the host with one or more blocking
syncs a round; both routes share every kernel, key and temperature rule,
so at T=0 with a fixed seed they give identical trajectories.

A step is four hand-written CUDA kernels (kernels/): the per-step
globals (step_globals), the candidates (draws, gathers, feasibility, exact
deltas and Metropolis acceptance, kernels/candidates.py), the conflict
resolution (select_survivors, which also writes the scatter's relocation
mask and adds the step's survivor count into the round's accumulator) and
the scatter (apply_moves), with no PyTorch op between them.  A round prep
is group_by_broker and refresh_aggregates (every aggregate recomputed from
the placement) and step_globals, around the plan's PyTorch ops.  The
carry, the plan and the step's buffers are fixed tensors updated in place,
so a step allocates nothing of its own and can be captured.

With the same cluster, configuration and seed, the draws are bit-identical
to the JAX package's and, on small clusters where float reductions agree,
so is the whole trajectory (tests/test_torch_optimizer.py,
tests/test_torch_fused.py).

`intra_broker=True` is the JAX package's rebalance_disk mode: every
candidate is an intra-broker disk move (the candidates kernel's intra
kind), with no swaps and no leadership transfers.  `run(initial_placement=)`
warm-starts the anneal from another placement: the init graph reads the
start placement from fixed staging tensors that the run fills before its
launch, so a warm start neither recaptures nor adds a sync.

`prior_enabled=True` mixes the learned move-acceptance prior
(controller/prior.py) into the relocations' destination draws: the
candidates kernel reads the prior's per-topic CDF and mix from fixed
statics tensors, which `rebind(prior=)` and `rebind_prior` refill in place,
so a new prior is data, never a recapture; a cold prior (mix 0) draws the
uniform stream bit for bit.  `diagnostics=True` adds to every round that
ran its survivors by kind, its prior usage and the full chain's objective
and per-goal violations after the round (counted by select_survivors and
evaluated inside the captured round body, written by the schedule's
CLOSE), with no extra sync; the run's timing record carries the
`convergence` summary.  The legacy route ignores it, as the JAX
package's does.  `score_dtype="bfloat16"` sums the broker terms (in the
candidates kernel and the plain objective views) and the chain's weighted
objective in bf16; violations, scores and reports stay f32.

The streaming cycle (`run_cycle`, the JAX package's `run_cycle` and
`_cycle_impl`) is a fused run with its reports: a window's new load rows
scattered into the engine's own load tables (kernels/scatter.py), the
before-report, the warm anneal, the after-report and the device checks,
fetched with the ys in one blocking sync.  On CUDA the scatter and the
before-report are one captured graph (`pre`), the after-report and the
checks another (`post`), launched around the loop graph; the scatter reads
the window's width on the device from fixed staging tensors, so every
window replays the same graphs.  `run_reported` is the same run without a
window (the optimizer's reports ride it), so the first optimize of an
engine captures what every later cycle replays.

A model generation is data to the captured graphs, as one XLA compile
serves every generation of a shape in the JAX package: the engine keeps
the bound state's fields, the statics and a small generation block (the
counts and capacity totals the kernels and the objective read,
kernels/move_delta.py `Generation`) in tensors of its own, and `rebind`
copies each generation into them in stream order; no launch argument and
no Python value inside the captured region comes from the generation.
So an engine captures once per shape bucket: its ClusterShape and its
member table's width (max_rf), the optimizer's cache key with the
config; a rebind that changes max_rf alone reallocates the buffers and
captures anew.
`precompile_async` captures ahead of use on the shared warm pool
(`_WarmPool`); a run waits for a capture in flight and raises its error.

Segmented execution (the JAX package's `_run_segmented`): under an ambient
`SegmentContext` (`segmented_execution`, set by the device scheduler
around a preemptible grant, fleet/scheduler.py) `run` and `run_reported`
split the fused schedule into wall-bounded slices with a checkpoint
between them, where the scheduler may pause the run while an urgent one
takes the device.  A slice is one launch of the slice graph, the loop
graph without init over the same captured graphs, whose last round the
schedule reads from device memory (kernels/schedule.py SLICE_END), then
one blocking sync; no slice length captures or instantiates a graph of
its own, and a segmented run makes the rounds of the one-launch run, bit
for bit.  An engine has one workspace, so a run paused at a checkpoint
lets go of the engine: it copies its state into a stash on the device and
releases the run lock (`locked`), and on resume, where another run used
the engine meanwhile, rebinds its own generation (data, no capture) and
copies the stash back.

Ahead-of-time compilation and the mesh engines have no entry point here.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import contextvars
import dataclasses
import heapq
import itertools
import logging
import threading
import time

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.objective import SCORE_DTYPES, TIE_WEIGHT, GoalChain
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS, OptimizationOptions
from cruise_control_tpu_torch.analyzer.prewarm import bucket_key
from cruise_control_tpu_torch.common import compilation_cache
from cruise_control_tpu_torch.common.blackbox import RECORDER as _BLACKBOX
from cruise_control_tpu_torch.common.collectives import gsum
from cruise_control_tpu_torch.common.device_watchdog import device_op
from cruise_control_tpu_torch.common.dispatch import count_dispatch
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.kernels import apply as apply_k
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.kernels import move_delta as md
from cruise_control_tpu_torch.kernels import scatter as scatter_k
from cruise_control_tpu_torch.kernels import schedule as sched_k
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.kernels import step_globals as glob_k
from cruise_control_tpu_torch.kernels.group import Grouping, group_placement
from cruise_control_tpu_torch.kernels.refresh import AGG_FIELDS, HostGroups, refresh_aggregates
from cruise_control_tpu_torch.models.aggregates import (
    BrokerAggregates,
    compute_aggregates,
    empty_aggregates,
)
from cruise_control_tpu_torch.models.state import (
    STATE_FIELDS,
    ClusterShape,
    ClusterState,
    member_table,
    replica_members,
    validate_on_device,
)
from cruise_control_tpu_torch.models.stats import ClusterStats, compute_stats
from cruise_control_tpu_torch.models.whatif import _round_up_pow2

log = logging.getLogger(__name__)

#: the state's load columns: data to the engine, which keeps them in
#: tensors of its own (`build_statics(loads=)`)
LOAD_FIELDS = ("replica_load_leader", "replica_load_follower")
#: a report's ClusterStats fields and their lengths, in the report row's
#: order after the objective and the per-goal violations
REPORT_STATS = (("avg", 4), ("max", 4), ("min", 4), ("std", 4), ("replica_count_std", 1),
                ("leader_count_std", 1), ("potential_nw_out_std", 1))


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
    #: rebalance_disk: only intra-broker disk moves (K_r = num_candidates)
    intra_broker: bool = False
    #: stop once the weighted goal violations fall to this level; <0 disables
    early_stop_violations: float = 1e-6
    #: extra T=0 polish rounds past num_rounds while the full goal chain
    #: still reports violations and each round keeps improving; 0 disables
    max_extra_rounds: int = 8
    #: True: the fused schedule (one blocking sync a run); False: the
    #: legacy host-driven round loop (syncs every round)
    fused_rounds: bool = True
    #: learned move-acceptance prior: relocation destination draws mix a
    #: per-(source topic, destination) categorical (controller/prior.py)
    #: into the uniform draw; a cold prior (mix 0) is the uniform stream
    prior_enabled: bool = False
    #: convergence diagnostics: each round's objective, per-goal
    #: violations, survivors by kind and prior usage, in the fused run's
    #: ys (no extra sync); the legacy route ignores it
    diagnostics: bool = False
    #: "bfloat16" sums the broker terms and the chain's weighted objective
    #: in bf16 (analyzer.precision.score.dtype); violations stay f32
    score_dtype: str = "float32"

    def __post_init__(self):
        if self.num_rounds < 1:
            raise ValueError(f"num_rounds must be >= 1, got {self.num_rounds}")
        if self.steps_per_round < 1:
            raise ValueError(f"steps_per_round must be >= 1, got {self.steps_per_round}")
        if self.max_extra_rounds < 0:
            raise ValueError(f"max_extra_rounds must be >= 0, got {self.max_extra_rounds}")
        if self.num_candidates < 1:
            raise ValueError(f"num_candidates must be >= 1, got {self.num_candidates}")
        if self.score_dtype not in SCORE_DTYPES:
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


#: per-round keys of the fused run's ys (the JAX package's FUSED_YS_KEYS)
FUSED_YS_KEYS = ("accepted", "ran", "stopped", "temperature", "cheap")
#: the keys with convergence diagnostics: the full chain's objective, the
#: per-goal violation vector, survivors by kind and prior usage
FUSED_DIAG_YS_KEYS = FUSED_YS_KEYS + (
    "objective", "goal_viol", "acc_replica", "acc_swap", "acc_lead",
    "prior_cands", "prior_acc",
)


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

    def aggregates(self) -> dict:
        """The aggregate tensors by field (AGG_FIELDS and host_load): what
        the refresh writes in place."""
        return {f: getattr(self, f) for f in (*AGG_FIELDS, "host_load")}


@dataclasses.dataclass(frozen=True)
class EngineStatics:
    """Per-model-generation inputs of the engine.  An engine keeps one set
    of these tensors for its shape bucket and each rebind refills them in
    place (`build_statics(out=)`), so the graphs captured on them serve
    every generation.  The generation's counts and totals live only in
    its block (`gen`; `gen.values()` reads them on the host)."""

    state: ClusterState
    #: i32[P, max_rf] valid replica ids of each partition, padded with R
    #: (models/state.py replica_members: every valid row exactly once)
    part_replicas: torch.Tensor
    alive: torch.Tensor  # bool[B] valid & alive
    dest_ids: torch.Tensor  # i32[B] allowed destination ids, cyclically padded
    dest_ok: torch.Tensor  # bool[B] allowed-destination mask
    lead_ok: torch.Tensor  # bool[B]
    topic_movable: torch.Tensor  # bool[T]
    host_multi: torch.Tensor  # bool[H]
    host_cap: torch.Tensor  # f32[H, 4]
    total_cap: torch.Tensor  # f32[4]
    #: the generation's values on the device (kernels/move_delta.py
    #: `Generation`), which the kernels and the engine's PyTorch ops read
    gen: md.Generation
    #: broker ids grouped by host (stable), brokers with no host in range
    #: last, and the i32[H + 2] group offsets: apply_moves' walk over the
    #: brokers of a host that holds several
    host_brokers: torch.Tensor
    host_start: torch.Tensor
    #: i32[2, B] scratch of apply_moves (each broker's surviving src and
    #: dst row), -1 between calls, and f32[2, B, 8] beside it (the slot's
    #: event: its load row, pot, leader bytes-in and disk)
    apply_slots: torch.Tensor
    apply_events: torch.Tensor
    #: valid brokers grouped by host (the rest by the sentinel H): the
    #: refresh's host pass
    host_groups: HostGroups
    #: f32[T, B] per-source-topic inclusive CDF over destination positions
    #: (the learned prior; 1.0 from n_dest on), f32[1, 1] zeros when the
    #: engine has no prior; and the f32[1] mix.  Fixed tensors: a new
    #: prior is copied into them (`Engine.rebind_prior`)
    prior_cdf: torch.Tensor
    prior_mix: torch.Tensor

    def check_placement(self, placement) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A (replica_broker, replica_is_leader, replica_disk) triple of
        this cluster's shape, dtypes and device, or ValueError."""
        st = self.state
        try:
            rb, il, dk = placement
        except (TypeError, ValueError):
            raise ValueError("initial_placement must be a (replica_broker, replica_is_leader, "
                             "replica_disk) triple") from None
        for name, t, want in (("replica_broker", rb, st.replica_broker),
                              ("replica_is_leader", il, st.replica_is_leader),
                              ("replica_disk", dk, st.replica_disk)):
            if not isinstance(t, torch.Tensor):
                raise ValueError(f"initial_placement: {name} must be a tensor, got {type(t).__name__}")
            if t.dtype != want.dtype or t.shape != want.shape or t.device != want.device:
                raise ValueError(
                    f"initial_placement: {name} must be {want.dtype}{list(want.shape)} on "
                    f"{want.device}, got {t.dtype}{list(t.shape)} on {t.device}")
        return rb, il, dk


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
    state: ClusterState, max_rf: int | None = None, *, host: dict | None = None
) -> np.ndarray:
    """i32[P, max_rf] replica indices per partition, padded with R (host
    numpy; the JAX package's engine.py `partition_replica_table`).

    `max_rf` forces a table width (None: the most valid replicas of one
    partition).  `host` supplies numpy copies of `replica_valid`,
    `replica_partition` and `replica_pos` already fetched; without it the
    three are read from the state's device.  Unlike `replica_members`, a
    narrow forced width keeps the JAX semantics (a later row overwrites
    its cell) instead of raising.
    """
    if host is None:
        host = {f: getattr(state, f).cpu().numpy()
                for f in ("replica_valid", "replica_partition", "replica_pos")}
    return member_table(host["replica_valid"], host["replica_partition"],
                        host["replica_pos"], state.shape, max_rf)


def _prior_fields(prior, T: int, B: int, dest_idx: np.ndarray) -> tuple[np.ndarray, float]:
    """(prior_cdf f32[T, B], prior_mix) from a duck-typed prior (`.weights`
    f32[T, B] in broker-id space, `.mix` float) and the real destination
    list `dest_idx`: the prior's weights moved onto destination positions,
    normalised per topic (uniform over the real destinations for a topic
    with no weight), as inclusive CDFs; 1.0 from n_dest on.  The JAX
    package's `_prior_fields`."""
    n_dest_int = int(dest_idx.size)
    prior_cdf = np.ones((T, B), np.float32)
    w = None if prior is None else getattr(prior, "weights", None)
    if w is not None:
        w = np.asarray(w, np.float32)
        if w.shape != (T, B):
            raise ValueError(f"prior weights shape {w.shape} != model (T={T}, B={B})")
        w_pos = np.maximum(w[:, dest_idx], 0.0)  # [T, n_dest]
    else:
        w_pos = np.zeros((T, n_dest_int), np.float32)
    tot = w_pos.sum(1, keepdims=True)
    uni = np.full((T, n_dest_int), 1.0 / max(1, n_dest_int), np.float32)
    probs = np.where(tot > 0.0, w_pos / np.maximum(tot, 1e-12), uni)
    prior_cdf[:, :n_dest_int] = np.cumsum(probs, axis=1)
    prior_mix = float(getattr(prior, "mix", 0.0)) if prior is not None else 0.0
    if not 0.0 <= prior_mix <= 1.0:
        raise ValueError(f"prior mix must be in [0, 1], got {prior_mix}")
    return prior_cdf, prior_mix


def build_statics(state: ClusterState, options: OptimizationOptions, *, prior=None,
                  prior_full_shape: bool = False, layout_out: dict | None = None,
                  loads: tuple[torch.Tensor, torch.Tensor] | None = None,
                  cap_weights=None, out: EngineStatics | None = None) -> EngineStatics:
    """Host-side (numpy) preprocessing of one model generation.

    `loads`, an engine's own (leader, follower) pair of f32[R, 4] tensors,
    receives the state's load columns (copied last, after every check),
    and the statics' state is the engine's own: its other fields are
    copies of the caller's tensors, so a later generation can be copied
    into the same tensors while the caller's stay as they are.  Without
    it the statics hold the caller's state as it is.

    `out`, an engine's current statics, receives the generation in place:
    every tensor of it (its state's with `loads`, the generation block,
    the host grouping) is refilled in stream order, and the returned
    statics hold those same tensors with this generation's state, so
    graphs captured on `out` run the new generation.  Where the member
    table's width (the generation's max_rf, which its shape does not fix)
    differs from out's, nothing is refilled and new tensors are allocated:
    the caller's graphs cannot serve it.  `cap_weights`, the chain's
    capacity-goal weights by resource, enter the generation block (zeros
    when None).

    `prior` (`.weights` f32[T, B] on this generation's topic ids, `.mix`)
    is the learned move-acceptance prior, moved onto destination positions
    here; without `prior_full_shape` (an engine with prior_enabled=False)
    the statics carry an f32[1, 1] placeholder and mix 0.  `layout_out`,
    when given, receives the real destination list ("dest_idx") that a
    later prior refresh needs (`Engine.rebind_prior`)."""
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
    # padding brokers (broker_valid False) hold no replica: no host of theirs
    host_group = np.where(valid_b & (host >= 0) & (host < s.num_hosts), host, s.num_hosts)
    host_start = np.zeros(s.num_hosts + 2, np.int32)
    host_start[1:] = np.cumsum(np.bincount(host_group, minlength=s.num_hosts + 1))
    front_packed = bool(h["replica_valid"][:n_valid_int].all())
    n_source = n_valid_int if front_packed else s.R
    if layout_out is not None:
        layout_out["dest_idx"] = dest_idx
    if prior_full_shape:
        prior_cdf, prior_mix = _prior_fields(prior, s.num_topics, s.B, dest_idx)
    else:
        prior_cdf, prior_mix = np.zeros((1, 1), np.float32), 0.0

    members = replica_members(h["replica_valid"], h["replica_partition"], h["replica_pos"], s)
    total_cap = ((cap * alive[:, None]).sum(0) + np.float32(1e-12)).astype(np.float32)
    words = md.Generation.host_words(
        cap_weights, total_cap,
        n_alive=float(np.float32(max(1.0, float(alive.sum())))),
        n_valid=float(np.float32(max(1.0, float(n_valid_int)))),
        total_disk_cap=float(np.float32((h["disk_capacity"] * dmask).sum() + 1e-12)),
        n_source=max(1, n_source),
        n_dest=int(dest_idx.size),
        n_brokers=max(1, int(valid_b.sum())),
        shared_hosts=bool((np.diff(host_start)[:s.num_hosts] > 1).any()),
    )
    arrays = dict(
        part_replicas=members,
        alive=alive,
        dest_ids=dest_pad.astype(np.int32),
        dest_ok=dest,
        lead_ok=alive & options.leadership_allowed(state),
        topic_movable=options.topic_movable(state),
        host_multi=bph > 1,
        host_cap=host_cap,
        total_cap=total_cap,
        host_brokers=np.argsort(host_group, kind="stable").astype(np.int32),
        host_start=host_start,
        prior_cdf=prior_cdf,
        prior_mix=np.asarray([prior_mix], np.float32),
    )
    if out is not None and tuple(out.part_replicas.shape) == members.shape:
        for name, a in arrays.items():
            getattr(out, name).copy_(torch.from_numpy(np.ascontiguousarray(a)))
        if loads is not None:
            state = _own_state(state, loads, out.state)
            vars(state)["members"] = out.part_replicas  # the cached_property's slot
        out.gen.write(words)
        HostGroups.of(state.broker_valid, state.broker_host, s.num_hosts, out=out.host_groups)
        return dataclasses.replace(out, state=state)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    tensors = {name: t(a) for name, a in arrays.items()}
    if loads is not None:
        state = _own_state(state, loads)
        vars(state)["members"] = tensors["part_replicas"]  # the cached_property's slot
    gen = md.Generation.empty(dev)
    gen.write(words)
    return EngineStatics(
        state=state,
        **tensors,
        gen=gen,
        apply_slots=torch.full((2, s.B), -1, dtype=torch.int32, device=dev),
        apply_events=torch.zeros((2, s.B, 8), dtype=torch.float32, device=dev),
        host_groups=HostGroups.of(state.broker_valid, state.broker_host, s.num_hosts),
    )


def _own_state(state: ClusterState, loads, into: ClusterState | None = None) -> ClusterState:
    """`state`'s fields in tensors of the engine's own, in stream order:
    its load columns in `loads`, every other field in `into`'s tensors
    (copies of the caller's when None).  A new ClusterState on those
    tensors, whose member table is left to the statics' (`part_replicas`)."""
    own = {}
    for f in STATE_FIELDS:
        src = getattr(state, f)
        if f in LOAD_FIELDS:
            dst = loads[LOAD_FIELDS.index(f)]
            dst.copy_(src)
        elif into is None:
            dst = src.clone()
        else:
            dst = getattr(into, f)
            dst.copy_(src)
        own[f] = dst
    return dataclasses.replace(state, **own)


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

#: cap on a segmented run's rounds per slice (the JAX package's
#: SEGMENT_MAX_ROUNDS): slice lengths grow in powers of two up to it
SEGMENT_MAX_ROUNDS = 64


@dataclasses.dataclass
class CarryCheckpoint:
    """Host snapshot of a segmented run at a slice boundary (the JAX
    package's CarryCheckpoint): the next round index, the carry's tensors
    and the rest of the run's state (`Engine._run_state`: the schedule,
    the plan, the grouping, the step globals, the select minima and the
    reports) as numpy arrays that own their memory, and the per-round ys
    rows of the slices fetched so far.  Taken while the device is idle
    (the slice's sync), so the copy races nothing, and never changed by
    the slices that follow."""

    base: int
    carry: dict
    seg: dict
    ys_parts: list
    n_chains: int = 1
    meta: dict = dataclasses.field(default_factory=dict)


class SegmentContext:
    """A request to run the fused anneal preemptibly (the JAX package's
    SegmentContext; the device scheduler's bounded-wall preemption,
    fleet/scheduler.py).

    `slice_budget_s` bounds each slice's wall: the engine sizes its slices
    so one stays within it.  `checkpoint` is called between slices on the
    run's thread; the scheduler pauses the run there while an URGENT
    request takes the device, so an urgent anneal waits on at most one
    slice of background work.  The callback may block; when it returns,
    the run resumes, bit for bit.  A checkpoint that pauses wraps its wait
    in `paused()`: the engine's hooks (`holding`) let go of the engine
    there, so a preempting run on the same engine can take it, and take it
    back after.

    Fault tolerance rides the same boundaries: with `snapshot_every` > 0
    and a `snapshot_sink`, every Nth boundary captures a CarryCheckpoint
    (the engine's `capture` thunk) and hands it to the sink on a background
    thread, at most one persist in flight (a due snapshot is skipped, not
    queued, while the previous one persists).  The capture's wall feeds
    `checkpoint_clock`.  `snapshot_every=0` (the default) costs one
    predicate a boundary."""

    __slots__ = (
        "slice_budget_s", "checkpoint", "snapshot_every", "snapshot_sink",
        "checkpoint_clock", "snapshots_taken", "snapshots_skipped",
        "snapshot_seconds", "_snapshot_boundary", "_snapshot_worker",
        "_snapshot_lock", "_hooks",
    )

    def __init__(self, slice_budget_s: float, checkpoint=None, *, snapshot_every: int = 0,
                 snapshot_sink=None, checkpoint_clock=None):
        self.slice_budget_s = slice_budget_s
        self.checkpoint = checkpoint
        self.snapshot_every = int(snapshot_every)
        self.snapshot_sink = snapshot_sink
        self.checkpoint_clock = checkpoint_clock
        self.snapshots_taken = 0
        self.snapshots_skipped = 0
        self.snapshot_seconds = 0.0
        self._snapshot_boundary = 0
        self._snapshot_worker = None
        self._snapshot_lock = threading.Lock()
        self._hooks = None

    @contextlib.contextmanager
    def holding(self, let_go, take_back):
        """The engine's pause hooks for the enclosed checkpoint call:
        `let_go()` runs when the checkpoint pauses, before it yields the
        device, and returns a token; `take_back(token)` runs when the pause
        ends."""
        self._hooks = (let_go, take_back)
        try:
            yield
        finally:
            self._hooks = None

    @contextlib.contextmanager
    def paused(self):
        """Wrap a checkpoint's pause: the run lets go of its engine on
        entry and takes it back on exit (no-ops outside `holding`)."""
        hooks = self._hooks
        token = hooks[0]() if hooks is not None else None
        try:
            yield
        finally:
            if hooks is not None:
                hooks[1](token)

    def offer_snapshot(self, capture) -> None:
        """Engine hook at a slice boundary (device idle): maybe capture a
        CarryCheckpoint with `capture()` and persist it in the background."""
        if self.snapshot_every <= 0 or self.snapshot_sink is None:
            return
        with self._snapshot_lock:
            self._snapshot_boundary += 1
            if self._snapshot_boundary % self.snapshot_every:
                return
            worker = self._snapshot_worker
            if worker is not None and worker.is_alive():
                # one snapshot in flight: skip, never queue
                self.snapshots_skipped += 1
                return
            t0 = time.monotonic()
            payload = capture()
            sink = self.snapshot_sink

            def persist():
                try:
                    sink(payload)
                except Exception:  # noqa: BLE001 -- a checkpoint must never end the run
                    log.warning("carry snapshot sink failed", exc_info=True)

            worker = threading.Thread(target=persist, daemon=True, name="carry-snapshot")
            self._snapshot_worker = worker
            worker.start()
            dt = time.monotonic() - t0
            self.snapshots_taken += 1
            self.snapshot_seconds += dt
            if self.checkpoint_clock is not None:
                self.checkpoint_clock.add(dt)

    def wait_snapshot(self, timeout_s: float = 10.0) -> None:
        """Block until a persist in flight finishes; never raises."""
        worker = self._snapshot_worker
        if worker is not None:
            worker.join(timeout_s)


#: the ambient segmented-execution request, set by the device scheduler
#: around a granted non-urgent dispatch.  A contextvar, so it survives a
#: hop to a worker thread that runs with a copy of the caller's context.
#: None (the default) keeps every run on the one-launch fused route.
_SEGMENT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "cc-torch-engine-segment-context", default=None
)


def current_segment_context() -> SegmentContext | None:
    return _SEGMENT_CTX.get()


@contextlib.contextmanager
def segmented_execution(ctx: SegmentContext):
    """Run the enclosed engine runs in wall-bounded preemptible slices:
    `Engine.run` and `Engine.run_reported` on the fused route honour it;
    verbose runs, the legacy route and the streaming cycle ignore it."""
    token = _SEGMENT_CTX.set(ctx)
    try:
        yield
    finally:
        _SEGMENT_CTX.reset(token)


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum accumulated in f32, the same bits in every
    run.  On the CPU element after element: PyTorch's CPU cumsum
    accumulates in f64, which rounds differently from the reference's f32
    scan; numpy's f32 cumsum is the sequential f32 sum.  On CUDA
    `scan_fixed_order`: PyTorch's cumsum of a vector there is a single-pass
    scan (decoupled look-back) in which a tile adds the prefix of the
    tiles before it from whichever of their sums is published first, so
    over more than one tile its bits may change from run to run; the
    broker CDF's did at 25,000 brokers."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.cumsum(x.numpy(), dtype=np.float32))
    return scan_fixed_order(x)


def scan_fixed_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a vector in an order fixed by each index:
    ceil(log2 n) passes of elementwise adds, y[i] += y[i - 2^k] (Hillis and
    Steele), so element i's sum depends on x[:i + 1] alone, then a running
    maximum (exact in any order), so that a vector of non-negative terms
    gives a nondecreasing result, as a binary search over a CDF needs."""
    y, nxt = x.clone(), torch.empty_like(x)
    off, n = 1, x.numel()
    while off < n:
        nxt[:off].copy_(y[:off])
        torch.add(y[off:], y[:-off], out=nxt[off:])
        y, nxt = nxt, y
        off *= 2
    return torch.cummax(y, 0).values


def _placed_state(base: ClusterState, replica_broker, replica_is_leader,
                  replica_disk) -> ClusterState:
    """`base` with another placement, and the replica_offline it implies."""
    offline = ~(base.broker_alive[replica_broker] & base.disk_alive[replica_broker, replica_disk])
    return dataclasses.replace(
        base,
        replica_broker=replica_broker,
        replica_is_leader=replica_is_leader,
        replica_disk=replica_disk,
        replica_offline=offline & base.replica_valid,
    )


def _report_width(n_goals: int) -> int:
    """Floats of one report row: the objective, the violations, REPORT_STATS."""
    return 1 + n_goals + sum(n for _, n in REPORT_STATS)


@dataclasses.dataclass
class _Workspace:
    """The fixed buffers of a run, allocated once per engine and kept
    across the model generations it is bound to: every kernel and every
    captured graph reads and writes these."""

    carry: EngineCarry
    plan: SamplingPlan  # its order/start/count are `group`'s tensors
    group: Grouping  # the replica rows grouped by the carry's brokers
    gbuf: torch.Tensor  # the step's globals (kernels/step_globals.py)
    sched: sched_k.Schedule
    keys: torch.Tensor  # the run's key table, i32[steps, KEY_WORDS]
    #: the prior draws' keys of each step, i32[steps, PRIOR_KEY_WORDS], or None
    prior_keys: torch.Tensor | None
    cand: dict | None  # the candidates kernel's outputs (CUDA)
    sel: select_k.SelectBuffers | None  # select_survivors' buffers (CUDA)
    #: the run's start placement (replica_broker, replica_is_leader,
    #: replica_disk), which the init reads: the statics' placement on a cold
    #: start, the caller's on a warm one, copied in before the run
    start: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    #: the streaming window's staging, capacity R: i32[R] rows, f32[R, 4]
    #: leader and follower rows and the i32[1] count n, which the scatter
    #: reads on the device (n = 0 on a run without a window)
    delta: dict
    #: the reports: f32[2, 1 + G + 19], the before and after rows (the
    #: objective, the per-goal violations, REPORT_STATS), i32[5] device
    #: checks of the final placement, its bool[R] replica_offline and the
    #: f32[R] disk bytes of the (scattered) leader loads
    report: torch.Tensor
    checks: torch.Tensor
    offline: torch.Tensor
    disk_bytes: torch.Tensor
    #: captured CUDA graphs by name, their launches per replay, and the
    #: loop graphs by verbose flag
    graphs: dict = dataclasses.field(default_factory=dict)
    graph_launches: dict = dataclasses.field(default_factory=dict)
    loops: dict = dataclasses.field(default_factory=dict)
    ys_host: torch.Tensor | None = None  # pinned host copy of the ys
    count_host: torch.Tensor | None = None  # pinned host copy of the loop's counters
    si_host: torch.Tensor | None = None  # pinned host copy of the schedule's int state
    #: host copies of the reported run's payload (pinned on CUDA),
    #: allocated by the first reported run
    payload_host: dict | None = None
    #: a segmented run's slice graphs (the loop graph without init) by
    #: reports flag, instantiated once each over the captured graphs
    slices: dict = dataclasses.field(default_factory=dict)
    #: device copies of a segmented run's state (`Engine._run_state`),
    #: made where a checkpoint pauses it, allocated by the first such pause
    stash: dict | None = None

    def close(self) -> None:
        with kernels.graph_lock():
            for lg in (*self.loops.values(), *self.slices.values()):
                lg.close()
            self.loops.clear()
            self.slices.clear()
            self.graphs.clear()


class _WarmPool:
    """The process's warm pool: engines' graph captures run ahead of use on
    one daemon worker thread, in (priority, submission) order, lower
    priority values first (the JAX package's `_WarmPool`).  One worker is
    all it can use: every capture of the package runs under
    `kernels.capture`'s process lock, one at a time.  A daemon thread: a
    capture stuck on the device never blocks the interpreter's exit.  A
    thunk's error is set on its Future, which the engine's next rebind or
    run raises."""

    def __init__(self):
        self._cond = threading.Condition()
        self._heap: list = []
        self._seq = itertools.count()
        self._worker: threading.Thread | None = None

    def submit(self, thunk, *, priority: int = 0) -> concurrent.futures.Future:
        fut = concurrent.futures.Future()
        with self._cond:
            heapq.heappush(self._heap, (priority, next(self._seq), fut, thunk))
            if self._worker is None:
                self._worker = threading.Thread(target=self._work, daemon=True, name="engine-warm")
                self._worker.start()
            self._cond.notify()
        return fut

    def _work(self) -> None:
        while True:
            with self._cond:
                while not self._heap:
                    self._cond.wait()
                _, _, fut, thunk = heapq.heappop(self._heap)
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(thunk())
                except BaseException as e:  # noqa: BLE001 -- raised by the waiting run
                    fut.set_exception(e)


_WARM_POOL = _WarmPool()


def warm_pool_submit(thunk, *, priority: int = 0) -> concurrent.futures.Future:
    """Run `thunk` on the shared warm pool; returns its Future."""
    return _WARM_POOL.submit(thunk, priority=priority)


class Engine:
    """Optimization engine bound to one ClusterShape and device.

    Reuse one Engine across model generations of the same shape with
    `rebind(state)`; `prior` (prior_enabled engines) is the learned
    move-acceptance prior (`.weights` f32[T, B], `.mix`), refreshed by
    `rebind(prior=)` or `rebind_prior`.  The engine keeps the bound
    state's fields, its statics and its generation block in tensors of its
    own, which its graphs read and each rebind refills; no state it
    returns holds them.  `precompile_async` captures the graphs on the
    warm pool before the first run needs them.
    """

    def __init__(
        self,
        state: ClusterState,
        chain: GoalChain,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        options: OptimizationOptions = DEFAULT_OPTIONS,
        config: OptimizerConfig = OptimizerConfig(),
        prior=None,
    ):
        self.chain = chain
        self.constraint = constraint
        self.config = config
        self.w = _Weights.from_chain(chain)
        self.shape: ClusterShape = state.shape
        self.device = state.device
        # effective candidate split: leadership + swap carved out of K; swaps
        # never take more than half the non-leadership budget; disk
        # rebalancing draws intra-broker disk moves only
        if config.intra_broker:
            self.K_l, self.K_s, self.K_r = 0, 0, config.num_candidates
        else:
            self.K_l = min(config.leadership_candidates, config.num_candidates - 1)
            self.K_s = min(config.swap_candidates, max(0, (config.num_candidates - self.K_l) // 2))
            self.K_r = config.num_candidates - self.K_l - self.K_s
        self._chain_w = torch.tensor(chain.weights, dtype=torch.float32, device=self.device)
        self.tp = md.TermParams.build(self.w, constraint, bf16=config.score_dtype == "bfloat16")
        self.cand = cand_k.CandParams(
            tp=self.tp, K_r=self.K_r, K_s=self.K_s, K_l=self.K_l,
            w_rack=self.w.rack, w_offline=self.w.offline, w_topic=self.w.topic_dist,
            w_pref=self.w.pref_leader,
            topic_tt=constraint.topic_replica_count_balance_threshold,
            replica_move_cost=config.replica_move_cost,
            leadership_move_cost=config.leadership_move_cost,
            importance_fraction=config.importance_fraction, num_parts=max(1, self.shape.P),
            intra=config.intra_broker, prior=config.prior_enabled and not config.intra_broker,
        )
        self._ws: _Workspace | None = None
        self.statics: EngineStatics | None = None
        #: the engine's own load tables (leader, follower), f32[R, 4]: each
        #: generation's loads are copied in (`build_statics(loads=)`)
        self._loads = tuple(torch.empty((state.shape.R, NUM_RESOURCES), dtype=torch.float32,
                                        device=self.device) for _ in LOAD_FIELDS)
        #: the caller's state of the current generation: results carry its
        #: tensors, never the engine's load tables
        self._state: ClusterState | None = None
        #: host staging of a streaming window (pinned on CUDA), allocated by
        #: the engine's first cycle and kept across model generations
        self._delta_host: dict | None = None
        #: the real destination list of the current statics (rebind_prior)
        self._dest_idx: np.ndarray | None = None
        #: capture and graph statistics of the engine's graphs
        self.graph_stats: dict = {}
        #: the warm pool's capture of this engine's graphs (a Future), once
        #: `precompile_async` submitted it; every rebind and run waits for it
        self._warm = None
        #: called as (seconds, source) after each capture: the optimizer's
        #: per-bucket attribution
        self.on_capture = None
        #: the run lock of callers that share the engine (`locked`), which
        #: a segmented run paused at a checkpoint lets go of
        self.run_lock = threading.Lock()
        self._run_owner: int | None = None
        #: rebinds and runs so far: a paused run that finds it moved on
        #: restores its own generation and state
        self._uses = 0
        #: the last rebind's (state, options, prior)
        self._bound_args: tuple | None = None
        self.rebind(state, options, prior=prior)

    @property
    def max_rf(self) -> int:
        """The member table's width: with the shape, what sizes the graphs."""
        return int(self.statics.part_replicas.shape[1])

    def rebind(self, state: ClusterState, options: OptimizationOptions = DEFAULT_OPTIONS,
               prior=None) -> "Engine":
        """Swap in a new model generation of the same shape: its state, its
        statics, its generation block, the prior (a cold one when None) and
        the loads are copied into the engine's own tensors in stream
        order, so the graphs captured on them run the new generation with
        no capture.  Only a generation whose member table is wider or
        narrower (another max_rf, which the shape does not fix) releases
        the graphs and buffers: the next run captures anew.  Waits first
        for a capture in flight on the warm pool, and raises its error."""
        if state.shape != self.shape:
            raise ValueError(f"shape changed {self.shape} -> {state.shape}; build a new Engine")
        if state.device != self.device:
            raise ValueError(f"state is on {state.device}, the engine on {self.device}")
        self._wait_warm()
        layout: dict = {}
        statics = build_statics(state, options, prior=prior,
                                prior_full_shape=self.config.prior_enabled, layout_out=layout,
                                loads=self._loads, cap_weights=self.w.cap, out=self.statics)
        if self.statics is not None and statics.part_replicas is not self.statics.part_replicas:
            self.release()
        self._uses += 1
        self._bound_args = (state, options, prior)
        self._dest_idx = layout["dest_idx"]
        self._state = state
        self.statics = statics
        return self

    def bound_to(self, state: ClusterState, options: OptimizationOptions) -> bool:
        """True when the last rebind was of `state`'s generation under
        equal `options`: the same tensors in every field but the two load
        tables (a streaming cycle passes the loads itself) and the same
        option masks.  Another cluster of the bucket, a re-flatten of this
        one, or a request with options of its own rebinds the engine, and
        then this is False.  Ask under the run lock (`locked`), so that no
        rebind comes between the answer and the run."""
        bound, bound_options, _ = self._bound_args
        if any(getattr(bound, f.name) is not getattr(state, f.name)
               for f in dataclasses.fields(state)
               if f.name not in ("replica_load_leader", "replica_load_follower")):
            return False
        if bound_options is options:
            return True
        for f in dataclasses.fields(options):
            a, b = getattr(bound_options, f.name), getattr(options, f.name)
            if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
                return False
        return True

    def rebind_prior(self, prior) -> None:
        """Refresh only the learned prior (the streaming controller's
        per-window refresh): its CDF and mix, computed on the host from the
        current statics' destination list, copied into the statics' fixed
        tensors in stream order.  No statics are rebuilt and no graph is
        captured.  A no-op without prior_enabled or without a prior."""
        if not self.config.prior_enabled or prior is None:
            return
        cdf, mix = _prior_fields(prior, self.shape.num_topics, self.shape.B, self._dest_idx)
        self.statics.prior_cdf.copy_(torch.from_numpy(cdf))
        self.statics.prior_mix.fill_(float(np.float32(mix)))

    def precompile_async(self, *, priority: int = 0) -> None:
        """Capture the engine's graphs ahead of use on the warm pool (the
        JAX package's `precompile_async`): on a worker thread, on a stream
        of its own, the init, full check, round body and the reported
        run's `pre` and `post` graphs and the loop graph, as the first
        `optimize` or streaming cycle of the engine needs them.  A rebind
        or run that comes while the capture is in flight waits for it and
        captures nothing itself; an error of the capture is raised to it.
        On the CPU there is nothing to capture: the worker only allocates
        the run's buffers.  `priority` orders the capture on the shared
        pool (lower first).  Once per engine."""
        if self._warm is None:
            self._warm = warm_pool_submit(self._warm_up, priority=priority)

    def _warm_up(self) -> None:
        """The warm pool's work for this engine (`precompile_async`)."""
        if self.device.type != "cuda":
            self._workspace()
            return
        with torch.cuda.device(self.device):
            self._capture(self._workspace(), False, reports=True, source="prewarm")

    def _wait_warm(self) -> None:
        """Wait for the warm pool's capture of this engine, if one was
        submitted; raise its error (every time: the engine's graphs were
        never made)."""
        if self._warm is not None:
            self._warm.result()

    @contextlib.contextmanager
    def locked(self):
        """Hold the engine's run lock for the block: callers that share the
        engine (the optimizer's threads) take it around each rebind and
        run.  A segmented run of the holding thread that a checkpoint
        pauses lets go of it for the pause (`_run_segmented`)."""
        with self.run_lock:
            self._run_owner = threading.get_ident()
            try:
                yield self
            finally:
                self._run_owner = None

    def release(self) -> None:
        """Free the run's buffers and captured graphs (after a capture in
        flight on the warm pool, whose error it leaves to the next run)."""
        if self._warm is not None:
            concurrent.futures.wait([self._warm])
            if self._warm.exception() is not None:
                log.warning("engine released after its warm-pool capture failed",
                            exc_info=self._warm.exception())
            self._warm = None
        if self._ws is not None:
            self._ws.close()
            self._ws = None
        self.graph_stats = {}

    # ------------------------------------------------------------------
    # state <-> carry
    # ------------------------------------------------------------------

    def _empty_carry(self, key: Key) -> EngineCarry:
        st = self.statics.state
        return EngineCarry(
            key=key, replica_broker=torch.empty_like(st.replica_broker),
            replica_is_leader=torch.empty_like(st.replica_is_leader),
            replica_disk=torch.empty_like(st.replica_disk),
            host_load=torch.empty((self.shape.num_hosts, NUM_RESOURCES), dtype=torch.float32,
                                  device=self.device),
            **empty_aggregates(st),
        )

    def _statics_placement(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        st = self.statics.state
        return st.replica_broker, st.replica_is_leader, st.replica_disk

    def _reset_carry(self, carry: EngineCarry, group: Grouping | None = None,
                     placement=None) -> EngineCarry:
        """`placement` (the statics' when None) copied into `carry`, with
        its aggregates."""
        rb, il, dk = placement if placement is not None else self._statics_placement()
        carry.replica_broker.copy_(rb)
        carry.replica_is_leader.copy_(il)
        carry.replica_disk.copy_(dk)
        return self.refresh(carry, group)

    def init_carry(self, key: Key) -> EngineCarry:
        """Carry seeded from the statics' placement, with aggregates
        computed from it."""
        return self._reset_carry(self._empty_carry(key))

    def init_carry_from(self, key: Key, placement) -> EngineCarry:
        """Carry seeded from another placement (replica_broker,
        replica_is_leader, replica_disk), with aggregates computed from it:
        a warm start.  The statics keep the cluster's current placement, so
        movement pricing still charges strays against what the executor
        would have to move.  The placement is copied, never aliased."""
        return self._reset_carry(self._empty_carry(key),
                                 placement=self.statics.check_placement(placement))

    def carry_to_state(self, carry: EngineCarry) -> ClusterState:
        """The bound (caller's) state with the carry's placement (the
        carry's own tensors)."""
        return _placed_state(self._state, carry.replica_broker, carry.replica_is_leader,
                             carry.replica_disk)

    def _carry_view(self, carry: EngineCarry) -> ClusterState:
        """The statics' state, whose loads are the engine's own tensors,
        with the carry's placement: what the engine's graphs read."""
        return _placed_state(self.statics.state, carry.replica_broker, carry.replica_is_leader,
                             carry.replica_disk)

    def refresh(self, carry: EngineCarry, group: Grouping | None = None) -> EngineCarry:
        """Recompute every aggregate of the carry from its placement, in
        place (group_by_broker then refresh_aggregates).  `group`, when
        given, receives the placement's grouping by broker (the plan's
        order/start/count)."""
        sx = self.statics
        st = sx.state
        group = group_placement(carry.replica_broker, st.replica_valid, self.shape.B, out=group)
        refresh_aggregates(st, carry.replica_broker, carry.replica_is_leader, carry.replica_disk,
                           carry.aggregates(), hosts=sx.host_groups, group=group,
                           members=sx.part_replicas)
        return carry

    # ------------------------------------------------------------------
    # objective views
    # ------------------------------------------------------------------

    def _broker_terms(self, b, load, rcount, lcount, pot, lbin, g):
        return md.broker_terms(self.tp, self.statics, b, load, rcount, lcount, pot, lbin, g)

    def _tie_term(self, pct_sum, pct_sumsq):
        return md.tie_term(self.tp, self.statics.gen, pct_sum, pct_sumsq)

    def _globals(self, carry: EngineCarry, out: torch.Tensor | None = None) -> dict:
        """Per-step frozen global scalars, O(B + T*B) from the aggregates
        (the step_globals kernel), as named views of `out`."""
        return glob_k.step_globals(self.statics, carry, out)

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
        # the partition and replica rows' sums: over the model axis in the
        # sharded-model mode (common/collectives.py), plain sums otherwise
        rack = gsum(torch.clamp(carry.part_rack_count - 1, min=0)).to(torch.float32)
        terms = terms + md.div(self.w.rack * rack, sx.gen, "n_valid")
        st = sx.state
        offline = gsum(
            st.replica_valid
            & ~(
                st.broker_alive[carry.replica_broker]
                & st.disk_alive[carry.replica_broker, carry.replica_disk]
            )
        ).to(torch.float32)
        terms = terms + md.div(self.w.offline * offline, sx.gen, "n_valid")
        return terms + self._tie_term(g["pct_sum"], g["pct_sumsq"])

    def cheap_violations(self, carry: EngineCarry, g=None) -> torch.Tensor:
        """O(B) lower-bound signal: the delta-decomposed objective minus the
        dispersion tiebreaker.  It misses goals folded into candidate deltas
        only (topic distribution), so `run` uses it to gate the
        authoritative full-chain check."""
        if g is None:
            g = self._globals(carry)
        return self.carry_objective(carry, g) - self._tie_term(g["pct_sum"], g["pct_sumsq"])

    def evaluate(self, carry: EngineCarry):
        """(full objective, per-goal violation vector f32[G]) of the carry,
        scored by the goal chain against the carry's aggregates."""
        agg = BrokerAggregates(**{f: getattr(carry, f) for f in AGG_FIELDS})
        obj, viol, _ = self.chain.evaluate(
            self._carry_view(carry), agg=agg, constraint=self.constraint, weights=self._chain_w,
            score_dtype=self.config.score_dtype,
        )
        return obj, viol

    def _empty_plan(self, group: Grouping) -> SamplingPlan:
        def scalar():
            return torch.zeros((), dtype=torch.float32, device=self.device)

        return SamplingPlan(
            broker_cdf=torch.empty(self.shape.B, dtype=torch.float32, device=self.device),
            order=group.order, start=group.start, count=group.count,
            replica_cost=scalar(), lead_cost=scalar(),
        )

    def plan(self, carry: EngineCarry, g=None, out: SamplingPlan | None = None) -> SamplingPlan:
        """Importance-sampling + movement-pricing plan from the aggregates,
        written into `out` (new buffers when None).  With `out` given, its
        order/start/count must already hold the carry's grouping by broker
        (the refresh writes it there); without, it is computed here."""
        sx = self.statics
        st = sx.state
        if out is None:
            group = group_placement(carry.replica_broker, st.replica_valid, self.shape.B)
            out = self._empty_plan(group)
        if g is None:
            g = self._globals(carry)
        b = torch.arange(self.shape.B, device=self.device)
        w = self._broker_terms(
            b, carry.broker_load, carry.broker_replica_count, carry.broker_leader_count,
            carry.broker_potential_nw_out, carry.broker_leader_bytes_in, g,
        )
        # stranded replicas on dead brokers/disks carry the offline-goal mass
        dead = st.broker_valid & ~sx.alive
        w = w + md.div(self.w.offline * torch.where(
            dead, carry.broker_replica_count.to(torch.float32), 0.0
        ), sx.gen, "n_valid")
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
        unit = md.div(self.carry_objective(carry, g), sx.gen, "n_valid")
        out.broker_cdf.copy_(_cumsum_f32(probs))
        out.replica_cost.copy_(self.config.replica_move_cost * unit)
        out.lead_cost.copy_(self.config.leadership_move_cost * unit)
        return out

    # ------------------------------------------------------------------
    # step: propose + evaluate + accept -> select -> apply
    # ------------------------------------------------------------------

    def step(self, carry: EngineCarry, temperature: float, plan: SamplingPlan | None = None):
        """One anneal step at `temperature` (an f32 value) under the carry's
        key; updates `carry` in place and returns (carry, stats) with
        device-side counts.  (A run's steps read their keys and temperature
        from the device instead: `_step`.)"""
        keys = cand_k.StepKeys.of(carry.key, intra=self.config.intra_broker, prior=self.cand.prior)
        prop = cand_k.candidates(
            self.cand, self.statics, carry, keys, self._globals(carry), plan, temperature
        )
        return self.select_apply(carry, prop, keys.next)

    def select_apply(self, carry: EngineCarry, prop: dict, next_key: Key):
        """Conflict resolution + scatter of an accepted candidate bundle."""
        survive, accepted = self._survive_apply(carry, prop)
        carry.key = next_key
        delta, feas = prop["delta"], prop["feas"]
        stats = dict(
            accepted=accepted[0],
            improving=(feas & (delta < 0)).sum(),
            delta=torch.where(survive, delta, 0.0).sum(),
        )
        return carry, stats

    def _survive_apply(self, carry: EngineCarry, prop: dict, ws: _Workspace | None = None,
                       epoch: select_k.Epoch = select_k.Epoch()):
        """The survivors of a bundle, scattered into `carry`.  With the
        workspace, select_survivors writes into its buffers at `epoch` and
        adds the survivor count (with diagnostics, the six counts) into
        sched.acc.  Returns (survivor mask, the accumulator the count was
        added to)."""
        nr, ns = prop["nr"], prop["ns"]
        survive, sv_r, acc = select_k.select_survivors(
            prop["accept"], prop["delta"], prop["src"], prop["dst"], prop["part1"], prop["part2"],
            num_brokers=self.shape.B, num_parts=self.shape.P, n_r=nr, n_s=ns,
            acc=ws.sched.acc if ws else None, bufs=ws.sel if ws else None, epoch=epoch,
            from_prior=prop.get("from_prior"), diag=bool(ws and ws.sched.stage is not None),
        )
        apply_k.apply_moves(self.statics, carry, sv_r, prop["payr"], survive[nr + ns:], prop["payl"])
        return survive, acc

    def round_prep(self, ws: _Workspace) -> torch.Tensor:
        """Between rounds, on the workspace's carry: recompute the
        aggregates (wash float drift) and the grouping by broker, whose
        tensors the plan's order/start/count are, build the next round's
        sampling plan and return the cheap early-stop signal."""
        self.refresh(ws.carry, ws.group)
        g = self._globals(ws.carry, ws.gbuf)
        self.plan(ws.carry, g, ws.plan)
        return self.cheap_violations(ws.carry, g)

    # ------------------------------------------------------------------
    # the run's buffers and the pieces of a round, all in place
    # ------------------------------------------------------------------

    def _n_rounds(self) -> int:
        return self.config.num_rounds + self.config.extra_round_budget

    def _run_key(self) -> Key:
        """The key of a run's chain: PRNGKey(seed); a portfolio chain of the
        mesh layer has a key of its own (parallel/mesh.py)."""
        return Key.from_seed(self.config.seed)

    def _workspace(self) -> _Workspace:
        if self._ws is not None:
            return self._ws
        cfg, dev, s = self.config, self.device, self.shape
        total = self._n_rounds()
        table = torch.from_numpy(cand_k.key_table(
            self._run_key(), total * cfg.steps_per_round, intra=cfg.intra_broker,
            prior=self.cand.prior).view(np.int32))
        group = Grouping.empty(s.R, s.B, dev)
        cuda = dev.type == "cuda"
        K = self.K_r + self.K_s + self.K_l
        f32, i32 = torch.float32, torch.int32
        self._ws = _Workspace(
            carry=self._empty_carry(self._run_key()),
            plan=self._empty_plan(group),
            group=group,
            gbuf=torch.empty(glob_k.size(s.num_topics), dtype=torch.float32, device=dev),
            sched=sched_k.Schedule.create(total, cfg.temperature_decay, dev, diag=cfg.diagnostics,
                                          n_goals=len(self.chain.goals)),
            keys=table[:, :cand_k.KEY_WORDS].contiguous().to(dev),
            prior_keys=table[:, cand_k.KEY_WORDS:].contiguous().to(dev) if self.cand.prior else None,
            cand=cand_k.candidate_buffers(self.cand, dev) if cuda else None,
            sel=select_k.select_buffers(K, self.K_r, self.K_s, s.B, s.P, dev,
                                        n_epochs=total * cfg.steps_per_round) if cuda else None,
            start=tuple(t.clone() for t in self._statics_placement()),
            delta=dict(rows=torch.full((s.R,), s.R, dtype=i32, device=dev),
                       ll=torch.zeros((s.R, NUM_RESOURCES), dtype=f32, device=dev),
                       fl=torch.zeros((s.R, NUM_RESOURCES), dtype=f32, device=dev),
                       n=torch.zeros(1, dtype=i32, device=dev)),
            report=torch.zeros((2, _report_width(len(self.chain.goals))), dtype=f32, device=dev),
            checks=torch.zeros(5, dtype=i32, device=dev),
            offline=torch.zeros(s.R, dtype=torch.bool, device=dev),
            disk_bytes=torch.zeros(s.R, dtype=f32, device=dev),
        )
        return self._ws

    def _sched_dims(self, verbose: bool) -> sched_k.ScheduleDims:
        cfg = self.config
        return sched_k.ScheduleDims(
            n_main=cfg.num_rounds, total=self._n_rounds(), tol_on=cfg.early_stop_violations >= 0.0,
            checks=FULL_CHECK_BUDGET, verbose=verbose, tol=cfg.early_stop_tol,
            scale=float(np.float32(cfg.init_temperature_scale)), diag=cfg.diagnostics,
            n_goals=len(self.chain.goals),
        )

    def _stage(self, ws: _Workspace, initial_placement) -> None:
        """The run's start placement into the workspace's staging tensors:
        the statics' (cold start) or the caller's (warm start), by device
        copies ordered on the stream before the run."""
        src = (self._statics_placement() if initial_placement is None
               else self.statics.check_placement(initial_placement))
        for dst, t in zip(ws.start, src):
            dst.copy_(t)

    def _reset_run(self, ws: _Workspace) -> EngineCarry:
        """The staged start placement into the workspace's carry, with its
        aggregates; the select minima cleared, as the run's step epochs
        start over."""
        if ws.sel is not None:
            ws.sel.clear()
        return self._reset_carry(ws.carry, ws.group, ws.start)

    def _init_run(self, ws: _Workspace, dims: sched_k.ScheduleDims) -> None:
        """`_schedule_init`: the staged start placement into the carry with
        its aggregates, the initial objective, t0, the round-0 plan."""
        carry = self._reset_run(ws)
        ws.sched.value(sched_k.OBJ).copy_(self.evaluate(carry)[0])
        sched_k.round_schedule(sched_k.INIT, ws.sched, dims)
        self.plan(carry, self._globals(carry, ws.gbuf), ws.plan)

    def _full_check(self, ws: _Workspace) -> None:
        """The authoritative early-stop signal: the worst goal violation."""
        ws.sched.value(sched_k.FULL_V).copy_(self.evaluate(ws.carry)[1].max())

    def _objective(self, ws: _Workspace) -> None:
        ws.sched.value(sched_k.OBJ).copy_(self.evaluate(ws.carry)[0])

    def _stage_delta(self, ws: _Workspace, cycle) -> None:
        """The run's window into the workspace's staging tensors, ordered on
        the stream before the run: none (n = 0) without `cycle`; with it,
        (ll, fl, rows, new_ll, new_fl), the live load tensors are first
        copied into the engine's own (whatever generation they last held),
        then the window's n rows go up from (pinned) host memory without a
        blocking copy."""
        d = ws.delta
        if cycle is None:
            d["n"].zero_()
            return
        ll, fl, rows, new_ll, new_fl = cycle
        n = int(rows.size)
        for buf, t in zip(self._loads, (ll, fl)):
            buf.copy_(t)
        if self._delta_host is None:
            pin = self.device.type == "cuda"
            self._delta_host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                                for k, t in d.items()}
        h = self._delta_host
        h["n"][0] = n
        for k, a in (("rows", rows), ("ll", new_ll), ("fl", new_fl)):
            if n:
                h[k][:n].numpy()[...] = a
                d[k][:n].copy_(h[k][:n], non_blocking=True)
        d["n"].copy_(h["n"], non_blocking=True)

    def _report_row(self, st: ClusterState, row: torch.Tensor) -> None:
        """The f32 report of `st` (the optimizer's before and after
        reports: the objective and per-goal violations in f32 whatever the
        score dtype, then the cluster stats) into `row`."""
        agg = compute_aggregates(st, self.statics.part_replicas)
        obj, viol, _ = self.chain.evaluate(st, agg=agg, constraint=self.constraint,
                                           weights=self._chain_w)
        stats = compute_stats(st, agg)
        row.copy_(torch.cat([obj.reshape(1), viol,
                             *(getattr(stats, f).reshape(-1) for f, _ in REPORT_STATS)]))

    def _cycle_pre(self, ws: _Workspace) -> None:
        """The head of a reported run: the staged window scattered into the
        engine's load tables, then the before-report of the statics' state
        (the JAX package's `_cycle_impl`, up to the anneal)."""
        st, d = self.statics.state, ws.delta
        scatter_k.scatter_loads(st.replica_load_leader, st.replica_load_follower, d["rows"],
                                d["ll"], d["fl"], d["n"])
        self._report_row(st, ws.report[0])

    def _cycle_post(self, ws: _Workspace) -> None:
        """The tail of a reported run: the after-report and the device
        checks of the final placement, its replica_offline and the leader
        loads' disk bytes (the JAX package's `_cycle_impl` payload)."""
        final = self._carry_view(ws.carry)
        self._report_row(final, ws.report[1])
        ws.checks.copy_(validate_on_device(final))
        ws.offline.copy_(final.replica_offline)
        ws.disk_bytes.copy_(self.statics.state.replica_load_leader[:, int(Resource.DISK)])

    def _payload_sources(self, ws: _Workspace) -> dict:
        c = ws.carry
        return dict(report=ws.report, checks=ws.checks, replica_broker=c.replica_broker,
                    replica_is_leader=c.replica_is_leader, replica_disk=c.replica_disk,
                    replica_offline=ws.offline, replica_disk_bytes=ws.disk_bytes)

    def _payload_buffers(self, ws: _Workspace) -> dict:
        """The host buffers of the reported run's payload (pinned on CUDA),
        allocated once per workspace."""
        if ws.payload_host is None:
            pin = self.device.type == "cuda"
            ws.payload_host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                               for k, t in self._payload_sources(ws).items()}
        return ws.payload_host

    def _payload_to_host(self, ws: _Workspace) -> None:
        """Copies of the reported run's payload into host buffers (pinned,
        and not waited for, on CUDA), ordered on the stream after the run;
        read them with `_payload` once the stream is synchronised."""
        host = self._payload_buffers(ws)
        for k, t in self._payload_sources(ws).items():
            host[k].copy_(t, non_blocking=True)

    def _payload(self, ws: _Workspace) -> dict:
        """The reported run's payload on the host (copies): obj_before,
        viol_before, stats_before, obj_after, viol_after, stats_after (f32;
        stats as ClusterStats of CPU tensors), checks (i32[5]), the final
        placement, its replica_offline and replica_disk_bytes (numpy)."""
        h = {k: t.numpy().copy() for k, t in ws.payload_host.items()}
        G = len(self.chain.goals)
        out = {k: h[k] for k in ("checks", "replica_broker", "replica_is_leader", "replica_disk",
                                 "replica_offline", "replica_disk_bytes")}
        for row, when in zip(h["report"], ("before", "after")):
            stats, at = {}, 1 + G
            for f, n in REPORT_STATS:
                v = torch.from_numpy(row[at: at + n].copy())
                stats[f] = v if n > 1 else v.reshape(())
                at += n
            out[f"obj_{when}"] = np.float32(row[0])
            out[f"viol_{when}"] = row[1: 1 + G].copy()
            out[f"stats_{when}"] = ClusterStats(**stats)
        return out

    def _step(self, ws: _Workspace, i: int) -> None:
        """Step i of the round: keys from the key table at the device-side
        round index, the temperature from the device scalar t_r."""
        carry = ws.carry
        rnd, spr = ws.sched.si[sched_k.RND: sched_k.RND + 1], self.config.steps_per_round
        cursor = cand_k.KeyCursor(ws.keys, rnd, i, spr, ws.prior_keys)
        prop = cand_k.candidates(self.cand, self.statics, carry, cursor,
                                 self._globals(carry, ws.gbuf), ws.plan,
                                 ws.sched.value(sched_k.T_R), bufs=ws.cand)
        self._survive_apply(carry, prop, ws, select_k.Epoch(i, rnd, spr))

    def _round_body(self, ws: _Workspace, diag: bool | None = None) -> None:
        """A round's steps, then the round prep; the accepted count
        accumulates in sched.acc, the cheap signal lands in sched CHEAP.
        With diagnostics (the config's, unless `diag` says otherwise), the
        full chain's objective and violations of the post-round carry land
        in the schedule's stage."""
        for i in range(self.config.steps_per_round):
            self._step(ws, i)
        cheap = self.round_prep(ws)
        ws.sched.value(sched_k.CHEAP).copy_(cheap)
        if self.config.diagnostics if diag is None else diag:
            obj, viol = self.evaluate(ws.carry)
            ws.sched.stage[:1].copy_(obj.reshape(1))
            ws.sched.stage[1:].copy_(viol)

    # ------------------------------------------------------------------
    # the round schedule
    # ------------------------------------------------------------------

    @device_op("engine.run")
    def run(self, *, verbose: bool = False, initial_placement=None):
        """Execute the annealing schedule; returns (final_state, history).

        `initial_placement`, a (replica_broker, replica_is_leader,
        replica_disk) triple of this cluster's shape, dtypes and device,
        warm-starts the anneal from that placement instead of the statics'
        (the streaming controller's incremental re-anneal); it is copied,
        never written.  The key chain, schedule and early stop are
        unchanged, and movement pricing still counts against the statics'
        placement.

        history holds one record per round that ran (round, temperature,
        accepted, early_stop on the round whose state satisfied the full
        chain, extra on polish rounds, objective when verbose) and one
        timing record.  The main rounds' temperatures are T0 * decay^round
        with the last main round at T=0; from round 1 on, a cheap O(B)
        signal at or below the tolerance opens at most FULL_CHECK_BUDGET
        full-chain checks that may stop the run; after the main rounds,
        polish rounds at T=0 while the worst goal violation exceeds the
        tolerance and falls by 10% or more a round.

        Under an ambient SegmentContext (`segmented_execution`: the device
        scheduler granted the run preemptibly, fleet/scheduler.py) the
        fused schedule runs as wall-bounded slices with a checkpoint
        between them, bit for bit the one-launch run (`_run_segmented`).
        Verbose runs stay unsegmented, as in the JAX package.
        """
        seg_ctx = current_segment_context()
        if self.config.fused_rounds and seg_ctx is not None and not verbose:
            final, history, _ = self._run_segmented(seg_ctx, initial_placement=initial_placement)
        elif self.config.fused_rounds:
            final, history, _ = self._run_fused(verbose=verbose, initial_placement=initial_placement)
        else:
            final, history, _ = self._run_legacy(verbose=verbose,
                                                 initial_placement=initial_placement)
        return final, history

    @device_op("engine.run")
    def run_reported(self, *, verbose: bool = False, initial_placement=None):
        """`run` with the optimizer's reports: the before-report of the
        statics' state, the anneal, the after-report and the device checks
        of the result, fetched with the run's own (one blocking sync on the
        fused route).  Returns (final_state, history, payload), the payload
        as `run_cycle`'s without its "placement".  An ambient
        SegmentContext segments it as it does `run`: the before-report
        heads the slices, the last slice's launch ends with the
        after-report and the checks, and the payload comes back in its
        sync."""
        seg_ctx = current_segment_context()
        if self.config.fused_rounds and seg_ctx is not None and not verbose:
            return self._run_segmented(seg_ctx, initial_placement=initial_placement, reports=True)
        if self.config.fused_rounds:
            return self._run_fused(verbose=verbose, initial_placement=initial_placement,
                                   reports=True)
        return self._run_legacy(verbose=verbose, initial_placement=initial_placement, reports=True)

    @device_op("engine.cycle")
    def run_cycle(self, ll, fl, rows, new_ll, new_fl, initial_placement):
        """The steady-state streaming cycle (the JAX package's `run_cycle`
        and `_cycle_impl`): the window's scatter, the before-report, the
        warm fused anneal, the after-report, the device checks and the
        payload, with ONE blocking sync.

        `ll` / `fl` are the LIVE f32[R, 4] load tensors (the live state's:
        they are copied into the engine's load tables first, and get the
        scattered rows back, in place, before the sync); `rows` / `new_ll`
        / `new_fl` are the window (i32[n] replica rows, at most R of them,
        and their new f32[n, 4] leader and follower loads; rows outside [0,
        R) are dropped, the sentinel R among them); `initial_placement` is
        the warm-start (replica_broker, replica_is_leader, replica_disk)
        triple of device tensors.  The fused route whatever
        `fused_rounds` says, as in the JAX package.

        Returns (ll, fl, payload, history): the live pair, scattered; the
        payload on the host (obj/viol/stats before and after, checks, the
        final placement, replica_offline and replica_disk_bytes as numpy)
        and under "placement" the final (replica_broker, replica_is_leader,
        replica_disk, replica_offline) as copies on the device; history as
        `run` gives it, its timing record also with `fused_cycle` and the
        JAX package's `scatter_width`.  Counts the dispatches
        "engine.cycle" and "engine.extract" only.  A SegmentContext does
        not segment it, as in the JAX package."""
        R = self.shape.R
        rows = np.asarray(rows, np.int32).reshape(-1)
        n = int(rows.size)
        if n > R:
            raise ValueError(f"a window holds at most R={R} rows, got {n}")
        new_ll = np.asarray(new_ll, np.float32).reshape(n, NUM_RESOURCES)
        new_fl = np.asarray(new_fl, np.float32).reshape(n, NUM_RESOURCES)
        final, history, payload = self._run_fused(
            initial_placement=initial_placement, cycle=(ll, fl, rows, new_ll, new_fl))
        payload["placement"] = (final.replica_broker, final.replica_is_leader,
                                final.replica_disk, final.replica_offline)
        timing = history[-1]
        timing["fused_cycle"] = True
        timing["scatter_width"] = _round_up_pow2(n)
        return ll, fl, payload, history

    def _final_state(self, ws: _Workspace) -> ClusterState:
        """The run's result: the bound (caller's) state, on placement
        tensors of its own (the workspace's are the next run's)."""
        c = ws.carry
        return _placed_state(self._state, c.replica_broker.clone(), c.replica_is_leader.clone(),
                             c.replica_disk.clone())

    def _round_eager(self, ws: _Workspace, dims: sched_k.ScheduleDims, pieces=None) -> None:
        """One round of the fused schedule op by op (the CPU route): the
        conditionals read the flags the loop graph's IF nodes read.
        `pieces` replaces the full check, round body and objective by
        callables (the mesh layer's host loop replays their graphs)."""
        full_check, body, objective = pieces or (
            lambda: self._full_check(ws), lambda: self._round_body(ws),
            lambda: self._objective(ws))
        sched_k.round_schedule(sched_k.GATE, ws.sched, dims)
        if ws.sched.si[sched_k.NEED_FULL]:
            full_check()
        sched_k.round_schedule(sched_k.DECIDE, ws.sched, dims)
        if ws.sched.si[sched_k.RUN]:
            body()
            if dims.verbose and not dims.diag:
                objective()
        sched_k.round_schedule(sched_k.CLOSE, ws.sched, dims)

    def _loop_eager(self, ws: _Workspace, dims: sched_k.ScheduleDims, reports: bool,
                    pieces=None) -> int:
        """The loop graph's loop op by op (the CPU route): round after round
        until CLOSE ends the loop (the run is done, or its launch reached
        SLICE_END), then EXIT, and with `reports` the after-report and the
        checks once the run is over.  `pieces` as `_round_eager` takes
        them.  Returns the rounds it iterated."""
        rounds = 0
        while True:
            self._round_eager(ws, dims, pieces)
            rounds += 1
            if not ws.sched.si[sched_k.LOOP]:
                break
        sched_k.round_schedule(sched_k.EXIT, ws.sched, dims)
        if reports and sched_k.run_over(ws.sched, dims):
            self._cycle_post(ws)
        return rounds

    def _capture(self, ws: _Workspace, verbose: bool, reports: bool = False,
                 source: str = "request", loop: bool = True) -> sched_k.LoopGraph | None:
        """The loop graph of this engine (and verbose flag), capturing the
        init, full check, round body and objective graphs on first use,
        and with `reports` the reported run's `pre` and `post` graphs:
        once per engine, whatever generation it is bound to.  Each piece
        runs once eagerly first, on the capture stream, so that lazy
        initialisations happen outside the capture; its launches count
        into this thread's record (`kernels.recording`), kept as the
        capture's `warmup_launches`, not into any run's.  The init graph,
        at the head of every run, resets everything they touched, and a
        second scatter of the same window writes the same rows.  `source`
        ("request" or "prewarm") goes to the capture accounting
        (common/compilation_cache.py) and `on_capture`."""
        dims = self._sched_dims(verbose)
        # the verbose objective graph; with diagnostics the round body
        # writes the objective itself
        obj = verbose and not dims.diag
        names = ("init", "eval", "body") + (("obj",) if obj else ()) + (
            ("pre", "post") if reports else ())
        todo = [n for n in names if n not in ws.graphs]
        lg = ws.loops.get(verbose)
        if (lg is not None or not loop) and not todo:
            return lg
        pieces = dict(init=lambda: self._init_run(ws, dims), eval=lambda: self._full_check(ws),
                      body=lambda: self._round_body(ws), obj=lambda: self._objective(ws),
                      pre=lambda: self._cycle_pre(ws), post=lambda: self._cycle_post(ws))
        # the body's warm-up is one step and a round prep: the code of
        # every step is the same
        warm = dict(pieces, body=lambda: (self._step(ws, 0), self.round_prep(ws)))
        t0 = time.monotonic()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream), kernels.recording() as warm_rec:
                for name in todo:
                    warm[name]()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            t_warm = time.monotonic()
            for name in todo:
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with kernels.capture(graph, stream) as rec:
                    pieces[name]()
                ws.graph_launches[name] = {k: rec.get(k, 0) for k in kernels.LAUNCHES}
                ws.graphs[name] = graph
        except BaseException:
            # a failed capture (an OOM, an invalidated capture) leaves none
            # of this call's graphs behind: nothing half-captured is ever
            # replayed, and the next run of the engine captures them anew
            for name in todo:
                ws.graphs.pop(name, None)
                ws.graph_launches.pop(name, None)
            raise
        t_cap = time.monotonic()
        if lg is None and loop:
            lg = sched_k.LoopGraph(ws.sched, dims, ws.graphs["init"], ws.graphs["eval"],
                                   ws.graphs["body"], ws.graphs["obj"] if obj else None)
            ws.loops[verbose] = lg
        if ws.ys_host is None:
            ws.ys_host = torch.empty(ws.sched.ys.shape, dtype=torch.float64, pin_memory=True)
            ws.count_host = torch.empty(ws.sched.count.shape, dtype=torch.int32, pin_memory=True)
        t_inst = time.monotonic()
        stats = self.graph_stats.setdefault("captures", [])
        stats.append(dict(
            verbose=verbose, source=source, max_rf=self.max_rf, warmup_s=t_warm - t0,
            capture_s=t_cap - t_warm, instantiate_s=t_inst - t_cap, graphs=todo,
            nodes={n: sched_k.graph_nodes(ws.graphs[n]) for n in todo},
            launches_per_replay={n: {k: v for k, v in ws.graph_launches[n].items() if v}
                                 for n in todo},
            warmup_launches={k: v for k, v in warm_rec.items() if v},
        ))
        compilation_cache.record_engine_capture(bucket_key(self.shape), source=source)
        if self.on_capture is not None:
            self.on_capture(t_inst - t0, source)
        return lg

    def _run_fused(self, *, verbose: bool = False, initial_placement=None, reports: bool = False,
                   cycle=None):
        """The fused route; returns (final_state, history, payload or None).
        With `reports` the before-report heads the run and the
        after-report and the checks end it, and their payload comes back
        with the ys; `cycle`, (ll, fl, rows, new_ll, new_fl), makes it the
        streaming cycle (`run_cycle`): reports, the window scattered first,
        the live tensors written back, and the dispatches counted as
        "engine.cycle" and "engine.extract"."""
        t_start = time.monotonic()
        self._wait_warm()
        ws = self._workspace()
        self._uses += 1
        dims = self._sched_dims(verbose)
        reports = reports or cycle is not None
        if cycle is None:
            count_dispatch("engine.init")
        self._stage(ws, initial_placement)
        if reports:
            self._stage_delta(ws, cycle)
        run_tag, sync_tag = ("engine.cycle", "engine.extract") if cycle else ("engine.run", "engine.sync")
        report_launches = 0
        if self.device.type == "cuda":
            n_caps = len(self.graph_stats.get("captures", []))
            lg = self._capture(ws, verbose, reports)
            captured = [g for c in self.graph_stats.get("captures", [])[n_caps:] for g in c["graphs"]]
            count_dispatch(run_tag)
            stream = torch.cuda.current_stream(self.device)
            before = lg.launches
            if reports:
                ws.graphs["pre"].replay()
            lg.launch(stream.cuda_stream)
            if reports:
                ws.graphs["post"].replay()
                report_launches = 2
            graph_launches = lg.launches - before
            ws.ys_host.copy_(ws.sched.ys, non_blocking=True)
            ws.count_host.copy_(ws.sched.count, non_blocking=True)
        else:
            graph_launches, captured = 0, []
            if reports:
                self._cycle_pre(ws)
            self._init_run(ws, dims)
            count_dispatch(run_tag)
            self._loop_eager(ws, dims, reports)
        if cycle is not None:
            for t, buf in zip(cycle[:2], self._loads):
                t.copy_(buf)
        if reports:
            self._payload_to_host(ws)
        t_disp = time.monotonic()
        # the run's ONE blocking sync: the per-round scalars (complete only
        # when the loop has ended) and the payload; the carry stays on the
        # device
        count_dispatch(sync_tag)
        if self.device.type == "cuda":
            stream.synchronize()
            ys = ws.ys_host.numpy().copy()
            count = ws.count_host.numpy().copy()
            self._count_replays(ws, ys, int(count[sched_k.ITERS]), verbose, reports)
        else:
            ys = ws.sched.ys.numpy().copy()
            count = ws.sched.count.numpy().copy()
        t_sync = time.monotonic()
        self.last_ys = ys
        history = self._fused_history(ys, verbose=verbose)
        timing = dict(
            timing=True, fused=True, blocking_syncs=1, graph_launches=graph_launches,
            report_graph_launches=report_launches, captured=captured,
            loop_iterations=int(count[sched_k.ITERS]), masked_rounds=int(count[sched_k.MASKED]),
            host_dispatch_s=round(t_disp - t_start, 6), device_s=round(t_sync - t_disp, 6),
        )
        conv = self._convergence_summary(ys)
        if conv is not None:
            timing["convergence"] = conv
        history.append(timing)
        return self._final_state(ws), history, self._payload(ws) if reports else None

    # ------------------------------------------------------------------
    # segmented (preemptible) execution: fleet/scheduler.py
    # ------------------------------------------------------------------

    def _slice_graph(self, ws: _Workspace, reports: bool) -> sched_k.LoopGraph:
        """The slice graph of a segmented run: the loop graph without init
        over the engine's captured `eval` and `body` graphs, ending with the
        copies of the ys, the loop's counters and the schedule's int state
        to pinned host memory, and with `reports` the IF node that runs
        `post` and copies the payload once the run is over (the last
        slice).  Instantiated once per engine and reports
        flag, whatever the slice length (the length is data: SLICE_END);
        an instantiation, not a capture, recorded in `graph_stats` and
        common/compilation_cache.py.  The captured graphs must exist."""
        sl = ws.slices.get(reports)
        if sl is not None:
            return sl
        t0 = time.monotonic()
        if ws.si_host is None:
            ws.si_host = torch.empty(ws.sched.si.shape, dtype=torch.int32, pin_memory=True)
        copies = [(ws.ys_host, ws.sched.ys), (ws.count_host, ws.sched.count),
                  (ws.si_host, ws.sched.si)]
        post_copies = []
        if reports:
            host = self._payload_buffers(ws)
            post_copies = [(host[k], t) for k, t in self._payload_sources(ws).items()]
        sl = sched_k.LoopGraph(ws.sched, self._sched_dims(False), None, ws.graphs["eval"],
                               ws.graphs["body"], post_graph=ws.graphs["post"] if reports else None,
                               copies=copies, post_copies=post_copies)
        ws.slices[reports] = sl
        self.graph_stats.setdefault("slice_graphs", []).append(dict(
            reports=reports, instantiate_s=time.monotonic() - t0,
            copies=len(copies) + len(post_copies)))
        compilation_cache.record_slice_graph(bucket_key(self.shape))
        return sl

    @staticmethod
    def _run_state(ws: _Workspace) -> tuple[dict, dict]:
        """(carry, rest): the tensors of a run in flight that another run on
        the engine overwrites and the next slice reads: the carry's, and
        the schedule's state and ys, the plan, the grouping, the step
        globals, the select minima and the before-report.  The key table,
        the decay powers and the apply slots (-1 between steps) are the
        same for every run of the engine; the generation's tensors come
        back with a rebind."""
        c, s, p, g = ws.carry, ws.sched, ws.plan, ws.group
        carry = {f.name: getattr(c, f.name) for f in dataclasses.fields(c) if f.name != "key"}
        rest = dict(si=s.si, sf=s.sf, acc=s.acc, ys=s.ys, count=s.count,
                    broker_cdf=p.broker_cdf, replica_cost=p.replica_cost, lead_cost=p.lead_cost,
                    group_count=g.count, group_start=g.start, group_order=g.order, gbuf=ws.gbuf,
                    report=ws.report)
        if s.stage is not None:
            rest["stage"] = s.stage
        if ws.sel is not None:
            rest["segmin"] = ws.sel.segmin
        return carry, rest

    def _let_go(self, ws: _Workspace, pauses: dict):
        """A checkpoint pauses the segmented run: where this thread holds
        the run lock (`locked`), copy the run's state into the workspace's
        stash on the device and release the lock, so a preempting run on
        this engine (the same bucket) can take it.  Returns the token
        `_take_back` needs, None where nothing was let go."""
        pauses["n"] += 1
        if self._run_owner != threading.get_ident():
            return None
        carry, rest = self._run_state(ws)
        state = {**carry, **rest}
        if ws.stash is None:
            ws.stash = {k: torch.empty_like(t) for k, t in state.items()}
        for k, t in state.items():
            ws.stash[k].copy_(t)
        token = (self._uses, self._bound_args)
        self._run_owner = None
        self.run_lock.release()
        return token

    def _take_back(self, ws: _Workspace, token, pauses: dict) -> None:
        """The pause ended: retake the run lock and, where another run or a
        rebind used the engine meanwhile, rebind the run's own generation
        (data to the graphs, no capture) and copy its stashed state back."""
        if token is None:
            return
        self.run_lock.acquire()
        self._run_owner = threading.get_ident()
        uses, bound = token
        if self._uses == uses:
            return
        self.rebind(*bound)
        if self._ws is not ws:
            raise RuntimeError("the engine released its workspace while a segmented run was paused "
                               "(a rebind to another max_rf); the run cannot resume")
        carry, rest = self._run_state(ws)
        for k, t in {**carry, **rest}.items():
            t.copy_(ws.stash[k])
        pauses["restores"] += 1

    def _snapshot(self, ws: _Workspace, base: int, parts: list) -> CarryCheckpoint:
        """The run's state at a slice boundary as host arrays of their own."""
        count_dispatch("engine.snapshot")
        carry, rest = self._run_state(ws)

        def host(d):
            return {k: t.detach().cpu().numpy().copy() for k, t in d.items()}

        return CarryCheckpoint(base=base, carry=host(carry), seg=host(rest),
                               ys_parts=[dict(p) for p in parts])

    def _run_segmented(self, seg_ctx: SegmentContext, *, initial_placement=None,
                       reports: bool = False):
        """The fused anneal in wall-bounded preemptible slices (the JAX
        package's `_run_segmented`); returns (final_state, history,
        payload or None).

        The prelude is the run's init: on the card one replay of the
        engine's captured init graph (after the `pre` report graph with
        `reports`).  Then slice after slice: the host writes base + L into
        the schedule's SLICE_END (one stream-ordered write), launches the
        slice graph (`_slice_graph`: the loop without init, rounds [base,
        min(base + L, total)), fewer when the run stops; the last slice's
        launch also runs `post`) and makes one blocking sync, which
        fetches the ys and the `done` flag; on the CPU the same loop runs
        op by op.  Between slices `seg_ctx.checkpoint()` runs (the
        scheduler may pause the run there: `_let_go` / `_take_back`), then
        `offer_snapshot`.  Every slice replays the same graphs on the same
        tensors as the one-launch run, so the rounds, placements and ys
        are bit for bit its own; EXIT writes the masked rounds once the
        run is over.  L grows in powers of two up to SEGMENT_MAX_ROUNDS
        from an EWMA of the per-round wall against `slice_budget_s`
        (floored at 1 ms).  The JAX package keeps the first use of each L
        out of the EWMA, because that slice compiles; here no slice length
        compiles or captures, and the captures and the slice graph's
        instantiation happen before the first slice, outside its wall, so
        every slice feeds it.  The cost of preemptibility is one blocking
        sync a slice instead of one a run (`blocking_syncs == segments`)."""
        t_start = time.monotonic()
        self._wait_warm()
        ws = self._workspace()
        self._uses += 1
        dims = self._sched_dims(False)
        total = dims.total
        cuda = self.device.type == "cuda"
        count_dispatch("engine.init")
        self._stage(ws, initial_placement)
        if reports:
            self._stage_delta(ws, None)
        captured, instantiated = [], []
        if cuda:
            n_caps = len(self.graph_stats.get("captures", []))
            n_slices = len(ws.slices)
            self._capture(ws, False, reports)
            captured = [g for c in self.graph_stats.get("captures", [])[n_caps:] for g in c["graphs"]]
            sl = self._slice_graph(ws, reports)
            instantiated = ["slice"] if len(ws.slices) > n_slices else []
            stream = torch.cuda.current_stream(self.device)
            if reports:
                ws.graphs["pre"].replay()
            ws.graphs["init"].replay()
        else:
            if reports:
                self._cycle_pre(ws)
            self._init_run(ws, dims)
        budget = max(1e-3, float(seg_ctx.slice_budget_s))
        slices: list[dict] = []
        parts: list[dict] = []
        pauses = dict(n=0, restores=0)
        base, L, round_wall, device_s, paused_s = 0, 1, None, 0.0, 0.0
        t_end = pause_s = None
        while base < total:
            t0s = time.monotonic()
            # black-box spool: one Begin per slice launch, ended after its
            # sync, so a hang names the slice in flight (common/blackbox.py)
            seq = _BLACKBOX.begin("engine-slice", slice=len(slices), base_round=base, rounds=L,
                                  total_rounds=total)
            try:
                count_dispatch("engine.slice")
                if cuda:
                    ws.sched.si[sched_k.SLICE_END: sched_k.SLICE_END + 1].fill_(base + L)
                    sl.launch(stream.cuda_stream)
                    t_launched = time.monotonic()
                    # the slice boundary is a blocking sync: the device is
                    # idle before the scheduler may hand it to another run
                    count_dispatch("engine.sync")
                    stream.synchronize()
                    ys, count, si = (t.numpy().copy() for t in (ws.ys_host, ws.count_host,
                                                                ws.si_host))
                else:
                    ws.sched.si[sched_k.SLICE_END] = base + L
                    self._loop_eager(ws, dims, reports)
                    t_launched = time.monotonic()
                    count_dispatch("engine.sync")
                    ys, count, si = (t.numpy().copy() for t in (ws.sched.ys, ws.sched.count,
                                                                ws.sched.si))
            except BaseException as e:  # noqa: BLE001 -- recorded, re-raised
                _BLACKBOX.end(seq, ok=False, error=repr(e))
                raise
            done = bool(si[sched_k.DONE])
            _BLACKBOX.end(seq, done=done)
            wall = time.monotonic() - t0s
            device_s += wall
            # issue_s: the slice's fill and launch on the host; gap_s: the
            # host's turnaround since the previous slice's sync, its
            # checkpoint's pause left out (the device idles meanwhile)
            slices.append(dict(base=base, rounds=L, wall_s=round(wall, 6),
                               issue_s=round(t_launched - t0s, 6),
                               gap_s=None if t_end is None else round(t0s - t_end - pause_s, 6)))
            t_end, pause_s = time.monotonic(), 0.0
            parts.append({k: v[base: min(base + L, total)] for k, v in self._ys_dict(ys).items()})
            base += L
            per_round = wall / L
            round_wall = per_round if round_wall is None else 0.5 * round_wall + 0.5 * per_round
            if done or base >= total:
                break
            L = 1
            while L * 2 * round_wall <= budget and L * 2 <= SEGMENT_MAX_ROUNDS:
                L *= 2
            if seg_ctx.checkpoint is not None:
                t_pause = time.monotonic()
                with seg_ctx.holding(lambda: self._let_go(ws, pauses),
                                     lambda token: self._take_back(ws, token, pauses)):
                    seg_ctx.checkpoint()
                pause_s = time.monotonic() - t_pause
                paused_s += pause_s
            seg_ctx.offer_snapshot(lambda b=base: self._snapshot(ws, b, parts))
        if cuda:
            self._count_replays(ws, ys, int(count[sched_k.ITERS]), False, reports,
                                exits=len(slices))
        elif reports:
            self._payload_to_host(ws)
        history = self._fused_history(ys, verbose=False)
        timing = dict(
            timing=True, fused=True, segmented=True, segments=len(slices),
            blocking_syncs=len(slices), graph_launches=len(slices) if cuda else 0,
            report_graph_launches=2 if cuda and reports else 0, captured=captured,
            instantiated=instantiated, loop_iterations=int(count[sched_k.ITERS]),
            masked_rounds=int(count[sched_k.MASKED]), slices=slices, pauses=pauses["n"],
            restores=pauses["restores"], paused_s=round(paused_s, 6), device_s=round(device_s, 6),
            host_dispatch_s=round(time.monotonic() - t_start - device_s - paused_s, 6),
        )
        conv = self._convergence_summary(ys)
        if conv is not None:
            timing["convergence"] = conv
        history.append(timing)
        return self._final_state(ws), history, self._payload(ws) if reports else None

    def _count_replays(self, ws: _Workspace, ys: np.ndarray, iterations: int,
                       verbose: bool, reports: bool = False, exits: int = 1) -> None:
        """Kernel launches of a graph run: each graph's launches per replay
        times its replays, which the ys record (a body replays on rounds
        that ran, the check on rounds that needed it; the rows EXIT wrote
        record neither), the report graphs once each on a reported run, and
        the schedule's own: INIT in the init graph, three a loop iteration,
        and EXIT once a launch (`exits`: a segmented run's slices)."""
        col = {k: i for i, k in enumerate(sched_k.YS)}
        ran = int(ys[:, col["ran"]].sum())
        kernels.add_launches(ws.graph_launches["init"], 1)
        kernels.add_launches(ws.graph_launches["eval"], int(ys[:, col["full_check"]].sum()))
        kernels.add_launches(ws.graph_launches["body"], ran)
        if verbose and not self.config.diagnostics:
            kernels.add_launches(ws.graph_launches["obj"], ran)
        if reports:
            kernels.add_launches(ws.graph_launches["pre"], 1)
            kernels.add_launches(ws.graph_launches["post"], 1)
        kernels.count("round_schedule", 3 * iterations + exits)

    def _ys_keys(self) -> tuple:
        """The keys of the run's per-round ys: FUSED_YS_KEYS, and the
        diagnostics' with convergence diagnostics."""
        return FUSED_DIAG_YS_KEYS if self.config.diagnostics else FUSED_YS_KEYS

    def _ys_dict(self, ys: np.ndarray) -> dict:
        """The run's ys rows as {key: per-round column} (`_ys_keys`;
        goal_viol f32[rounds, G])."""
        col = sched_k.ys_columns(self._sched_dims(False))
        out = {k: ys[:, col[k]] for k in self._ys_keys() if k != "goal_viol"}
        if self.config.diagnostics:
            g0 = col["goal_viol"]
            out["goal_viol"] = ys[:, g0: g0 + len(self.chain.goals)].astype(np.float32)
            out["objective"] = out["objective"].astype(np.float32)
        return out

    def _fused_history(self, ys: np.ndarray, *, verbose: bool) -> list[dict]:
        """Per-round history records from the run's ys (the JAX package's
        `_fused_history`); with diagnostics each record also carries the
        round's objective, per-goal violations, survivors by kind and
        prior usage."""
        col = {k: i for i, k in enumerate(sched_k.YS)}
        diag = self.config.diagnostics
        d = self._ys_dict(ys) if diag else None
        history: list[dict] = []
        for r in range(len(ys)):
            if ys[r, col["stopped"]] and history:
                history[-1]["early_stop"] = True
            if not ys[r, col["ran"]]:
                continue
            rec = dict(round=len(history), temperature=float(ys[r, col["temperature"]]),
                       accepted=int(ys[r, col["accepted"]]))
            if r >= self.config.num_rounds:
                rec["extra"] = True
            if diag:
                rec["objective"] = float(d["objective"][r])
                rec["goal_violations"] = [round(float(v), 8) for v in d["goal_viol"][r]]
                rec["accepted_by_kind"] = {
                    "replica": int(d["acc_replica"][r]),
                    "swap": int(d["acc_swap"][r]),
                    "leadership": int(d["acc_lead"][r]),
                }
                rec["prior"] = {
                    "candidates": int(d["prior_cands"][r]),
                    "accepted": int(d["prior_acc"][r]),
                }
            elif verbose:
                rec["objective"] = float(ys[r, col["objective"]])
            history.append(rec)
        return history

    def _convergence_summary(self, ys: np.ndarray) -> dict | None:
        """The run's convergence summary (the JAX package's
        `_convergence_summary`), None without diagnostics: rounds, early
        stop, the objective, temperature and acceptance trajectories, the
        survivors by kind and prior usage summed, and the last round's
        per-goal violations."""
        if not self.config.diagnostics:
            return None
        d = self._ys_dict(ys)
        ran = d["ran"].astype(bool)
        last = int(np.nonzero(ran)[0][-1]) if ran.any() else None
        return dict(
            rounds=int(ran.sum()),
            early_stop=bool(d["stopped"].any()),
            objective_trajectory=[round(float(x), 8) for x in d["objective"][ran]],
            temperatures=[float(x) for x in d["temperature"][ran]],
            accepted=[int(x) for x in d["accepted"][ran]],
            accepted_by_kind=dict(
                replica=int(d["acc_replica"][ran].sum()),
                swap=int(d["acc_swap"][ran].sum()),
                leadership=int(d["acc_lead"][ran].sum()),
            ),
            prior=dict(
                candidates=int(d["prior_cands"][ran].sum()),
                accepted=int(d["prior_acc"][ran].sum()),
            ),
            goal_names=self.chain.names(),
            final_goal_violations=(
                [round(float(v), 8) for v in d["goal_viol"][last]] if last is not None else []
            ),
        )

    def _run_legacy(self, *, verbose: bool = False, initial_placement=None, reports: bool = False):
        """The host-driven round loop (the JAX package's `_run_legacy`):
        temperatures as Python floats, the early-stop check at the bottom
        of a round, then the polish loop; one blocking sync (or more) a
        round.  The carry is updated in place, so no round is dispatched
        ahead of the previous round's check, and the history is the
        reference's.  It ignores `diagnostics`, as the reference's does
        (`verbose` is its per-round view).  Returns (final_state, history,
        payload or None); `reports` as `_run_fused`'s, op by op."""
        cfg = self.config
        t_start = time.monotonic()
        sync = dict(n=0, s=0.0)

        def fetch(x: torch.Tensor) -> list:
            """The values of x on the host, the blocking wait metered."""
            t0 = time.monotonic()
            count_dispatch("engine.sync")
            v = x.tolist()
            sync["n"] += 1
            sync["s"] += time.monotonic() - t0
            return v

        count_dispatch("engine.init")
        self._wait_warm()
        ws = self._workspace()
        self._uses += 1
        sched = ws.sched
        self._stage(ws, initial_placement)
        if reports:
            self._stage_delta(ws, None)
            self._cycle_pre(ws)
        carry = self._reset_run(ws)
        t0_obj = float(fetch(self.evaluate(carry)[0])) * cfg.init_temperature_scale
        self.plan(carry, self._globals(carry, ws.gbuf), ws.plan)
        tol = cfg.early_stop_tol

        def _temp(rnd: int) -> float:
            if rnd == cfg.num_rounds - 1:
                return 0.0
            return t0_obj * (cfg.temperature_decay ** rnd)

        def do_round(rnd: int, temperature: float) -> list:
            """Round rnd at `temperature`; returns [accepted, cheap]."""
            count_dispatch("engine.run")
            sched.si[sched_k.RND: sched_k.RND + 1].fill_(rnd)
            sched.value(sched_k.T_R).fill_(float(np.float32(temperature)))
            sched.acc.zero_()
            self._round_body(ws, diag=False)
            return fetch(torch.stack([sched.acc[0].double(), sched.sf[sched_k.CHEAP].double()]))

        def objective() -> float:
            return float(fetch(self.evaluate(carry)[0]))

        def worst() -> float:
            return float(fetch(self.evaluate(carry)[1].max()))

        history = []
        full_checks_left = FULL_CHECK_BUDGET
        for rnd in range(cfg.num_rounds):
            acc, cheap = do_round(rnd, _temp(rnd))
            history.append(dict(round=rnd, temperature=_temp(rnd), accepted=int(acc)))
            if verbose:
                history[-1]["objective"] = objective()
            if (cfg.early_stop_violations >= 0.0 and rnd < cfg.num_rounds - 1
                    and full_checks_left > 0 and cheap <= tol):
                if worst() <= tol:
                    history[-1]["early_stop"] = True
                    break
                full_checks_left -= 1
        else:
            # schedule exhausted with goals possibly unsatisfied (bad
            # starts: mass decommission): polish with extra greedy rounds
            # while the full chain reports violations and they keep shrinking
            prev_v = None
            for extra in range(cfg.extra_round_budget):
                v = worst()
                if v <= tol or (prev_v is not None
                                and v > float(np.float32(prev_v) * np.float32(0.9))):
                    break
                prev_v = v
                acc, _ = do_round(cfg.num_rounds + extra, 0.0)
                history.append(dict(round=len(history), temperature=0.0, extra=True,
                                    accepted=int(acc)))
                if verbose:
                    history[-1]["objective"] = objective()
        payload = None
        if reports:
            self._cycle_post(ws)
            self._payload_to_host(ws)
            fetch(ws.checks)
            payload = self._payload(ws)
        history.append(dict(
            timing=True, fused=False, blocking_syncs=sync["n"], device_s=round(sync["s"], 6),
            host_s=round(time.monotonic() - t_start - sync["s"], 6),
        ))
        return self._final_state(ws), history, payload
