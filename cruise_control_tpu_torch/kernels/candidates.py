"""candidates — one anneal step's candidate moves: drawn, scored, accepted.

Replaces, per step: `jax.random.uniform` / `_uniform_idx` draws and
`_sample_sources` (cruise_control_tpu/analyzer/engine.py:958, :1810), the
three candidate kinds `_replica_candidates` (:1954), `_swap_candidates`
(:2160) and `_leadership_candidates` (:2348) with their `_move_delta`
(:2439) and its intra-broker disk terms (`_disk_terms`, :1767), or, in
the rebalance_disk mode, `_intra_disk_candidates` (:2078) alone;
`_assemble_prop` (:2580) and the Metropolis acceptance of
`_accept_select_apply` (:2669).  Out come the bundle that `select_survivors`
reads (delta, feas, accept, src, dst, part1, part2) and the payload rows
that `apply_moves` reads (`apply.REL_FIELDS`, a swap as two linked rows at
nr+i and nr+ns+i; `apply.LEAD_FIELDS`).

Bound on the card: latency.  Each candidate gathers one or two replica
rows, a partition's member row, the src/dst broker, host and disk rows,
and (for the importance-sampled sources) ~12 probes of the broker CDF,
then writes ~22 bytes of bundle and a 53- or 64-byte payload row; a
north-star step (K=16,384) needs ~3.2 MB, about a microsecond of HBM
time, and ~600 operations a candidate.  What is left is each candidate's
chain: 7 dependent gathers, then ~50 IEEE divisions and 8 square roots.
Design (csrc/candidates.cu): one launch runs all K candidates, each move
kind in its own block range, a candidate a team of lanes of one warp (4;
8 for a swap, whose two replicas' rows, member scans and cells run side
by side) whose roles run one instruction stream on different data: the
threefry draws (inline: the draws never touch HBM), the member scan, the
four broker and host rows of the move (src and dst, after the move and as
they are, so the old-state terms need no launch of their own), the
tiebreak's four resources, the four logdir rows of the disk terms; each
partial is combined by shuffles in the single-lane expression's order,
so the bits are those of one lane doing it all.  The broker CDF is staged
in shared memory with asynchronous copies that overlap the draws (probed
from global memory where it does not fit).  The kernel is templated on the
disk terms, the intra kind, the prior and bf16, so each mode compiles
apart.  Tensor cores and TMA have nothing to do here: there is no matrix
product, and the gathers are scattered rows.

Keys: a step's keys are split from the carry key exactly as the reference
splits them (`StepKeys.of`).  The key chain does not depend on the data,
so a run derives the keys of all its steps on the host at once
(`key_table`) and uploads them; the kernel reads its step's row at the
device-side round index (`KeyCursor`), and the Metropolis temperature from
a device scalar, so a captured step needs no host value.

The learned prior (`CandParams.prior`; the prior branch of `_sample_dests`,
:1832-1873) draws a relocation's destination from its source topic's CDF
(the statics' `prior_cdf`, f32[T, B]) where a mix draw falls below
`prior_mix` (an f32[1] device scalar, so a captured step reads the run's
value), with two keys a step of their own (`PRIOR_KEY_WORDS` more words a
row of a prior-enabled key table; the default table is unchanged), and
returns the took-the-prior mask as `from_prior` for the diagnostics.
bf16 scoring (`TermParams.bf16`) sums the broker terms in bf16
(move_delta.py `accumulate_bf16`, csrc/terms.cuh).  Each is a template
parameter of the kernel beside the disk terms and the intra kind.

The plain version (`candidates_plain`) is the engine's candidate code as
PyTorch ops, with the draws and deltas of the plain threefry and
move_delta functions; the CPU tests hold it against the JAX reference.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.kernels import _build, threefry
from cruise_control_tpu_torch.kernels import move_delta as md

if TYPE_CHECKING:
    from cruise_control_tpu_torch.analyzer.draws import Key

_NW_IN, _NW_OUT, _DISK = int(Resource.NW_IN), int(Resource.NW_OUT), int(Resource.DISK)
#: the Metropolis draw's minval (engine.py:950 of the reference)
U_MIN = 1e-12
#: uint32 words of a step's keys in the key table (csrc/candidates.cu StepKeys)
KEY_WORDS = 24
#: the words a prior-enabled table adds to a row (the prior draws' two keys)
PRIOR_KEY_WORDS = 4
_FN = None


@dataclasses.dataclass(frozen=True)
class StepKeys:
    """The threefry keys of one anneal step, split from the carry key as
    the reference's `_step` (split(5)), candidate kinds (split(2)) and
    `_sample_sources` (split(4)) split them; with the learned prior, the keys of its two
    draws, `split(fold_in(rel_dst, 1))` as `_sample_dests` derives them."""

    next: Key  # the carry's key after the step
    #: relocation sources: uniform, CDF u, slot u, fallback (split(4) of the
    #: relocation kind's first key; of the kind's key itself for intra-broker
    #: moves, whose `_intra_disk_candidates` draws no destination broker)
    rel_src: tuple[Key, Key, Key, Key]
    rel_dst: Key
    swap_src: tuple[Key, Key, Key, Key]  # swap sources r, as rel_src
    swap_q: Key
    lead: Key
    u: Key  # Metropolis draw over all K candidates
    #: the prior's draws (prior-enabled engines): which branch, and the CDF u
    prior_m: Key | None = None
    prior_p: Key | None = None

    @staticmethod
    def of(key: Key, intra: bool = False, prior: bool = False) -> "StepKeys":
        nxt, k_r, k_s, k_l, k_u = key.split(5)
        r_src, r_dst = k_r.split(2)
        s_src, s_q = k_s.split(2)
        rel_src = (k_r if intra else r_src).split(4)
        k_m, k_p = r_dst.fold_in(1).split(2) if prior else (None, None)
        return StepKeys(nxt, tuple(rel_src), r_dst, tuple(s_src.split(4)), s_q, k_l, k_u, k_m, k_p)

    def words(self) -> list[int]:
        """The step's row of the key table (next is not in it), the
        prior's keys last when it has them."""
        keys = (*self.rel_src, self.rel_dst, *self.swap_src, self.swap_q, self.lead, self.u)
        if self.prior_m is not None:
            keys += (self.prior_m, self.prior_p)
        return [w for key in keys for w in key.words]

    @staticmethod
    def from_words(row) -> "StepKeys":
        from cruise_control_tpu_torch.analyzer.draws import Key  # the analyzer imports this module

        w = [int(x) & threefry.MASK32 for x in row]
        k = [Key(w[i], w[i + 1]) for i in range(0, len(w), 2)]
        prior = (k[12], k[13]) if len(w) > KEY_WORDS else (None, None)
        return StepKeys(None, tuple(k[0:4]), k[4], tuple(k[5:9]), k[9], k[10], k[11], *prior)


def key_table(key: Key, n_steps: int, intra: bool = False, prior: bool = False) -> np.ndarray:
    """uint32[n_steps, KEY_WORDS (+ PRIOR_KEY_WORDS with `prior`)]: the keys
    of n_steps consecutive steps from carry key `key`, each row
    `StepKeys.of(chain key i, intra, prior).words()`.  The chain (one hash
    a step) runs in Python integers; the other splits hash all steps at
    once on int64 arrays."""
    k0 = np.empty(n_steps, np.int64)
    k1 = np.empty(n_steps, np.int64)
    cur = (key.k0, key.k1)
    for i in range(n_steps):
        k0[i], k1[i] = cur
        cur = threefry.threefry2x32(cur[0], cur[1], 0, 0)

    def split(pair, i):
        return threefry.threefry2x32(pair[0], pair[1], 0, i)

    base = (k0, k1)
    k_r, k_s, k_l, k_u = (split(base, i) for i in (1, 2, 3, 4))
    r_src, s_src = (k_r if intra else split(k_r, 0)), split(k_s, 0)
    r_dst = split(k_r, 1)
    cols = ([split(r_src, j) for j in range(4)] + [r_dst]
            + [split(s_src, j) for j in range(4)] + [split(k_s, 1), k_l, k_u])
    if prior:
        folded = split(r_dst, 1)  # fold_in(r_dst, 1) hashes the counter (0, 1) too
        cols += [split(folded, 0), split(folded, 1)]
    return np.stack([w for pair in cols for w in pair], axis=1).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class KeyCursor:
    """Where a step finds its keys: row rnd * steps_per_round + step of a
    key table, rnd read from the device scalar `rnd` (i32[1])."""

    table: torch.Tensor  # i32[n, KEY_WORDS], the uint32 words' bits
    rnd: torch.Tensor  # i32[1]
    step: int
    steps_per_round: int
    #: i32[n, PRIOR_KEY_WORDS]: the prior draws' keys of each row, or None
    prior: torch.Tensor | None = None

    @staticmethod
    def of(keys: StepKeys, device) -> "KeyCursor":
        """A one-row cursor holding `keys`."""
        row = torch.from_numpy(np.asarray(keys.words(), np.uint32).view(np.int32)[None, :].copy())
        prior = row[:, KEY_WORDS:].contiguous().to(device) if keys.prior_m is not None else None
        return KeyCursor(row[:, :KEY_WORDS].contiguous().to(device),
                         torch.zeros(1, dtype=torch.int32, device=device), 0, 1, prior)

    def step_keys(self) -> StepKeys:
        """The keys the kernel would read (reads the round index)."""
        i = int(self.rnd[0]) * self.steps_per_round + self.step
        row = self.table[i].tolist() + ([] if self.prior is None else self.prior[i].tolist())
        return StepKeys.from_words(row)


@dataclasses.dataclass(frozen=True)
class CandParams:
    """Per-engine constants of candidate generation: the objective terms'
    parameters, the candidate split, and the goal weights of the terms
    that live outside the broker terms."""

    tp: md.TermParams
    K_r: int
    K_s: int
    K_l: int
    w_rack: float
    w_offline: float
    w_topic: float
    w_pref: float
    topic_tt: float  # topic replica-count balance threshold
    replica_move_cost: float
    leadership_move_cost: float
    importance_fraction: float
    num_parts: int  # max(1, P): the preferred-leader term's denominator
    intra: bool = False  # intra-broker disk moves in place of relocations
    #: relocation destinations mixed from the learned prior (never intra)
    prior: bool = False

    def n_imp(self, n: int, plan) -> int:
        """Importance-sampled sources among n (the tail of the n)."""
        return int(round(n * self.importance_fraction)) if plan is not None else 0


@dataclasses.dataclass(frozen=True)
class Lanes:
    """The candidates one launch runs: per kind (relocations or intra
    moves, swaps, leadership transfers) the first global candidate and the
    lane count.  Lane t of a kind is global candidate base + t, drawn,
    scored and accepted exactly as in the full-K launch (the same keys,
    counters and Metropolis u), and lands at t of the launch's own layout;
    a lane past its kind's K holds anything (the kernel stores nothing
    there, the plain version repeats the kind's last candidate).  The JAX
    package's `_slice_draws` (engine.py:1872) slices the full draws the same
    way, edge-padding where the port leaves its lanes past K unused."""

    base_r: int
    n_r: int
    base_s: int
    n_s: int
    base_l: int
    n_l: int

    @staticmethod
    def full(cp: "CandParams") -> "Lanes":
        return Lanes(0, cp.K_r, 0, cp.K_s, 0, cp.K_l)

    @staticmethod
    def shard(cp: "CandParams", j: int, n: int) -> "Lanes":
        """Shard j of n of `cp`'s kinds (`split`)."""
        return Lanes.split((cp.K_r, cp.K_s, cp.K_l), j, n)

    @staticmethod
    def split(ks: tuple[int, int, int], j: int, n: int) -> "Lanes":
        """Shard j of n of kinds of (K_r, K_s, K_l) candidates: ceil(K/n)
        lanes of each kind from j * ceil(K/n)."""
        s_r, s_s, s_l = (-(-k // n) for k in ks)
        return Lanes(j * s_r, s_r, j * s_s, s_s, j * s_l, s_l)

    @property
    def total(self) -> int:
        return self.n_r + self.n_s + self.n_l


def _lane_index(base: int, n: int, k: int, dev) -> torch.Tensor:
    """The global candidates of n lanes from base, clamped to the kind's last."""
    return torch.clamp(torch.arange(base, base + n, dtype=torch.int64, device=dev), max=max(k - 1, 0))


# ----------------------------------------------------------------------
# plain PyTorch version (the engine's candidate generation)
# ----------------------------------------------------------------------


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def _uniform(key: Key, n: int, dev) -> torch.Tensor:
    return threefry.uniform_plain(key.words, n, 0.0, 1.0, dev)


def _uniform_idx(key: Key, n: int, bound: int, dev) -> torch.Tensor:
    return threefry.uniform_idx_plain(key.words, n, bound, dev)


def _sample_sources(cp: CandParams, sx, keys4, n: int, plan) -> torch.Tensor:
    """n source replica ids: the last n_imp of them by the two-stage plan
    draw (broker ~ categorical, then a replica on it), the rest uniform
    over the valid prefix."""
    dev = sx.alive.device
    k1, k3, k4, k5 = keys4
    n_imp = cp.n_imp(n, plan)
    gen = sx.gen
    r = _uniform_idx(k1, n - n_imp, gen.n_source, dev)
    if n_imp:
        u = _uniform(k3, n_imp, dev)
        bsel = torch.minimum(
            torch.clamp(torch.searchsorted(plan.broker_cdf, u, right=True), min=0),
            gen.n_brokers - 1,
        )
        cnt = plan.count[bsel]
        j = (_uniform(k4, n_imp, dev) * cnt).to(torch.int32)
        r_imp = plan.order[torch.clamp(plan.start[bsel] + j, 0, sx.state.shape.R - 1)]
        fallback = _uniform_idx(k5, n_imp, gen.n_source, dev)
        r = torch.cat([r, torch.where(cnt > 0, r_imp, fallback)])
    return r


def _member_brokers(sx, carry, part: torch.Tensor) -> torch.Tensor:
    """[K, max_rf] current brokers of each partition's replicas, -1 on the
    table's padding."""
    R = sx.state.shape.R
    members = sx.part_replicas[part]
    vals = carry.replica_broker[torch.clamp(members, max=R - 1)]
    return torch.where(members < R, vals, -1)


def _topic_cell_delta(cp: CandParams, carry, g, t, b_from, b_to):
    """Topic-distribution cell change of one replica of topic t moving
    b_from -> b_to."""
    tt = cp.topic_tt
    upper = torch.ceil(g["topic_avg"][t] * tt)
    lower = torch.floor(g["topic_avg"][t] * max(0.0, 2.0 - tt))

    def cell(cnt):
        return _relu(cnt - upper) + _relu(lower - cnt)

    ct_f = carry.broker_topic_count[t, b_from].to(torch.float32)
    ct_t = carry.broker_topic_count[t, b_to].to(torch.float32)
    return (cell(ct_f - 1.0) - cell(ct_f)) + (cell(ct_t + 1.0) - cell(ct_t))


def _sample_dests(cp: CandParams, sx, keys: StepKeys, n: int, r: torch.Tensor):
    """(n destination positions into dest_ids, the took-the-prior mask or
    None) for relocations of the sources r: uniform over the real head of
    dest_ids, or, with the prior, each draw from its source topic's prior
    CDF where the mix draw falls below prior_mix (`_sample_dests`)."""
    dev = sx.alive.device
    uni = _uniform_idx(keys.rel_dst, n, sx.gen.n_dest, dev)
    if not cp.prior:
        return uni, None
    t = sx.state.replica_topic[torch.clamp(r, max=sx.state.shape.R - 1)]
    cdf = sx.prior_cdf[t]  # [n, B] per-topic inclusive CDF
    u = _uniform(keys.prior_p, n, dev)
    p_idx = torch.clamp((u[:, None] >= cdf).sum(-1).to(torch.int32), max=sx.gen.n_dest - 1)
    use = _uniform(keys.prior_m, n, dev) < sx.prior_mix
    return torch.where(use, p_idx, uni), use


def _replica_candidates(cp: CandParams, sx, carry, keys: StepKeys, g, plan, sl=None):
    """K_r replica-move candidates -> (delta, feasible, src, dst, part, payload);
    `sl` (an index of global candidates) keeps a slice of the draws."""
    st = sx.state
    K = cp.K_r
    r = _sample_sources(cp, sx, keys.rel_src, K, plan)
    pos, from_prior = _sample_dests(cp, sx, keys, K, r)
    if sl is not None:
        r, pos = r[sl], pos[sl]
        from_prior = None if from_prior is None else from_prior[sl]
    dst = sx.dest_ids[pos]
    src = carry.replica_broker[r]
    part = st.replica_partition[r]
    disk = carry.replica_disk[r]
    topic = st.replica_topic[r]
    valid = st.replica_valid[r]
    is_lead = carry.replica_is_leader[r]
    ll, lf = st.replica_load_leader[r], st.replica_load_follower[r]

    # feasibility (reference GoalUtils.legitMove:153 + exclusions)
    offline = ~(st.broker_alive[src] & st.disk_alive[src, disk])
    movable = sx.topic_movable[topic] | offline
    feasible = valid & movable & (src != dst)
    # no second replica of the partition on dst
    feasible &= ~(_member_brokers(sx, carry, part) == dst[:, None]).any(1)

    load = torch.where(is_lead[:, None], ll, lf)
    load = torch.where(valid[:, None], load, 0.0)

    # destination logdir: most-free alive disk on dst
    ddst_pct = carry.disk_load[dst] / (st.disk_capacity[dst] + 1e-12)
    ddst_pct = torch.where(st.disk_alive[dst], ddst_pct, float("inf"))
    d_dst = torch.argmin(ddst_pct, dim=1).to(torch.int32)

    pot = ll[:, _NW_OUT]
    lbin = torch.where(is_lead, ll[:, _NW_IN], 0.0)
    delta = md.move_delta_plain(
        cp.tp, sx, carry, g,
        src=src, dst=dst, dload_src=-load, dload_dst=load,
        dcount=torch.ones_like(r), dlcount=is_lead.to(torch.int32),
        dpot=pot, dlbin=lbin, dlbin_src=lbin, d_src=disk, d_dst=d_dst,
        ddisk=load[:, _DISK], ddisk_src=load[:, _DISK],
    )

    # rack cells (reference RackAwareGoal)
    rack_s, rack_d = st.broker_rack[src], st.broker_rack[dst]
    c_s = carry.part_rack_count[part, rack_s].to(torch.float32)
    c_d = carry.part_rack_count[part, rack_d].to(torch.float32)
    drack = (_relu(c_s - 2.0) - _relu(c_s - 1.0)) + (_relu(c_d) - _relu(c_d - 1.0))
    delta = delta + md.div(cp.w_rack * torch.where(rack_s != rack_d, drack, 0.0), sx.gen,
                           "n_valid")

    # topic cells (reference TopicReplicaDistributionGoal)
    if cp.w_topic != 0.0:
        dtop = _topic_cell_delta(cp, carry, g, topic, src, dst)
        delta = delta + cp.w_topic * dtop / g["total_count"]

    # offline-replica term (reference OptimizationVerifier BROKEN_BROKERS)
    dst_ok = st.broker_alive[dst] & st.disk_alive[dst, d_dst]
    doff = (~dst_ok).to(torch.float32) - offline.to(torch.float32)
    delta = delta + md.div(cp.w_offline * doff, sx.gen, "n_valid")

    # preferred-leader eligibility shift (reference PreferredLeaderElectionGoal)
    if cp.w_pref != 0.0:
        pref = (st.replica_pos[r] == 0) & valid & ~is_lead
        was = pref & ~offline
        now = pref & dst_ok
        delta = delta + cp.w_pref * (now.to(torch.float32) - was.to(torch.float32)) / cp.num_parts

    # movement pricing: cost to stray from the ORIGINAL broker, refunded
    # when moving home (reference ExecutionProposal data-to-move)
    if plan is not None and cp.replica_move_cost:
        orig = st.replica_broker[r]
        stray = (dst != orig).to(torch.float32) - (src != orig).to(torch.float32)
        delta = delta + plan.replica_cost * stray

    payload = dict(r=r, dst=dst, d_dst=d_dst, load=load, is_lead=is_lead,
                   pot=pot, lbin=lbin, d_src=disk, from_prior=from_prior)
    return delta, feasible, src, dst, part, payload


def _intra_candidates(cp: CandParams, sx, carry, keys: StepKeys, g, plan, sl=None):
    """K_r intra-broker disk moves (rebalance_disk mode): a replica moves to
    the most-free alive logdir of its own broker, so only the intra-broker
    disk terms, the offline term and the logdir pricing move.  Returned in
    the relocation rows' shape with src == dst."""
    st = sx.state
    K = cp.K_r
    D = st.shape.max_disks_per_broker
    r = _sample_sources(cp, sx, keys.rel_src, K, plan)
    if sl is not None:
        r = r[sl]
    K = int(r.shape[0])
    b = carry.replica_broker[r]
    d_src = carry.replica_disk[r]
    part = st.replica_partition[r]
    topic = st.replica_topic[r]
    valid = st.replica_valid[r]
    is_lead = carry.replica_is_leader[r]
    ll, lf = st.replica_load_leader[r], st.replica_load_follower[r]

    # destination logdir: most-free alive disk on b, the current slot excluded
    oh_s = torch.nn.functional.one_hot(d_src.long(), D)
    pct = carry.disk_load[b] / (st.disk_capacity[b] + 1e-12)
    pct = torch.where(st.disk_alive[b], pct, float("inf"))
    pct = torch.where(oh_s.bool(), float("inf"), pct)
    d_dst = torch.argmin(pct, dim=1).to(torch.int32)

    off_src = ~(st.broker_alive[b] & st.disk_alive[b, d_src])
    movable = sx.topic_movable[topic] | off_src
    dst_ok = st.broker_alive[b] & st.disk_alive[b, d_dst]
    feasible = valid & movable & dst_ok & (d_dst != d_src)

    load = torch.where(is_lead[:, None], ll, lf)
    load = torch.where(valid[:, None], load, 0.0)
    ddisk = load[:, _DISK]

    # one broker, one row reshuffled
    f32 = torch.float32
    if cp.tp.has_disk_terms:
        row = carry.disk_load[b]
        shift = (torch.nn.functional.one_hot(d_dst.long(), D).to(f32) - oh_s.to(f32)) * ddisk[:, None]
        bsum = row.sum(-1)
        delta = (md.disk_terms(cp.tp, sx, b, row + shift, bsum, g)
                 - md.disk_terms(cp.tp, sx, b, row, bsum, g))
    else:
        delta = torch.zeros(K, dtype=f32, device=b.device)
    # offline-replica shift (rescuing off a failed logdir)
    delta = delta + md.div(cp.w_offline * ((~dst_ok).to(f32) - off_src.to(f32)), sx.gen,
                           "n_valid")
    # movement pricing against the ORIGINAL logdir (the executor copies the
    # whole replica)
    if plan is not None and cp.replica_move_cost:
        orig = st.replica_disk[r]
        stray = (d_dst != orig).to(f32) - (d_src != orig).to(f32)
        delta = delta + plan.replica_cost * stray

    payload = dict(r=r, dst=b, d_dst=d_dst, load=load, is_lead=is_lead, pot=ll[:, _NW_OUT],
                   lbin=torch.where(is_lead, ll[:, _NW_IN], 0.0), d_src=d_src, from_prior=None)
    return delta, feasible, b, b, part, payload


def _swap_candidates(cp: CandParams, sx, carry, keys: StepKeys, g, plan, sl=None):
    """K_s replica-swap candidates: r <-> q exchange brokers (and disk
    slots), escaping local optima single relocations cannot leave
    (reference ResourceDistributionGoal swap-in/out :502-599).

    Returns (delta, feasible, src, dst, part_r, part_q, payload)."""
    st = sx.state
    K = cp.K_s
    dev = sx.alive.device
    if K == 0 or (sl is not None and sl.numel() == 0):
        z = torch.zeros(0, dtype=torch.float32, device=dev)
        zi = torch.zeros(0, dtype=torch.int32, device=dev)
        zb = torch.zeros(0, dtype=torch.bool, device=dev)
        zl = torch.zeros((0, NUM_RESOURCES), dtype=torch.float32, device=dev)
        payload = dict(r=zi, q=zi, load_r=zl, load_q=zl, lead_r=zb, lead_q=zb,
                       pot_r=z, pot_q=z, lbin_r=z, lbin_q=z, d_r=zi, d_q=zi)
        return z, zb, zi, zi, zi, zi, payload
    r = _sample_sources(cp, sx, keys.swap_src, K, plan)
    q = _uniform_idx(keys.swap_q, K, sx.gen.n_source, dev)
    if sl is not None:
        r, q = r[sl], q[sl]
    src, dst = carry.replica_broker[r], carry.replica_broker[q]
    part_r, part_q = st.replica_partition[r], st.replica_partition[q]
    d_r, d_q = carry.replica_disk[r], carry.replica_disk[q]
    topic_r, topic_q = st.replica_topic[r], st.replica_topic[q]
    valid_r, valid_q = st.replica_valid[r], st.replica_valid[q]
    lead_r, lead_q = carry.replica_is_leader[r], carry.replica_is_leader[q]
    ll_r, ll_q = st.replica_load_leader[r], st.replica_load_leader[q]

    off_r = ~(st.broker_alive[src] & st.disk_alive[src, d_r])
    off_q = ~(st.broker_alive[dst] & st.disk_alive[dst, d_q])
    movable_r = sx.topic_movable[topic_r] | off_r
    movable_q = sx.topic_movable[topic_q] | off_q
    feasible = (
        valid_r & valid_q & movable_r & movable_q
        & (src != dst)
        & (part_r != part_q)
        # both ends receive a replica, so both must be allowed destinations
        & sx.dest_ok[src] & sx.dest_ok[dst]
        # each replica inherits the other's disk slot, which must be alive
        & st.disk_alive[dst, d_q] & st.disk_alive[src, d_r]
    )
    # neither partition may end up duplicated on its new broker
    feasible &= ~(_member_brokers(sx, carry, part_r) == dst[:, None]).any(1)
    feasible &= ~(_member_brokers(sx, carry, part_q) == src[:, None]).any(1)

    load_r = torch.where(lead_r[:, None], ll_r, st.replica_load_follower[r])
    load_r = torch.where(valid_r[:, None], load_r, 0.0)
    load_q = torch.where(lead_q[:, None], ll_q, st.replica_load_follower[q])
    load_q = torch.where(valid_q[:, None], load_q, 0.0)
    pot_r, pot_q = ll_r[:, _NW_OUT], ll_q[:, _NW_OUT]
    lbin_r = torch.where(lead_r, ll_r[:, _NW_IN], 0.0)
    lbin_q = torch.where(lead_q, ll_q[:, _NW_IN], 0.0)

    # r -> (dst, q's disk slot), q -> (src, r's disk slot)
    ddisk = load_r[:, _DISK] - load_q[:, _DISK]
    delta = md.move_delta_plain(
        cp.tp, sx, carry, g,
        src=src, dst=dst, dload_src=load_q - load_r, dload_dst=load_r - load_q,
        dcount=torch.zeros_like(r), dlcount=lead_r.to(torch.int32) - lead_q.to(torch.int32),
        dpot=pot_r - pot_q, dlbin=lbin_r - lbin_q, dlbin_src=lbin_r - lbin_q,
        d_src=d_r, d_dst=d_q, ddisk=ddisk, ddisk_src=ddisk,
    )

    # rack cells for both partitions
    rack_s, rack_d = st.broker_rack[src], st.broker_rack[dst]

    def rack_delta(part, rack_from, rack_to):
        c_f = carry.part_rack_count[part, rack_from].to(torch.float32)
        c_t = carry.part_rack_count[part, rack_to].to(torch.float32)
        d = (_relu(c_f - 2.0) - _relu(c_f - 1.0)) + (_relu(c_t) - _relu(c_t - 1.0))
        return torch.where(rack_from != rack_to, d, 0.0)

    delta = delta + md.div(cp.w_rack * (
        rack_delta(part_r, rack_s, rack_d) + rack_delta(part_q, rack_d, rack_s)
    ), sx.gen, "n_valid")

    if cp.w_topic != 0.0:
        delta = delta + cp.w_topic * (
            _topic_cell_delta(cp, carry, g, topic_r, src, dst)
            + _topic_cell_delta(cp, carry, g, topic_q, dst, src)
        ) / g["total_count"]

    # offline-replica shifts for both replicas
    r_ok = st.broker_alive[dst] & st.disk_alive[dst, d_q]
    q_ok = st.broker_alive[src] & st.disk_alive[src, d_r]
    f32 = torch.float32
    doff = (~r_ok).to(f32) - off_r.to(f32) + (~q_ok).to(f32) - off_q.to(f32)
    delta = delta + md.div(cp.w_offline * doff, sx.gen, "n_valid")

    if cp.w_pref != 0.0:
        def pref_delta(x, valid_x, was_off, now_ok, lead):
            pref = (st.replica_pos[x] == 0) & valid_x & ~lead
            return (pref & now_ok).to(f32) - (pref & ~was_off).to(f32)

        delta = delta + cp.w_pref * (
            pref_delta(r, valid_r, off_r, r_ok, lead_r) + pref_delta(q, valid_q, off_q, q_ok, lead_q)
        ) / cp.num_parts

    if plan is not None and cp.replica_move_cost:
        orig_r, orig_q = st.replica_broker[r], st.replica_broker[q]
        stray = (
            (dst != orig_r).to(f32) - (src != orig_r).to(f32)
            + (src != orig_q).to(f32) - (dst != orig_q).to(f32)
        )
        delta = delta + plan.replica_cost * stray

    payload = dict(r=r, q=q, load_r=load_r, load_q=load_q, lead_r=lead_r, lead_q=lead_q,
                   pot_r=pot_r, pot_q=pot_q, lbin_r=lbin_r, lbin_q=lbin_q, d_r=d_r, d_q=d_q)
    return delta, feasible, src, dst, part_r, part_q, payload


def _leadership_candidates(cp: CandParams, sx, carry, keys: StepKeys, g, plan, sl=None):
    """K_l leadership-transfer candidates (reference relocateLeadership:374)."""
    st = sx.state
    K = cp.K_l
    R = st.shape.R
    dev = sx.alive.device
    if K == 0 or (sl is not None and sl.numel() == 0):
        z = torch.zeros(0, dtype=torch.float32, device=dev)
        zi = torch.zeros(0, dtype=torch.int32, device=dev)
        zb = torch.zeros(0, dtype=torch.bool, device=dev)
        zl = torch.zeros((0, NUM_RESOURCES), dtype=torch.float32, device=dev)
        payload = dict(rf=zi, rt=zi, dl_f=zl, dl_t=zl, dlbin_src=z, dlbin_dst=z)
        return z, zb, zi, zi, zi, payload
    rt = _uniform_idx(keys.lead, K, sx.gen.n_source, dev)
    if sl is not None:
        rt = rt[sl]
    K = int(rt.shape[0])
    part = st.replica_partition[rt]
    members = sx.part_replicas[part]  # [K, max_rf]
    m_idx = torch.clamp(members, max=R - 1)
    m_lead = torch.where(members < R, carry.replica_is_leader[m_idx], False)
    first_lead = torch.argmax(m_lead.to(torch.int8), dim=1)
    rf = m_idx.gather(1, first_lead[:, None]).squeeze(1)

    src, dst = carry.replica_broker[rf], carry.replica_broker[rt]
    disk_f, disk_t = carry.replica_disk[rf], carry.replica_disk[rt]
    dst_ok = st.broker_alive[dst] & st.disk_alive[dst, disk_t]
    feasible = (
        st.replica_valid[rt] & ~carry.replica_is_leader[rt] & m_lead.any(1)
        & dst_ok & sx.lead_ok[dst]
    )

    # load shift: rf leader->follower on src, rt follower->leader on dst
    ll_f, ll_t = st.replica_load_leader[rf], st.replica_load_leader[rt]
    dl_f = st.replica_load_follower[rf] - ll_f  # [K, 4]
    dl_t = ll_t - st.replica_load_follower[rt]
    dlbin = ll_t[:, _NW_IN]  # gained by dst
    dlbin_src = ll_f[:, _NW_IN]  # lost by src
    delta = md.move_delta_plain(
        cp.tp, sx, carry, g,
        src=src, dst=dst, dload_src=dl_f, dload_dst=dl_t,
        dcount=torch.zeros_like(rt), dlcount=torch.ones_like(rt),
        dpot=torch.zeros(K, dtype=torch.float32, device=dev),
        dlbin_src=dlbin_src, dlbin=dlbin,
        d_src=disk_f, d_dst=disk_t, ddisk_src=dl_f[:, _DISK], ddisk=dl_t[:, _DISK],
    )

    f32 = torch.float32
    if cp.w_pref != 0.0:
        src_ok = st.broker_alive[src] & st.disk_alive[src, disk_f]
        pref_f = (st.replica_pos[rf] == 0) & src_ok  # rf becomes violating
        pref_t = (st.replica_pos[rt] == 0) & dst_ok  # rt stops violating
        delta = delta + cp.w_pref * (pref_f.to(f32) - pref_t.to(f32)) / cp.num_parts

    # movement pricing: a new leader that is not the partition's ORIGINAL
    # leader pays; restoring the original leader refunds
    if plan is not None and cp.leadership_move_cost:
        stray = (~st.replica_is_leader[rt]).to(f32) - (~st.replica_is_leader[rf]).to(f32)
        delta = delta + plan.lead_cost * stray

    payload = dict(rf=rf, rt=rt, dl_f=dl_f, dl_t=dl_t, dlbin_src=dlbin_src, dlbin_dst=dlbin)
    return delta, feasible, src, dst, part, payload


def _assemble_prop(sx, carry, raw_r, raw_s, raw_l) -> dict:
    """Concatenate the per-kind bundles into the selection/apply bundle;
    a swap applies as two linked relocation rows.  The relocations'
    took-the-prior mask rides beside the bundle as `from_prior` (None
    without the prior): the diagnostics count it, the scatter never
    reads it."""
    st = sx.state
    dr, fr, sr, tr, pr, payr = raw_r
    payr = dict(payr)
    from_prior = payr.pop("from_prior")
    ds, fs, ss, ts, ps1, ps2, pays = raw_s
    dl, fl, sl, tl, pl, payl = raw_l
    r_ext = torch.cat([payr["r"], pays["r"], pays["q"]])
    payr_ext = dict(
        r=r_ext,
        src=torch.cat([sr, ss, ts]),
        dst=torch.cat([payr["dst"], ts, ss]),
        d_dst=torch.cat([payr["d_dst"], pays["d_q"], pays["d_r"]]),
        load=torch.cat([payr["load"], pays["load_r"], pays["load_q"]]),
        is_lead=torch.cat([payr["is_lead"], pays["lead_r"], pays["lead_q"]]),
        pot=torch.cat([payr["pot"], pays["pot_r"], pays["pot_q"]]),
        lbin=torch.cat([payr["lbin"], pays["lbin_r"], pays["lbin_q"]]),
        d_src=torch.cat([payr["d_src"], pays["d_r"], pays["d_q"]]),
        topic=st.replica_topic[r_ext],
        part=torch.cat([pr, ps1, ps2]),
    )
    payl_ext = dict(
        payl, src_b=sl, dst_b=tl,
        d_f=carry.replica_disk[payl["rf"]], d_t=carry.replica_disk[payl["rt"]],
    )
    return dict(
        delta=torch.cat([dr, ds, dl]),
        feas=torch.cat([fr, fs, fl]),
        src=torch.cat([sr, ss, sl]),
        dst=torch.cat([tr, ts, tl]),
        # two partition lanes: swaps touch two partitions, other kinds
        # duplicate their single partition
        part1=torch.cat([pr, ps1, pl]),
        part2=torch.cat([pr, ps2, pl]),
        nr=int(dr.shape[0]), ns=int(ds.shape[0]), payr=payr_ext, payl=payl_ext,
        from_prior=from_prior,
    )


def accept_plain(keys: StepKeys, delta, feas, temperature, index=None, k: int | None = None
                 ) -> torch.Tensor:
    """Metropolis acceptance: delta < -T log u - 1e-12 (greedy at T=0);
    T an f32 value or an f32[1] tensor.  `index` (of the k candidates of
    the full step) picks each lane's u from the full-K stream."""
    n = int(delta.shape[0]) if index is None else int(k)
    u = threefry.uniform_plain(keys.u.words, n, U_MIN, 1.0, delta.device)
    if index is not None:
        u = u[index]
    thresh = -temperature * torch.log(u)
    return feas & (delta < thresh - 1e-12)


def candidates_plain(cp: CandParams, sx, carry, keys, g, plan, temperature,
                     lanes: Lanes | None = None) -> dict:
    """`keys` a StepKeys or a KeyCursor (read on the host), `temperature`
    an f32 value or an f32[1] tensor, `lanes` the slice of the candidate
    axis to run (all of it when None)."""
    if isinstance(keys, KeyCursor):
        keys = keys.step_keys()
    sl_r = sl_s = sl_l = index = None
    if lanes is not None:
        dev = sx.alive.device
        sl_r = _lane_index(lanes.base_r, lanes.n_r, cp.K_r, dev)
        sl_s = _lane_index(lanes.base_s, lanes.n_s, cp.K_s, dev)
        sl_l = _lane_index(lanes.base_l, lanes.n_l, cp.K_l, dev)
        index = torch.cat([sl_r, cp.K_r + sl_s, cp.K_r + cp.K_s + sl_l])
    prop = _assemble_prop(
        sx, carry,
        (_intra_candidates if cp.intra else _replica_candidates)(cp, sx, carry, keys, g, plan, sl_r),
        _swap_candidates(cp, sx, carry, keys, g, plan, sl_s),
        _leadership_candidates(cp, sx, carry, keys, g, plan, sl_l),
    )
    prop["accept"] = accept_plain(keys, prop["delta"], prop["feas"], temperature, index,
                                  cp.K_r + cp.K_s + cp.K_l)
    return prop


# ----------------------------------------------------------------------
# kernel
# ----------------------------------------------------------------------


class _Dims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "K_r", "K_s", "K_l", "n_imp_r", "n_imp_s", "base_r", "base_s", "base_l", "n_r", "n_s",
        "n_l", "R", "B", "P", "T", "D", "H", "racks",
        "max_rf", "has_plan", "has_topic", "has_pref",
        "price_r", "price_l", "cdf_in_smem", "intra", "step", "steps_per_round", "prior", "bf16",
        "shard",
    )]


class _Scalars(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float) for f in (
        "w_rack", "w_offline", "w_topic", "w_pref", "topic_tt", "topic_tt_low", "num_parts",
        "u_min", "u_span",
    )]


_IN_FIELDS = (
    # state
    "orig_broker", "part_of", "topic_of", "valid", "pos", "orig_lead", "orig_disk", "load_leader",
    "load_follower", "broker_alive", "broker_rack", "broker_host", "capacity", "disk_alive",
    "disk_capacity",
    # statics
    "part_replicas", "alive", "dest_ids", "dest_ok", "lead_ok", "topic_movable", "host_multi",
    "host_cap",
    # carry
    "replica_broker", "replica_is_leader", "replica_disk", "broker_load", "rcount", "lcount",
    "pot", "lbin", "topic_count", "part_rack_count", "disk_load", "host_load",
    # per-step globals and the round's plan
    "g", "topic_avg", "cdf", "order", "start", "count", "replica_cost", "lead_cost",
    # the run's key table, the round index and the round's temperature
    "key_table", "rnd", "temperature",
    # the learned prior: its draws' keys, the per-topic CDF and the mix
    "prior_keys", "prior_cdf", "prior_mix",
    # the engine's generation block
    "gen",
    # the sharded-model mode's assembled bundles (kernels/model_shard.py)
    "sh_ids", "sh_rows", "sh_parts", "sh_mb", "sh_ml",
)
_OUT_FIELDS = (
    "delta", "feas", "accept", "src", "dst", "part1", "part2",
    "r", "r_src", "r_dst", "d_src", "d_dst", "load", "is_lead", "pot", "lbin", "topic", "part",
    "rf", "rt", "src_b", "dst_b", "dl_f", "dl_t", "dlbin_src", "dlbin_dst", "d_f", "d_t",
    "from_prior",
)


class _Inputs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in _IN_FIELDS]


class _Outputs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in _OUT_FIELDS]


#: dynamic shared memory the kernel may take for the broker CDF (below the
#: card's 227 KB a block can use)
CDF_SMEM_MAX = 200 * 1024


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("candidates").cc_candidates
        fn.argtypes = [_Dims, md.MDParams, _Scalars, _Inputs, _Outputs, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _ptr(name, t, dtype, shape) -> int:
    """The data pointer of a contiguous tensor of this type and shape
    (rows of four floats 16-byte aligned: the kernel loads them whole)."""
    aligned = not (len(shape) == 2 and shape[1] == 4) or t.data_ptr() % 16 == 0
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or not aligned:
        raise ValueError(
            f"candidates: {name} must be contiguous {dtype}{list(shape)} (rows of 4 aligned "
            f"to 16 bytes), got {t.dtype}{list(t.shape)} contiguous={t.is_contiguous()}"
        )
    return t.data_ptr()


def buffer_layout(prior: bool, ln: Lanes) -> dict:
    """{group: {field: (shape, dtype)}} of a launch's outputs (the bundle
    `out`, with the relocations' took-the-prior mask under the prior, the
    relocation rows `payr`, the leadership rows `payl`), sized by the
    launch's lanes."""
    K_r, K_s, K_l = ln.n_r, ln.n_s, ln.n_l
    K, nr = K_r + K_s + K_l, K_r + 2 * K_s
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    out = dict(delta=((K,), f32), feas=((K,), b8), accept=((K,), b8), src=((K,), i32),
               dst=((K,), i32), part1=((K,), i32), part2=((K,), i32))
    if prior:
        out["from_prior"] = ((K_r,), b8)
    payr = dict(r=((nr,), i32), src=((nr,), i32), dst=((nr,), i32), d_src=((nr,), i32),
                d_dst=((nr,), i32), load=((nr, 4), f32), is_lead=((nr,), b8), pot=((nr,), f32),
                lbin=((nr,), f32), topic=((nr,), i32), part=((nr,), i32))
    payl = dict(rf=((K_l,), i32), rt=((K_l,), i32), src_b=((K_l,), i32), dst_b=((K_l,), i32),
                dl_f=((K_l, 4), f32), dl_t=((K_l, 4), f32), dlbin_src=((K_l,), f32),
                dlbin_dst=((K_l,), f32), d_f=((K_l,), i32), d_t=((K_l,), i32))
    return dict(out=out, payr=payr, payl=payl)


def candidate_buffers(cp: CandParams, device, lanes: Lanes | None = None) -> dict:
    """The kernel's outputs, allocated once and reused by every step: the
    bundle (with the relocations' took-the-prior mask under the prior),
    the relocation rows `payr` and the leadership rows `payl`, sized by
    `lanes` (all K when None)."""
    return {grp: {k: torch.empty(shape, dtype=dt, device=device) for k, (shape, dt) in fields.items()}
            for grp, fields in buffer_layout(cp.prior, lanes or Lanes.full(cp)).items()}


def candidates_cuda(cp: CandParams, sx, carry, keys: KeyCursor, g, plan, temperature: torch.Tensor,
                    bufs: dict | None = None, lanes: Lanes | None = None, shard=None) -> dict:
    """The launch; `shard` (a `ShardBundles`) runs the sharded-model body:
    every replica and partition row from the assembled bundles, R and P
    the global counts of `shard.shape`."""
    st = sx.state
    s = st.shape if shard is None else shard.shape
    dev = carry.broker_load.device
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    B, R, P, T, D, H = s.B, s.R, s.P, s.num_topics, s.max_disks_per_broker, s.num_hosts
    racks, max_rf = s.num_racks, int(sx.part_replicas.shape[1])
    K_r, K_s, K_l = cp.K_r, cp.K_s, cp.K_l
    n_keys = int(keys.table.shape[0])
    rows = {} if shard is not None else dict(
        orig_broker=(st.replica_broker, i32, (R,)), part_of=(st.replica_partition, i32, (R,)),
        topic_of=(st.replica_topic, i32, (R,)), valid=(st.replica_valid, b8, (R,)),
        pos=(st.replica_pos, i32, (R,)), orig_lead=(st.replica_is_leader, b8, (R,)),
        orig_disk=(st.replica_disk, i32, (R,)),
        load_leader=(st.replica_load_leader, f32, (R, 4)),
        load_follower=(st.replica_load_follower, f32, (R, 4)),
        part_replicas=(sx.part_replicas, i32, (P, max_rf)),
        replica_broker=(carry.replica_broker, i32, (R,)),
        replica_is_leader=(carry.replica_is_leader, b8, (R,)),
        replica_disk=(carry.replica_disk, i32, (R,)),
        part_rack_count=(carry.part_rack_count, i32, (P, racks)),
    )
    inputs = dict(
        rows,
        broker_alive=(st.broker_alive, b8, (B,)), broker_rack=(st.broker_rack, i32, (B,)),
        broker_host=(st.broker_host, i32, (B,)), capacity=(st.broker_capacity, f32, (B, 4)),
        disk_alive=(st.disk_alive, b8, (B, D)), disk_capacity=(st.disk_capacity, f32, (B, D)),
        alive=(sx.alive, b8, (B,)),
        dest_ids=(sx.dest_ids, i32, (B,)), dest_ok=(sx.dest_ok, b8, (B,)),
        lead_ok=(sx.lead_ok, b8, (B,)), topic_movable=(sx.topic_movable, b8, (T,)),
        host_multi=(sx.host_multi, b8, (H,)), host_cap=(sx.host_cap, f32, (H, 4)),
        broker_load=(carry.broker_load, f32, (B, 4)),
        rcount=(carry.broker_replica_count, i32, (B,)), lcount=(carry.broker_leader_count, i32, (B,)),
        pot=(carry.broker_potential_nw_out, f32, (B,)), lbin=(carry.broker_leader_bytes_in, f32, (B,)),
        topic_count=(carry.broker_topic_count, i32, (T, B)),
        disk_load=(carry.disk_load, f32, (B, D)), host_load=(carry.host_load, f32, (H, 4)),
        g=(g["vec"], f32, (23,)), topic_avg=(g["topic_avg"], f32, (T,)),
        key_table=(keys.table, i32, (n_keys, KEY_WORDS)), rnd=(keys.rnd, i32, (1,)),
        temperature=(temperature, f32, (1,)), gen=(sx.gen.words, i32, (md.GEN_WORDS,)),
    )
    if cp.prior:
        if keys.prior is None:
            raise ValueError("candidates: a prior-enabled step needs the prior's keys")
        inputs.update(
            prior_keys=(keys.prior, i32, (n_keys, PRIOR_KEY_WORDS)),
            prior_cdf=(sx.prior_cdf, f32, (T, B)), prior_mix=(sx.prior_mix, f32, (1,)),
        )
    if plan is not None:
        inputs.update(
            cdf=(plan.broker_cdf, f32, (B,)),
            replica_cost=(plan.replica_cost, f32, ()), lead_cost=(plan.lead_cost, f32, ()),
        )
        if shard is None:
            inputs.update(order=(plan.order, i32, (R,)), start=(plan.start, i32, (B,)),
                          count=(plan.count, i32, (B,)))
    if shard is not None:
        if cp.intra or cp.prior:
            raise ValueError("candidates: the sharded-model body runs the default kinds only "
                             "(no intra-broker moves, no learned prior)")
        n_rs = K_r + 2 * K_s
        sl = n_rs + K_l
        inputs.update(
            sh_ids=(shard.ids, i32, (sl,)), sh_rows=(shard.rows, i32, (sl, shard.row_words)),
            sh_parts=(shard.parts, i32, (sl, max_rf + racks)),
            sh_mb=(shard.mb, i32, (n_rs * max_rf, 1)),
            sh_ml=(shard.ml, i32, (K_l * max_rf, shard.row_words)),
        )
    c_in = _Inputs(**{k: _ptr(k, *v) for k, v in inputs.items()})
    ln = lanes or Lanes.full(cp)
    if bufs is None:
        bufs = candidate_buffers(cp, dev, ln)
    out, payr, payl = bufs["out"], bufs["payr"], bufs["payl"]
    if int(out["delta"].shape[0]) != ln.total or int(payl["rf"].shape[0]) != ln.n_l:
        raise ValueError("candidates: the output buffers are not sized by the launch's lanes")
    rows = {("r_" + k if k in ("src", "dst") else k): t for k, t in payr.items()}
    if cp.prior and "from_prior" not in out:
        raise ValueError("candidates: a prior-enabled step needs a from_prior buffer")
    c_out = _Outputs(**{k: t.data_ptr() for k, t in {**out, **rows, **payl}.items()})
    tt = cp.topic_tt
    dims = _Dims(
        K_r=K_r, K_s=K_s, K_l=K_l, n_imp_r=cp.n_imp(K_r, plan), n_imp_s=cp.n_imp(K_s, plan),
        base_r=ln.base_r, base_s=ln.base_s, base_l=ln.base_l, n_r=ln.n_r, n_s=ln.n_s, n_l=ln.n_l,
        R=R, B=B, P=P, T=T, D=D, H=H, racks=racks, max_rf=max_rf, has_plan=plan is not None,
        has_topic=cp.w_topic != 0.0, has_pref=cp.w_pref != 0.0,
        price_r=plan is not None and bool(cp.replica_move_cost),
        price_l=plan is not None and bool(cp.leadership_move_cost),
        cdf_in_smem=plan is not None and 4 * B <= CDF_SMEM_MAX, intra=cp.intra,
        step=keys.step, steps_per_round=keys.steps_per_round, prior=cp.prior, bf16=cp.tp.bf16,
        shard=shard is not None,
    )
    lo = np.float32(U_MIN)
    scalars = _Scalars(
        w_rack=cp.w_rack, w_offline=cp.w_offline, w_topic=cp.w_topic, w_pref=cp.w_pref,
        topic_tt=tt, topic_tt_low=max(0.0, 2.0 - tt), num_parts=float(cp.num_parts),
        u_min=float(lo), u_span=float(np.float32(np.float32(1.0) - lo)),
    )
    if ln.total > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _fn()(dims, cp.tp.c_struct, scalars, c_in, c_out, stream)
        _build.check(status, "candidates")
        kernels.count("candidates" if shard is None else "candidates_shard")
    return dict(out, nr=ln.n_r, ns=ln.n_s, payr=payr, payl=payl, from_prior=out.get("from_prior"))


def candidates(cp: CandParams, sx, carry, keys, g, plan, temperature, bufs: dict | None = None,
               lanes: Lanes | None = None) -> dict:
    """One step's candidate bundle (delta, feas, accept, src, dst, part1,
    part2, nr, ns, payr, payl): the kernel for CUDA tensors, writing into
    `bufs` (`candidate_buffers`) when given, the plain version for CPU
    tensors.  `keys` is a KeyCursor (a StepKeys is uploaded as one row),
    `g` the step's globals as `step_globals` returns them (the kernel reads
    their "vec"), `temperature` an f32[1] tensor (a float is uploaded).
    `lanes` runs a slice of the candidate axis (`Lanes.shard`), laid out
    by its own lane counts; all K when None."""
    if kernels.route(carry.broker_load, carry.replica_broker, sx.alive) == "cpu":
        return candidates_plain(cp, sx, carry, keys, g, plan, temperature, lanes)
    dev = carry.broker_load.device
    if not isinstance(keys, KeyCursor):
        keys = KeyCursor.of(keys, dev)
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.full((1,), float(temperature), dtype=torch.float32, device=dev)
    return candidates_cuda(cp, sx, carry, keys, g, plan, temperature, bufs, lanes)


# ----------------------------------------------------------------------
# the sharded-model mode's body (parallel/model_shard.py)
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardBundles:
    """A step's assembled bundles (kernels/model_shard.py): by slot the
    source ids i32[n], their rows i32[n, row_words], their partitions' rows
    i32[n, max_rf + racks]; the members' brokers i32[(K_r + 2 K_s) max_rf, 1]
    and the leadership members' rows i32[K_l max_rf, row_words]; `shape` the
    global (padded) ClusterShape."""

    ids: torch.Tensor
    rows: torch.Tensor
    parts: torch.Tensor
    mb: torch.Tensor
    ml: torch.Tensor
    shape: object
    row_words: int = 18


class _Rows:
    """A replica- or partition-indexed column served from a step's bundles:
    indexed with global ids (any shape; a (row ids, column) pair for a
    table), it returns the gathered values.  Every id the step's code
    indexes was gathered."""

    def __init__(self, keys: torch.Tensor, values: torch.Tensor):
        k = keys.reshape(-1).long()
        order = torch.argsort(k, stable=True)
        self.k, self.v = k[order], values[order]

    def _pos(self, idx: torch.Tensor) -> torch.Tensor:
        pos = torch.searchsorted(self.k, idx.reshape(-1).long())
        return torch.clamp(pos, max=max(int(self.k.numel()) - 1, 0))

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            rows, col = idx
            return self.v[self._pos(rows), col.reshape(-1).long()].reshape(rows.shape)
        return self.v[self._pos(idx)].reshape(tuple(idx.shape) + tuple(self.v.shape[1:]))


def _ns(obj, **over):
    """A namespace of a dataclass's fields with some replaced."""
    import types

    return types.SimpleNamespace(**{**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)},
                                    **over})


def candidates_shard_plain(cp: CandParams, sx, carry, keys, g, sp, temperature,
                           sh: ShardBundles) -> dict:
    """The sharded-model body as the plain engine's candidate code: the
    statics, carry and plan are views whose replica and partition columns
    are served from the bundles (`_Rows`), so the arithmetic is
    `candidates_plain`'s, bit for bit."""
    from cruise_control_tpu_torch.kernels import model_shard as ms_k

    if isinstance(keys, KeyCursor):
        keys = keys.step_keys()
    st = sx.state
    gs = sh.shape
    max_rf = int(sx.part_replicas.shape[1])
    sl = ms_k.slots(cp.K_r, cp.K_s, cp.K_l)
    i32 = torch.int32
    mem = sh.parts[:, :max_rf]
    rs_members, lead_members = mem[: sl["lead"]].reshape(-1), mem[sl["lead"]:].reshape(-1)
    key_ids = torch.cat([sh.ids, lead_members])
    full = torch.cat([sh.rows, sh.ml])

    def col(w, dtype):
        v = full[:, w]
        return _Rows(key_ids, v.to(torch.bool) if dtype == torch.bool else v)

    def loads(w0):
        return _Rows(key_ids, full[:, w0: w0 + 4].contiguous().view(torch.float32))

    broker = _Rows(torch.cat([sh.ids, lead_members, rs_members]),
                   torch.cat([sh.rows[:, 0], sh.ml[:, 0], sh.mb[:, 0]]))
    b8 = torch.bool
    state = _ns(st, shape=gs, replica_partition=col(1, i32), replica_topic=col(3, i32),
                replica_valid=col(4, b8), replica_pos=col(6, i32), replica_broker=col(7, i32),
                replica_is_leader=col(8, b8), replica_disk=col(9, i32),
                replica_load_leader=loads(10), replica_load_follower=loads(14))
    sxv = _ns(sx, state=state, part_replicas=_Rows(sh.rows[:, 1], mem))
    carryv = _ns(carry, replica_broker=broker, replica_is_leader=col(5, b8),
                 replica_disk=col(2, i32), part_rack_count=_Rows(sh.rows[:, 1], sh.parts[:, max_rf:]))
    # the plan: the global grouped order at the positions this step drew
    pos, val = [], []
    for n, keys4, at in ((cp.K_r, keys.rel_src, sl["rel"]), (cp.K_s, keys.swap_src, sl["swap_r"])):
        n_imp = cp.n_imp(n, sp)
        if n_imp:
            bsel, j, _ = ms_k.importance_draws(keys4, n, n_imp, sp.broker_cdf, sp.count, sx.gen,
                                               sp.count.device)
            hit = sp.count[bsel] > 0
            pos.append(torch.clamp(sp.start_global[bsel] + j, 0, gs.R - 1)[hit])
            val.append(sh.ids[at + n - n_imp: at + n][hit])
    order = _Rows(torch.cat(pos) if pos else torch.zeros(0, dtype=torch.int64),
                  torch.cat(val) if val else torch.zeros(0, dtype=i32))
    plan = None if sp is None else _ns(sp, order=order, start=sp.start_global)
    return candidates_plain(cp, sxv, carryv, keys, g, plan, temperature)


def candidates_shard(cp: CandParams, sx, carry, keys, g, sp, temperature, sh: ShardBundles,
                     bufs: dict | None = None) -> dict:
    """One sharded-model step's candidate bundle from the assembled
    bundles `sh` (the kernel's SHARD body for CUDA tensors, the plain
    version for CPU tensors); `sp` the round's ShardPlan."""
    if kernels.route(carry.broker_load, sh.ids, sx.alive) == "cpu":
        return candidates_shard_plain(cp, sx, carry, keys, g, sp, temperature, sh)
    dev = carry.broker_load.device
    if not isinstance(keys, KeyCursor):
        keys = KeyCursor.of(keys, dev)
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.full((1,), float(temperature), dtype=torch.float32, device=dev)
    return candidates_cuda(cp, sx, carry, keys, g, sp, temperature, bufs, None, shard=sh)
