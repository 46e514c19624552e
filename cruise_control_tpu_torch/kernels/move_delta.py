"""move_delta — exact objective deltas of K candidate moves.

Replaces: `Engine._move_delta` (cruise_control_tpu/analyzer/engine.py:2439)
with `_broker_terms` (:1656), `_host_terms` (:1747) and `_tie_term` (:1795),
reached by all three candidate kinds (relocation, swap, leadership).

Bound on the card: bytes.  Each candidate gathers the src and dst rows of
the carry's broker aggregates, capacities and host load (~90 bytes a
broker) and does a few hundred flops; K=16384 candidates move ~3 MB at
most, microseconds of HBM time, so launch latency dominates.  Design: one
thread per candidate evaluates the four broker lanes (src/dst x old/new),
the host-capacity terms and the dispersion tiebreak in registers and
writes one f32; the per-step globals `g` arrive as a 22-float device
vector so no host sync is needed, goal weights and thresholds are a
by-value parameter struct (`TermParams`, fixed by the engine's chain and
constraint), and the values a model generation changes (capacity totals,
n_valid, n_alive) come from the engine's generation block on the device
(`Generation`), so a captured call replays with the generation it runs on.  The arithmetic follows the plain version's
order (sequential sums over the four resources, no multiply-add
contraction), so the two agree to within f32 rounding of the sums.

`_disk_terms` (:1767) contributes only when the intra-broker disk goals
are in the chain (they are not in the default chain): the plain version
covers them and the fused candidates kernel computes them
(csrc/terms.cuh `disk_terms`); this standalone kernel refuses them.

The plain functions here are also the package's only implementation of the
per-broker objective terms; the engine's O(B) objective and sampling plan
call `broker_terms` directly, and the plain candidate step calls
`move_delta_plain`.  The engine's step runs the fused candidates kernel
(kernels/candidates.py), whose device terms are this kernel's
(csrc/terms.cuh); this kernel stays as a standalone check of them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.kernels import _build
from cruise_control_tpu_torch.models.stats import exact_sqrt

_F32 = np.float32
_HOST_RES = np.asarray([Resource(r).is_host_resource for r in range(NUM_RESOURCES)])
#: order of the per-step globals in the kernel's `g` vector
G_VECTORS = ("avg_pct", "total_load", "pct_sum", "pct_sumsq")
G_SCALARS = ("avg_count", "total_count", "avg_lcount", "total_lcount", "avg_lbin", "total_lbin")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def _f32(x) -> float:
    """A Python float holding the f32 rounding of x (what JAX's weak-typed
    scalars become inside f32 arithmetic)."""
    return float(_F32(x))


#: the generation block's f32 words (name, length), then its i32 words:
#: csrc/common.cuh `GenParams`, field for field.  The inv_ words are the
#: f32 reciprocals that `div` multiplies by on CUDA
GEN_F32 = (("w_cap_tc", 4), ("w_cap_host_tc", 4), ("total_cap_nw_out", 1),
           ("inv_total_cap_nw_out", 1), ("n_valid", 1), ("inv_n_valid", 1), ("n_alive", 1),
           ("inv_n_alive", 1), ("total_disk_cap", 1), ("inv_total_disk_cap", 1))
GEN_I32 = ("n_source", "n_dest", "n_brokers", "shared_hosts")
GEN_WORDS = 20  # sizeof(GenParams) / 4
#: each f32 field's (offset, length) in the block
_GEN_AT = {name: (at, n) for (name, n), at in
           zip(GEN_F32, itertools.accumulate((n for _, n in GEN_F32), initial=0))}
_N_F32 = sum(n for _, n in GEN_F32)


@dataclasses.dataclass(eq=False)
class Generation:
    """A model generation's values that the kernels and the engine's
    PyTorch ops read on the device: one i32[GEN_WORDS] block (`words`, its
    f32 words viewed as f32) that an engine keeps across generations and
    each rebind rewrites in place (`write`), so the graphs captured on it
    read the values of the generation they run on.  Its other attributes
    are views of the block: f32[4] `w_cap_tc` and `w_cap_host_tc` (a
    capacity weight over the total alive capacity; host resources only),
    0-d f32 `total_cap_nw_out`, `n_valid`, `n_alive`, `total_disk_cap` and
    their `inv_` reciprocals, 0-d i32 `n_source`, `n_dest`, `n_brokers` and
    `shared_hosts` (0/1).  A dataclass of one tensor, so that copies to
    another device (`dataclasses.replace(gen, words=...)`) take their
    views along."""

    words: torch.Tensor

    def __post_init__(self):
        words = self.words
        if words.dtype != torch.int32 or tuple(words.shape) != (GEN_WORDS,):
            raise ValueError(f"a generation block is i32[{GEN_WORDS}], got {words.dtype}"
                             f"{list(words.shape)}")
        f = words[:_N_F32].view(torch.float32)
        for name, (at, n) in _GEN_AT.items():
            setattr(self, name, f[at] if n == 1 else f[at: at + n])
        for i, name in enumerate(GEN_I32):
            setattr(self, name, words[_N_F32 + i])

    @staticmethod
    def empty(device) -> "Generation":
        return Generation(torch.zeros(GEN_WORDS, dtype=torch.int32, device=device))

    @staticmethod
    def host_words(cap_weights, total_cap: np.ndarray, *, n_valid: float, n_alive: float,
                   total_disk_cap: float, n_source: int, n_dest: int, n_brokers: int,
                   shared_hosts: bool) -> np.ndarray:
        """The block's words of one generation: `cap_weights` are the
        chain's capacity-goal weights by resource (None: no such goal),
        `total_cap` the f32[4] total alive capacity, the rest its counts
        and totals (f32 values where float)."""
        total_cap = np.asarray(total_cap, _F32)
        w_cap = np.asarray(cap_weights if cap_weights is not None else (0.0,) * NUM_RESOURCES, _F32)
        w_cap_host = np.where(_HOST_RES, w_cap, _F32(0.0)).astype(_F32)
        one = _F32(1.0)
        nw_out = total_cap[int(Resource.NW_OUT)]
        f = dict(
            w_cap_tc=(w_cap / total_cap).astype(_F32),
            w_cap_host_tc=(w_cap_host / total_cap).astype(_F32),
            total_cap_nw_out=nw_out, inv_total_cap_nw_out=one / nw_out,
            n_valid=_F32(n_valid), inv_n_valid=one / _F32(n_valid),
            n_alive=_F32(n_alive), inv_n_alive=one / _F32(n_alive),
            total_disk_cap=_F32(total_disk_cap), inv_total_disk_cap=one / _F32(total_disk_cap),
        )
        words = np.zeros(GEN_WORDS, np.int32)
        words[:_N_F32] = np.concatenate(
            [np.asarray(f[name], _F32).reshape(-1) for name, _ in GEN_F32]).view(np.int32)
        words[_N_F32: _N_F32 + len(GEN_I32)] = [n_source, n_dest, n_brokers, int(shared_hosts)]
        return words

    def write(self, words: np.ndarray) -> None:
        """A generation's words (`host_words`) into the block, in stream order."""
        self.words.copy_(torch.from_numpy(words))

    def values(self) -> dict:
        """The block's values on the host (a blocking read): name -> float,
        int or f32[4] array."""
        w = self.words.cpu().numpy()
        f = w[:_N_F32].view(np.float32)
        out = {name: (f[at: at + n].copy() if n > 1 else float(f[at]))
               for name, (at, n) in _GEN_AT.items()}
        out.update({name: int(w[_N_F32 + i]) for i, name in enumerate(GEN_I32)})
        return out


def div(x: torch.Tensor, gen: Generation, name: str) -> torch.Tensor:
    """x over the generation's f32 value `name`, with the bits PyTorch gives
    for a division by that value as a Python float: on the CPU the IEEE
    quotient; on CUDA, where PyTorch divides by a host scalar as the product
    with its f32 reciprocal, that product (the block's `inv_` word)."""
    if x.device.type == "cuda":
        return x * getattr(gen, "inv_" + name)
    return x / getattr(gen, name)


@dataclasses.dataclass(frozen=True)
class TermParams:
    """Goal weights and thresholds of the objective terms, fixed by the
    engine's chain and constraint, as the f32 values the reference's
    traced program uses.  A generation's values are its `Generation`."""

    cth: np.ndarray  # f32[4] capacity thresholds
    t_bal: np.ndarray  # f32[4] balance thresholds
    t_low: np.ndarray  # f32[4] max(0, 2 - t_bal) in f32
    w_dist: np.ndarray  # f32[4] resource-distribution weights
    max_replicas: int
    w_replica_cap: float
    w_pot_nw_out: float
    cth_nw_out: float
    w_replica_dist: float
    t_rc: float
    t_rc_low: float
    w_leader_dist: float
    t_lc: float
    t_lc_low: float
    w_lbin_dist: float
    t_lbin: float
    w_tie: float
    # intra-broker disk goals (zero weights in the default chain)
    w_intra_cap: float
    w_intra_dist: float
    d_thresh: float
    t_disk: float
    #: bf16 accumulation of the broker terms (score_dtype "bfloat16")
    bf16: bool = False
    #: the f32[4] parameter vectors as tensors, per device (`on`)
    _on: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def on(self, device) -> dict:
        """The f32[4] vectors (and the host-resource mask) as tensors on
        `device`, made once: a captured graph may not copy from the host."""
        key = str(device)
        got = self._on.get(key)
        if got is None:
            names = ("cth", "t_bal", "t_low", "w_dist")
            got = {n: torch.as_tensor(getattr(self, n), device=device) for n in names}
            got["host_res"] = torch.as_tensor(_HOST_RES, device=device)
            self._on[key] = got
        return got

    @staticmethod
    def build(w, constraint, bf16: bool = False) -> "TermParams":
        """From an engine's goal weights (`engine._Weights`) and its
        constraint; `bf16`, the broker terms accumulated in bf16."""
        t_bal = np.asarray(constraint.balance_threshold, _F32)
        t_rc = constraint.replica_count_balance_threshold
        t_lc = constraint.leader_replica_count_balance_threshold
        return TermParams(
            cth=np.asarray(constraint.capacity_threshold, _F32),
            t_bal=t_bal,
            t_low=np.maximum(_F32(0.0), _F32(2.0) - t_bal).astype(_F32),
            w_dist=np.asarray(w.res_dist, _F32),
            max_replicas=int(constraint.max_replicas_per_broker),
            w_replica_cap=_f32(w.replica_cap),
            w_pot_nw_out=_f32(w.pot_nw_out),
            cth_nw_out=_f32(constraint.capacity_threshold[int(Resource.NW_OUT)]),
            w_replica_dist=_f32(w.replica_dist),
            t_rc=_f32(t_rc),
            t_rc_low=_f32(max(0.0, 2.0 - t_rc)),
            w_leader_dist=_f32(w.leader_dist),
            t_lc=_f32(t_lc),
            t_lc_low=_f32(max(0.0, 2.0 - t_lc)),
            w_lbin_dist=_f32(w.lbin_dist),
            t_lbin=_f32(constraint.balance_threshold[int(Resource.NW_IN)]),
            w_tie=_f32(w.tie),
            w_intra_cap=_f32(w.intra_cap),
            w_intra_dist=_f32(w.intra_dist),
            d_thresh=_f32(constraint.capacity_threshold[int(Resource.DISK)]),
            t_disk=constraint.balance_threshold[int(Resource.DISK)],
            bf16=bf16,
        )

    @property
    def has_disk_terms(self) -> bool:
        return self.w_intra_cap != 0.0 or self.w_intra_dist != 0.0

    @functools.cached_property
    def c_struct(self) -> "MDParams":
        s = MDParams()
        vectors = ("cth", "t_bal", "t_low", "w_dist")
        for name in vectors:
            getattr(s, name)[:] = [float(v) for v in getattr(self, name)]
        s.host_res[:] = [int(v) for v in _HOST_RES]
        # the f32 values the plain version's products round the disk
        # balance thresholds to (a Python float scalar times an f32 tensor)
        derived = dict(has_disk=int(self.has_disk_terms), t_disk_low=max(0.0, 2.0 - self.t_disk))
        for f, _ in MDParams._fields_:
            if f not in (*vectors, "host_res"):
                setattr(s, f, derived[f] if f in derived else getattr(self, f))
        return s


class MDParams(ctypes.Structure):
    """Mirror of `struct MDParams` in csrc/terms.cuh (field order matters)."""

    _fields_ = [
        ("cth", ctypes.c_float * 4),
        ("t_bal", ctypes.c_float * 4),
        ("t_low", ctypes.c_float * 4),
        ("w_dist", ctypes.c_float * 4),
        ("host_res", ctypes.c_int * 4),
        ("max_replicas", ctypes.c_int),
        ("w_replica_cap", ctypes.c_float),
        ("w_pot_nw_out", ctypes.c_float),
        ("cth_nw_out", ctypes.c_float),
        ("w_replica_dist", ctypes.c_float),
        ("t_rc", ctypes.c_float),
        ("t_rc_low", ctypes.c_float),
        ("w_leader_dist", ctypes.c_float),
        ("t_lc", ctypes.c_float),
        ("t_lc_low", ctypes.c_float),
        ("w_lbin_dist", ctypes.c_float),
        ("t_lbin", ctypes.c_float),
        ("w_tie", ctypes.c_float),
        ("has_disk", ctypes.c_int),
        ("w_intra_cap", ctypes.c_float),
        ("w_intra_dist", ctypes.c_float),
        ("d_thresh", ctypes.c_float),
        ("t_disk", ctypes.c_float),
        ("t_disk_low", ctypes.c_float),
    ]


# ----------------------------------------------------------------------
# plain PyTorch version (the objective-term math of the reference engine)
# ----------------------------------------------------------------------


def broker_terms(tp: TermParams, sx, b, load, rcount, lcount, pot, lbin, g) -> torch.Tensor:
    """Weighted objective contribution of broker(s) b given hypothetical
    per-broker stats; inputs may carry leading candidate axes.

    Mirrors, in delta-decomposable form: CapacityGoal (broker granularity),
    ReplicaCapacityGoal, PotentialNwOutGoal, ResourceDistributionGoal,
    Replica/LeaderReplicaDistributionGoal, LeaderBytesInDistributionGoal.
    Each term is computed in f32; with `tp.bf16` their running sum is
    bf16 (`accumulate_bf16`).  The generation's values come from
    `sx.gen`.
    """
    st = sx.state
    gen = sx.gen
    v = tp.on(load.device)
    cap = st.broker_capacity[b]  # [..., 4]
    alive = sx.alive[b]
    terms = []
    # capacity goals (broker granularity; multi-broker hosts in host_terms)
    single = ~sx.host_multi[st.broker_host[b]]
    excess = relu(load - v["cth"] * cap)
    gate = alive[..., None] & (single[..., None] | ~v["host_res"])
    terms.append((torch.where(gate, excess, 0.0) * gen.w_cap_tc).sum(-1))

    exc = relu((rcount - tp.max_replicas).to(torch.float32))
    terms.append(div(tp.w_replica_cap * torch.where(alive, exc, 0.0), gen, "n_valid"))

    exc = relu(pot - tp.cth_nw_out * cap[..., int(Resource.NW_OUT)])
    terms.append(div(tp.w_pot_nw_out * torch.where(alive, exc, 0.0), gen, "total_cap_nw_out"))

    # resource distribution bands
    upper = g["avg_pct"] * v["t_bal"] * cap
    lower = g["avg_pct"] * v["t_low"] * cap
    term = relu(load - upper) + relu(lower - load)
    terms.append((
        torch.where(alive[..., None], term, 0.0)
        * (v["w_dist"] / (g["total_load"] + 1e-12))
    ).sum(-1))

    # replica count distribution
    upper = torch.ceil(g["avg_count"] * tp.t_rc)
    lower = torch.floor(g["avg_count"] * tp.t_rc_low)
    rc = rcount.to(torch.float32)
    term = relu(rc - upper) + relu(lower - rc)
    terms.append(tp.w_replica_dist * torch.where(alive, term, 0.0) / g["total_count"])

    # leader count distribution
    upper = torch.ceil(g["avg_lcount"] * tp.t_lc)
    lower = torch.floor(g["avg_lcount"] * tp.t_lc_low)
    lc = lcount.to(torch.float32)
    term = relu(lc - upper) + relu(lower - lc)
    terms.append(tp.w_leader_dist * torch.where(alive, term, 0.0) / g["total_lcount"])

    # leader bytes-in distribution (upper band only)
    term = relu(lbin - g["avg_lbin"] * tp.t_lbin)
    terms.append(tp.w_lbin_dist * torch.where(alive, term, 0.0) / g["total_lbin"])
    if tp.bf16:
        return accumulate_bf16(terms)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def accumulate_bf16(terms: list[torch.Tensor]) -> torch.Tensor:
    """The sum of f32 terms into a bf16 accumulator, back in f32, as the
    JAX package's compiled program computes it on XLA:CPU: each term
    rounded to bf16, each add taken in f32 and rounded to bf16, except the
    last, whose f32 result is kept (XLA drops the bf16 round trip before
    the final cast to f32)."""
    acc = round_bf16(terms[0])
    for t in terms[1:-1]:
        acc = round_bf16(acc + round_bf16(t))
    return acc + round_bf16(terms[-1])


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to the nearest bf16 (ties to even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def host_terms(tp: TermParams, sx, h, hload) -> torch.Tensor:
    """Host-granularity capacity terms for multi-broker hosts."""
    v = tp.on(hload.device)
    hcap = sx.host_cap[h]
    multi = sx.host_multi[h]
    excess = relu(hload - v["cth"] * hcap)
    return (torch.where(multi[..., None], excess, 0.0) * sx.gen.w_cap_host_tc).sum(-1)


def disk_terms(tp: TermParams, sx, b, disk_row, broker_disk_load, g) -> torch.Tensor:
    """Intra-broker disk goal terms for broker(s) b; disk_row is the
    hypothetical f32[..., D] per-logdir load, broker_disk_load its sum."""
    st = sx.state
    dcap = st.disk_capacity[b]
    dalive = st.disk_alive[b] & sx.alive[b][..., None]
    cap_term = torch.where(dalive, relu(disk_row - tp.d_thresh * dcap), disk_row).sum(-1)
    out = div(tp.w_intra_cap * cap_term, sx.gen, "total_disk_cap")
    bcap = torch.where(dalive, dcap, 0.0).sum(-1, keepdim=True)
    avg_pct = broker_disk_load[..., None] / (bcap + 1e-12)
    upper = avg_pct * tp.t_disk * dcap
    lower = avg_pct * max(0.0, 2.0 - tp.t_disk) * dcap
    dist = torch.where(dalive, relu(disk_row - upper) + relu(lower - disk_row), 0.0).sum(-1)
    return out + tp.w_intra_dist * dist / g["total_disk_load"]


def tie_term(tp: TermParams, gen: Generation, pct_sum, pct_sumsq) -> torch.Tensor:
    """Dispersion tiebreaker: sum over resources of the std of utilization
    percentage over the generation's n_alive brokers.  Reduces ONLY the
    trailing resource axis."""
    mean = div(pct_sum, gen, "n_alive")
    var = relu(div(pct_sumsq, gen, "n_alive") - mean * mean)
    return tp.w_tie * exact_sqrt(var + 1e-18).sum(-1)


def move_delta_plain(
    tp: TermParams, sx, carry, g, *, src, dst, dload_src, dload_dst, dcount, dlcount,
    dpot, dlbin, dlbin_src, d_src, d_dst, ddisk, ddisk_src,
) -> torch.Tensor:
    """Objective delta for candidates touching brokers (src, dst).

    dload_src is ADDED to src (callers pass negative values to remove
    load); dload_dst is added to dst.  dcount/dlcount/dpot move from src to
    dst; dlbin_src / ddisk_src are the src-side amounts of dlbin / ddisk.
    """
    st = sx.state

    def gather(b):
        return (
            carry.broker_load[b],
            carry.broker_replica_count[b],
            carry.broker_leader_count[b],
            carry.broker_potential_nw_out[b],
            carry.broker_leader_bytes_in[b],
        )

    ls, rs, lcs, ps, lbs = gather(src)
    ld, rd, lcd, pd, lbd = gather(dst)
    # one stacked call over a [4, K] lane axis: src-old, dst-old, src-new, dst-new
    t4 = broker_terms(
        tp, sx,
        torch.stack([src, dst, src, dst]),
        torch.stack([ls, ld, ls + dload_src, ld + dload_dst]),
        torch.stack([rs, rd, rs - dcount, rd + dcount]),
        torch.stack([lcs, lcd, lcs - dlcount, lcd + dlcount]),
        torch.stack([ps, pd, ps - dpot, pd + dpot]),
        torch.stack([lbs, lbd, lbs - dlbin_src, lbd + dlbin]),
        g,
    )
    delta = (t4[2] + t4[3]) - (t4[0] + t4[1])

    # host-granularity capacity (same-host moves cancel)
    h_s, h_d = st.broker_host[src], st.broker_host[dst]
    hl_s, hl_d = carry.host_load[h_s], carry.host_load[h_d]
    th4 = host_terms(
        tp, sx,
        torch.stack([h_s, h_s, h_d, h_d]),
        torch.stack([hl_s + dload_src, hl_s, hl_d + dload_dst, hl_d]),
    )
    dh = th4[0] - th4[1] + th4[2] - th4[3]
    delta = delta + torch.where(h_s != h_d, dh, 0.0)

    if tp.has_disk_terms:
        row_s, row_d = carry.disk_load[src], carry.disk_load[dst]
        D = row_s.shape[-1]
        oh_s = torch.nn.functional.one_hot(d_src.long(), D).to(torch.float32)
        oh_d = torch.nn.functional.one_hot(d_dst.long(), D).to(torch.float32)
        row_s2 = row_s - oh_s * ddisk_src[:, None]
        row_d2 = row_d + oh_d * ddisk[:, None]
        bsum_s, bsum_d = row_s.sum(-1), row_d.sum(-1)
        td4 = disk_terms(
            tp, sx,
            torch.stack([src, src, dst, dst]),
            torch.stack([row_s2, row_s, row_d2, row_d]),
            torch.stack([bsum_s - ddisk_src, bsum_s, bsum_d + ddisk, bsum_d]),
            g,
        )
        delta = delta + (td4[0] - td4[1] + td4[2] - td4[3])

    # dispersion tiebreaker via sufficient statistics
    cap_s = st.broker_capacity[src] + 1e-12
    cap_d = st.broker_capacity[dst] + 1e-12
    p_s, p_d = ls / cap_s, ld / cap_d
    p_s2, p_d2 = (ls + dload_src) / cap_s, (ld + dload_dst) / cap_d
    a_s = sx.alive[src][:, None].to(torch.float32)
    a_d = sx.alive[dst][:, None].to(torch.float32)
    dsum = a_s * (p_s2 - p_s) + a_d * (p_d2 - p_d)
    dsumsq = a_s * (p_s2 * p_s2 - p_s * p_s) + a_d * (p_d2 * p_d2 - p_d * p_d)
    return delta + (
        tie_term(tp, sx.gen, g["pct_sum"] + dsum, g["pct_sumsq"] + dsumsq)
        - tie_term(tp, sx.gen, g["pct_sum"], g["pct_sumsq"])
    )


# ----------------------------------------------------------------------
# kernel
# ----------------------------------------------------------------------

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("move_delta").cc_move_delta
        fn.argtypes = [ctypes.c_int, MDParams] + [ctypes.c_void_p] * 24
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def pack_globals(g: dict) -> torch.Tensor:
    """The kernel's f32[22] view of the per-step globals (G_VECTORS then
    G_SCALARS)."""
    return torch.cat(
        [g[k] for k in G_VECTORS] + [torch.stack([g[k] for k in G_SCALARS])]
    ).to(torch.float32).contiguous()


def _check_inputs(**tensors) -> None:
    for name, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"move_delta: {name} must be contiguous {dtype}{list(shape)}, "
                f"got {t.dtype}{list(t.shape)} contiguous={t.is_contiguous()}"
            )


def move_delta_cuda(tp: TermParams, sx, carry, g, *, src, dst, dload_src, dload_dst,
                    dcount, dlcount, dpot, dlbin, dlbin_src) -> torch.Tensor:
    st = sx.state
    K = int(src.shape[0])
    B = st.shape.B
    H = st.shape.num_hosts
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    # candidate columns often arrive as strided views of [K, 4] rows
    src, dst, dload_src, dload_dst, dcount, dlcount, dpot, dlbin, dlbin_src = (
        t.contiguous()
        for t in (src, dst, dload_src, dload_dst, dcount, dlcount, dpot, dlbin, dlbin_src)
    )
    _check_inputs(
        src=(src, i32, (K,)), dst=(dst, i32, (K,)),
        dload_src=(dload_src, f32, (K, 4)), dload_dst=(dload_dst, f32, (K, 4)),
        dcount=(dcount, i32, (K,)), dlcount=(dlcount, i32, (K,)),
        dpot=(dpot, f32, (K,)), dlbin=(dlbin, f32, (K,)), dlbin_src=(dlbin_src, f32, (K,)),
        broker_load=(carry.broker_load, f32, (B, 4)),
        broker_replica_count=(carry.broker_replica_count, i32, (B,)),
        broker_leader_count=(carry.broker_leader_count, i32, (B,)),
        broker_potential_nw_out=(carry.broker_potential_nw_out, f32, (B,)),
        broker_leader_bytes_in=(carry.broker_leader_bytes_in, f32, (B,)),
        broker_capacity=(st.broker_capacity, f32, (B, 4)),
        alive=(sx.alive, b8, (B,)), broker_host=(st.broker_host, i32, (B,)),
        host_multi=(sx.host_multi, b8, (H,)), host_load=(carry.host_load, f32, (H, 4)),
        host_cap=(sx.host_cap, f32, (H, 4)),
    )
    gvec = pack_globals(g)
    out = torch.empty(K, dtype=f32, device=src.device)
    if K == 0:
        return out
    ptrs = [
        sx.gen.words, gvec, src, dst, dload_src, dload_dst, dcount, dlcount, dpot, dlbin, dlbin_src,
        carry.broker_load, carry.broker_replica_count, carry.broker_leader_count,
        carry.broker_potential_nw_out, carry.broker_leader_bytes_in,
        st.broker_capacity, sx.alive, st.broker_host, sx.host_multi, carry.host_load,
        sx.host_cap, out,
    ]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    status = _fn()(K, tp.c_struct, *[p.data_ptr() for p in ptrs], stream)
    _build.check(status, "move_delta")
    kernels.count("move_delta")
    return out


def move_delta(
    tp: TermParams, sx, carry, g, *, src, dst, dload_src, dload_dst, dcount, dlcount,
    dpot, dlbin, d_src, d_dst, ddisk, dlbin_src=None, ddisk_src=None,
) -> torch.Tensor:
    """f32[K] objective deltas (engine.py:2439 `_move_delta`): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if dlbin_src is None:
        dlbin_src = dlbin
    if ddisk_src is None:
        ddisk_src = ddisk
    if kernels.route(src, dst, carry.broker_load) == "cpu":
        return move_delta_plain(
            tp, sx, carry, g, src=src, dst=dst, dload_src=dload_src, dload_dst=dload_dst,
            dcount=dcount, dlcount=dlcount, dpot=dpot, dlbin=dlbin, dlbin_src=dlbin_src,
            d_src=d_src, d_dst=d_dst, ddisk=ddisk, ddisk_src=ddisk_src,
        )
    if tp.has_disk_terms or tp.bf16:
        raise NotImplementedError(
            "move_delta kernel: intra-broker disk goals and bf16 scoring are computed only by "
            "the fused candidates kernel"
        )
    return move_delta_cuda(
        tp, sx, carry, g, src=src, dst=dst, dload_src=dload_src, dload_dst=dload_dst,
        dcount=dcount, dlcount=dlcount, dpot=dpot, dlbin=dlbin, dlbin_src=dlbin_src,
    )
