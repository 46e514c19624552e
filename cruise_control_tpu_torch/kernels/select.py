"""select_survivors — conflict resolution of the accepted candidates, and
the step's bookkeeping around it.

Replaces: `Engine._select` (cruise_control_tpu/analyzer/engine.py:2643),
the stable double `argsort` of the deltas plus a `segment_min` of the ranks
over B + P segments; and of `_accept_select_apply` (:2669-2699) the
extended relocation mask `sv_r_ext = [sv_r, sv_s, sv_s]` the scatter reads
and the survivor count `accepted = survive.sum()`.  A candidate survives
when it is accepted and is the best-ranked accepted candidate at its src
broker, its dst broker and each of its (one or two) partitions; rank is
the stable order of (delta, index).

Bound on the card: latency.  A step reads ~21 bytes a candidate and writes
~3 (~0.1 us of HBM time at K = 16,384); the chain of dependent steps is
what costs.  Design (csrc/select.cu): one cooperative launch over the
card's SMs, no sort and no clear.  A 64-bit key `epoch_keys` orders the
candidates exactly as the stable argsort does; pass 1 takes an
`atomicMin` of the key into each of a candidate's segments, and after a
grid-wide barrier pass 2 keeps the candidates whose key is every one of
their segments' minimum, writes both masks and adds the survivor count
into the caller's accumulator.  The key's top bits tag the step's epoch so
that the minima need clearing once per run (`SelectBuffers.clear`), not
once per step.  Rejected candidates never touch a segment: every accepted
delta ranks ahead of the +inf that rejection assigns in the reference.

With convergence diagnostics (`diag`), the accumulator is i64[6]
(`DIAG_FIELDS`): besides the survivor count, the step's survivors by kind
(relocations [0, n_r), swaps [n_r, n_r + n_s), leadership transfers after
them) and, from the candidates kernel's took-the-prior mask over the
relocations, the prior-drawn candidates and those that survived (the
`stats` of `_accept_select_apply`, engine.py:2699-2711).  The kernel
counts them in a second instantiation (`select_survivors_kernel<true>`),
so the default one is unchanged.

The plain version computes the same keys in int64 (a signed twin of the
kernel's unsigned keys: the same order) and takes fresh segment minima
with `scatter_reduce` each call.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build

_FN = None
#: the diagnostics accumulator's counts, in order (i64[len(DIAG_FIELDS)])
DIAG_FIELDS = ("accepted", "acc_replica", "acc_swap", "acc_lead", "prior_cands", "prior_acc")


def index_bits(K: int) -> int:
    """Bits of a key that hold the candidate index (K <= 2**bits)."""
    if not 0 <= K <= 1 << 31:
        raise ValueError(f"select_survivors: K={K} does not fit a 31-bit candidate index")
    return max(1, (K - 1).bit_length())


def max_epoch(K: int) -> int:
    """The last epoch the keys of K candidates can tag (epoch 0 is the
    cleared state)."""
    return (1 << (32 - index_bits(K))) - 1


def epoch_keys(delta: torch.Tensor, epoch: int) -> torch.Tensor:
    """int64 keys of the candidates at `epoch`: the kernel's unsigned keys
    [(2**E - 1 - epoch) : E][ordered delta bits : 32][index : 32 - E]
    minus 2**63, so they order as the unsigned keys do.  Within an epoch
    they order candidates as the stable argsort of delta does (-0.0 ranks
    equal to +0.0); every key of an earlier epoch is larger, and the
    cleared value (int64 max) is larger still."""
    K = int(delta.shape[0])
    ib = index_bits(K)
    if not 1 <= epoch <= max_epoch(K):
        raise ValueError(f"select_survivors: epoch {epoch} outside 1..{max_epoch(K)} for K={K}")
    d = torch.where(delta == 0, torch.zeros_like(delta), delta)  # -0.0 -> +0.0
    bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    idx = torch.arange(K, dtype=torch.int64, device=delta.device)
    tag = (1 << (32 - ib)) - 1 - epoch
    top = (tag << ib) | (ordered >> (32 - ib))  # bits 63..32 of the unsigned key
    low = ((ordered & ((1 << (32 - ib)) - 1)) << ib) | idx
    return (top - (1 << 31)) * (1 << 32) + low


def _acc_len(diag: bool) -> int:
    return len(DIAG_FIELDS) if diag else 1


def select_plain(accept, delta, src, dst, part1, part2, num_brokers: int, num_parts: int,
                 n_r: int, n_s: int, acc: torch.Tensor | None = None,
                 from_prior: torch.Tensor | None = None, diag: bool = False):
    """(survive bool[K], sv_r bool[n_r + 2 n_s], acc): the survivors, the
    relocation rows' mask [survive[:n_r], sv_s, sv_s] with sv_s =
    survive[n_r:n_r + n_s], and `acc` (zeros when None) with the survivor
    count added in place; with `diag`, acc is i64[6] and the DIAG_FIELDS
    counts are added (`from_prior`, bool[n_r] or None, the relocations
    drawn from the prior)."""
    B, P = num_brokers, num_parts
    key = epoch_keys(delta, 1)
    seg = torch.stack([src.long(), dst.long(), B + part1.long(), B + part2.long()])  # [4, K]
    n_seg = B + P
    ok = accept[None, :] & (seg >= 0) & (seg < n_seg)
    segmin = torch.full((n_seg,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                        device=delta.device)
    key4 = key[None, :].expand_as(seg)
    segmin.scatter_reduce_(0, seg[ok], key4[ok], reduce="amin")
    mins = segmin[seg.clamp(0, n_seg - 1)]
    survive = accept & (mins == key[None, :]).all(0)
    if acc is None:
        acc = torch.zeros(_acc_len(diag), dtype=torch.int64, device=delta.device)
    sv_r, sv_s = survive[:n_r], survive[n_r: n_r + n_s]
    if diag:
        fp = from_prior if from_prior is not None else torch.zeros_like(sv_r)
        acc.add_(torch.stack([survive.sum(), sv_r.sum(), sv_s.sum(), survive[n_r + n_s:].sum(),
                              fp.sum(), (sv_r & fp).sum()]))
    else:
        acc.add_(survive.sum())
    return survive, torch.cat([sv_r, sv_s, sv_s]), acc


@dataclasses.dataclass
class SelectBuffers:
    """The kernel's outputs and its epoch-tagged segment minima, reused by
    every step of a run; the minima are cleared once per run (`clear`)."""

    segmin: torch.Tensor  # i64[B + P]
    survive: torch.Tensor  # bool[K]
    sv_r: torch.Tensor  # bool[n_r + 2 n_s]
    n_epochs: int  # epochs the run may use, 1..n_epochs

    def clear(self) -> None:
        self.segmin.fill_(-1)


def select_buffers(K: int, n_r: int, n_s: int, num_brokers: int, num_parts: int, device,
                   n_epochs: int = 1) -> SelectBuffers:
    """Cleared buffers for a run of up to `n_epochs` steps of K candidates;
    raises when the keys of K candidates cannot tag that many epochs."""
    if n_epochs > max_epoch(K):
        raise ValueError(f"select_survivors: {n_epochs} steps exceed the {max_epoch(K)} epochs "
                         f"the keys of K={K} candidates can tag")
    return SelectBuffers(
        segmin=torch.full((num_brokers + num_parts,), -1, dtype=torch.int64, device=device),
        survive=torch.empty(K, dtype=torch.bool, device=device),
        sv_r=torch.empty(n_r + 2 * n_s, dtype=torch.bool, device=device),
        n_epochs=n_epochs,
    )


@dataclasses.dataclass(frozen=True)
class Epoch:
    """A step's epoch: 1 + rnd[0] * steps + step, the round index `rnd`
    (i32[1]) read on the device; 1 + step without `rnd`."""

    step: int = 0
    rnd: torch.Tensor | None = None
    steps: int = 1


class _Args(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "accept", "delta", "src", "dst", "part1", "part2", "segmin", "survive", "sv_r", "acc", "rnd",
        "from_prior",
    )] + [(f, ctypes.c_int) for f in ("K", "B", "P", "n_r", "n_s", "idx_bits", "step", "steps",
                                      "diag")])


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("select").cc_select_survivors
        fn.argtypes = [_Args, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _ptr(name, t, dtype, n) -> int:
    if t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"select_survivors: {name} must be contiguous {dtype}[{n}], "
                         f"got {t.dtype}{list(t.shape)}")
    return t.data_ptr()


def select_cuda(accept, delta, src, dst, part1, part2, num_brokers: int, num_parts: int,
                n_r: int, n_s: int, acc: torch.Tensor | None = None,
                bufs: SelectBuffers | None = None, epoch: Epoch = Epoch(),
                from_prior: torch.Tensor | None = None, diag: bool = False):
    K = int(delta.shape[0])
    B, P = num_brokers, num_parts
    if not (0 <= n_r and 0 <= n_s and n_r + n_s <= K):
        raise ValueError(f"select_survivors: n_r={n_r}, n_s={n_s} do not fit K={K}")
    if bufs is None:
        bufs = select_buffers(K, n_r, n_s, B, P, delta.device)
    if epoch.rnd is None and not 1 <= 1 + epoch.step <= bufs.n_epochs:
        raise ValueError(f"select_survivors: epoch {1 + epoch.step} outside 1..{bufs.n_epochs}")
    if epoch.rnd is not None and not 0 <= epoch.step < epoch.steps:
        raise ValueError(f"select_survivors: step {epoch.step} outside 0..{epoch.steps - 1}")
    if acc is None:
        acc = torch.zeros(_acc_len(diag), dtype=torch.int64, device=delta.device)
    args = _Args(
        accept=_ptr("accept", accept, torch.bool, K), delta=_ptr("delta", delta, torch.float32, K),
        src=_ptr("src", src, torch.int32, K), dst=_ptr("dst", dst, torch.int32, K),
        part1=_ptr("part1", part1, torch.int32, K), part2=_ptr("part2", part2, torch.int32, K),
        segmin=_ptr("segmin", bufs.segmin, torch.int64, B + P),
        survive=_ptr("survive", bufs.survive, torch.bool, K),
        sv_r=_ptr("sv_r", bufs.sv_r, torch.bool, n_r + 2 * n_s),
        acc=_ptr("acc", acc, torch.int64, _acc_len(diag)),
        rnd=None if epoch.rnd is None else _ptr("rnd", epoch.rnd, torch.int32, 1),
        from_prior=(None if from_prior is None or not diag
                    else _ptr("from_prior", from_prior, torch.bool, n_r)),
        K=K, B=B, P=P, n_r=n_r, n_s=n_s, idx_bits=index_bits(K), step=epoch.step,
        steps=epoch.steps, diag=int(diag),
    )
    if K > 0:
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        n_sm = torch.cuda.get_device_properties(delta.device).multi_processor_count
        _build.check(_fn()(args, n_sm, stream), "select_survivors")
        kernels.count("select_survivors")
    return bufs.survive, bufs.sv_r, acc


def select_survivors(accept, delta, src, dst, part1, part2, *, num_brokers: int, num_parts: int,
                     n_r: int, n_s: int, acc: torch.Tensor | None = None,
                     bufs: SelectBuffers | None = None, epoch: Epoch = Epoch(),
                     from_prior: torch.Tensor | None = None, diag: bool = False):
    """(survive bool[K], sv_r bool[n_r + 2 n_s], acc) of a candidate
    bundle (engine.py:2643 `_select` and `_accept_select_apply`'s sv_r_ext
    and accepted), the survivor count added into `acc`, i64[1] (a new
    zero accumulator when None), or with `diag` the DIAG_FIELDS counts
    into an i64[6] (`from_prior` the relocations' took-the-prior mask, or
    None): the kernel for CUDA tensors, into `bufs` (`select_buffers`,
    fresh ones when None) at `epoch`, which must grow from step to step
    between two `bufs.clear()`; the plain version for CPU tensors."""
    if kernels.route(accept, delta, src, dst, part1, part2) == "cpu":
        return select_plain(accept, delta, src, dst, part1, part2, num_brokers, num_parts, n_r, n_s,
                            acc, from_prior, diag)
    return select_cuda(accept, delta, src, dst, part1, part2, num_brokers, num_parts, n_r, n_s,
                       acc, bufs, epoch, from_prior, diag)
