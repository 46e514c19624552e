"""apply_moves — scatter the surviving moves into placement and aggregates.

Replaces: `Engine._apply` (cruise_control_tpu/analyzer/engine.py:2715).
Relocation rows (K_r relocations, then each of K_s swaps as two linked
rows) set `replica_broker` / `replica_disk`; leadership rows (K_l) move
`replica_is_leader`.  Both add their load shifts into broker_load[B,4],
the replica and leader counts, potential NW-out, leader bytes-in,
broker_topic_count[T,B], part_rack_count[P,racks], disk_load[B,D] and
host_load[H,4].

Bound on the card: latency, and where the requests queue — every row's
survivor flag is read, and only a survivor reads its ~60-byte payload row
and read-modify-writes ~30 aggregate words; with a few hundred survivors
per step each survivor's chain of dependent requests sets the time, and
its scattered requests must be spread over the SMs.  Design: in-place
updates of the carry (the reference donates its carry; here the step owns
it), in one cooperative launch of one block an SM whose work after the
flag sweep is proportional to the survivors (csrc/apply.cu): each block
lists the survivors of its slice of the rows in row order (warp ballots),
then one thread a side of a survivor (src or dst) loads what it will add
to, writes the placement (survivors touch distinct partitions, so it
never races) and its integer counts with atomics (their sums do not
depend on order), and puts its row and event in its broker's slot; after
a grid barrier each side reads the other slot of its broker, and the
broker's first event adds both events, and on a host of one broker the
host's load, in the reference's order; the reader of a slot clears it.
(Where a host holds several brokers, its first event walks them, and the
slots are reset after a second barrier; whether one does is the
`shared_hosts` word of the engine's generation block, which the kernel
reads on the device and branches on grid-uniformly, so one captured step
serves every generation.)  So the card's aggregates are
bit for bit the plain version's, run after run, and a seed gives one
trajectory.  It relies on each broker being the src of at most one
surviving row and the dst of at most one, which `select_survivors`
guarantees.

The plain version mirrors the reference's scatter order exactly: all src
subtractions in row order, then all dst additions, relocations before
leadership transfers (`index_add_` on the CPU adds in index order).  Like
the kernel, it drops what lies out of range: a row whose src or dst broker
is out of range adds nothing, and a replica, topic, partition, disk or
host id out of range drops its own write or add.

In the sharded-model mode (parallel/model_shard.py) a shard's carry holds
one block of replica and partition rows, from global ids `r_off` and
`p_off`, while the payload keeps global ids: both versions subtract the
offsets, so a row outside the block drops its placement and cell writes
and the replicated broker, host and topic aggregates take every
survivor.  With offsets 0 (every other caller) the launch is the one it
always was.  The mode needs no collective here.
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import _build
from cruise_control_tpu_torch.kernels import move_delta as md

_DISK = int(Resource.DISK)
_FN = None
#: words of 32 rows one block takes: it lists the survivors of its slice
#: of the rows in shared memory (384 bytes a word), within the 227 KB a
#: block may use
_MAX_WORDS_PER_BLOCK = (226 * 1024) // 384

#: payload fields of a relocation row and of a leadership row
REL_FIELDS = ("r", "src", "dst", "d_src", "d_dst", "load", "is_lead", "pot", "lbin", "topic", "part")
LEAD_FIELDS = ("rf", "rt", "src_b", "dst_b", "dl_f", "dl_t", "dlbin_src", "dlbin_dst", "d_f", "d_t")


def _within(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >= 0) & (x < n)


def _add(t: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, ok: torch.Tensor) -> None:
    """t.index_add_ of the rows where ok holds (the kernel drops the rest)."""
    t.index_add_(0, idx[ok], vals[ok])


def apply_plain(sx, carry, sv_r, payr, sv_l, payl, r_off: int = 0, p_off: int = 0) -> None:
    st = sx.state
    s = st.shape
    B, D, H, R, nr = s.B, s.max_disks_per_broker, s.num_hosts, s.R, s.num_racks
    i = torch.nonzero(sv_r).squeeze(1)
    r = payr["r"][i].long() - r_off
    placed = _within(r, R)
    carry.replica_broker[r[placed]] = payr["dst"][i][placed]
    carry.replica_disk[r[placed]] = payr["d_dst"][i][placed]
    # a row with a src or dst broker out of range adds nothing (its
    # placement write above stays)
    i = i[_within(payr["src"][i], B) & _within(payr["dst"][i], B)]
    src, dst = payr["src"][i].long(), payr["dst"][i].long()
    load = payr["load"][i]
    ones = torch.ones(i.shape[0], dtype=torch.int32, device=load.device)
    carry.broker_load.index_add_(0, src, -load).index_add_(0, dst, load)
    carry.broker_replica_count.index_add_(0, src, -ones).index_add_(0, dst, ones)
    dlc = payr["is_lead"][i].to(torch.int32)
    carry.broker_leader_count.index_add_(0, src, -dlc).index_add_(0, dst, dlc)
    pot = payr["pot"][i]
    carry.broker_potential_nw_out.index_add_(0, src, -pot).index_add_(0, dst, pot)
    lbin = payr["lbin"][i]
    carry.broker_leader_bytes_in.index_add_(0, src, -lbin).index_add_(0, dst, lbin)
    t = payr["topic"][i].long()
    tc = carry.broker_topic_count.view(-1)
    _add(tc, t * B + src, -ones, _within(t, s.num_topics))
    _add(tc, t * B + dst, ones, _within(t, s.num_topics))
    p = payr["part"][i].long() - p_off
    prc = carry.part_rack_count.view(-1)
    _add(prc, p * nr + st.broker_rack[src].long(), -ones, _within(p, s.P))
    _add(prc, p * nr + st.broker_rack[dst].long(), ones, _within(p, s.P))
    ddisk = load[:, _DISK]
    dl = carry.disk_load.view(-1)
    d_src, d_dst = payr["d_src"][i].long(), payr["d_dst"][i].long()
    _add(dl, src * D + d_src, -ddisk, _within(d_src, D))
    _add(dl, dst * D + d_dst, ddisk, _within(d_dst, D))
    h_src, h_dst = st.broker_host[src].long(), st.broker_host[dst].long()
    _add(carry.host_load, h_src, -load, _within(h_src, H))
    _add(carry.host_load, h_dst, load, _within(h_dst, H))

    j = torch.nonzero(sv_l).squeeze(1)
    rf, rt = payl["rf"][j].long() - r_off, payl["rt"][j].long() - r_off
    carry.replica_is_leader[rf[_within(rf, R)]] = False
    carry.replica_is_leader[rt[_within(rt, R)]] = True
    j = j[_within(payl["src_b"][j], B) & _within(payl["dst_b"][j], B)]
    sl, tl = payl["src_b"][j].long(), payl["dst_b"][j].long()
    dl_f, dl_t = payl["dl_f"][j], payl["dl_t"][j]
    carry.broker_load.index_add_(0, sl, dl_f).index_add_(0, tl, dl_t)
    ones_l = torch.ones(j.shape[0], dtype=torch.int32, device=load.device)
    carry.broker_leader_count.index_add_(0, sl, -ones_l).index_add_(0, tl, ones_l)
    carry.broker_leader_bytes_in.index_add_(0, sl, -payl["dlbin_src"][j])
    carry.broker_leader_bytes_in.index_add_(0, tl, payl["dlbin_dst"][j])
    d_f, d_t = payl["d_f"][j].long(), payl["d_t"][j].long()
    _add(dl, sl * D + d_f, dl_f[:, _DISK], _within(d_f, D))
    _add(dl, tl * D + d_t, dl_t[:, _DISK], _within(d_t, D))
    h_f, h_t = st.broker_host[sl].long(), st.broker_host[tl].long()
    _add(carry.host_load, h_f, dl_f, _within(h_f, H))
    _add(carry.host_load, h_t, dl_t, _within(h_t, H))


class _Dims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("n_rel", "n_lead", "R", "B", "T", "P", "racks", "D", "H",
                                            "r_off", "p_off")]


class _RelRows(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "sv", "r", "src", "dst", "d_src", "d_dst", "load", "is_lead", "pot", "lbin", "topic", "part",
    )]


class _LeadRows(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "sv", "rf", "rt", "src", "dst", "dl_f", "dl_t", "dlbin_src", "dlbin_dst", "d_f", "d_t",
    )]


class _Owners(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in ("host_brokers", "host_start", "slots", "events",
                                               "gen")]


class _Carry(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "replica_broker", "replica_disk", "replica_is_leader", "broker_load", "rcount",
        "lcount", "pot", "lbin", "topic_count", "part_rack_count", "disk_load", "host_load",
        "broker_rack", "broker_host",
    )]


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("apply").cc_apply_moves
        fn.argtypes = [_Dims, _RelRows, _LeadRows, _Carry, _Owners, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _need(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"apply_moves: {name} must be contiguous {dtype}{list(shape)}, "
            f"got {t.dtype}{list(t.shape)}"
        )
    return t.data_ptr()


def apply_cuda(sx, carry, sv_r, payr, sv_l, payl, r_off: int = 0, p_off: int = 0) -> None:
    # the candidates kernel's buffers are contiguous, so on the engine's
    # path these are the tensors themselves; a strided view (a plain
    # bundle's column of [K, 4] rows) is copied, and the copy must outlive
    # the launch, so it stays referenced
    payr = {f: payr[f].contiguous() for f in REL_FIELDS}
    payl = {f: payl[f].contiguous() for f in LEAD_FIELDS}
    sv_r, sv_l = sv_r.contiguous(), sv_l.contiguous()
    st = sx.state
    s = st.shape
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    n_rel, n_lead = int(sv_r.shape[0]), int(sv_l.shape[0])
    row = {"load": (f32, (n_rel, 4)), "is_lead": (b8, (n_rel,)), "pot": (f32, (n_rel,)),
           "lbin": (f32, (n_rel,))}
    rel = _RelRows(sv=_need("sv_r", sv_r, b8, (n_rel,)), **{
        f: _need(f, payr[f], *row.get(f, (i32, (n_rel,)))) for f in REL_FIELDS
    })
    lrow = {"dl_f": (f32, (n_lead, 4)), "dl_t": (f32, (n_lead, 4)),
            "dlbin_src": (f32, (n_lead,)), "dlbin_dst": (f32, (n_lead,))}
    lead = _LeadRows(
        sv=_need("sv_l", sv_l, b8, (n_lead,)),
        **{
            {"src_b": "src", "dst_b": "dst"}.get(f, f): _need(
                f, payl[f], *lrow.get(f, (i32, (n_lead,)))
            )
            for f in LEAD_FIELDS
        },
    )
    B, R, T, P, D, H = s.B, s.R, s.num_topics, s.P, s.max_disks_per_broker, s.num_hosts
    c = _Carry(
        replica_broker=_need("replica_broker", carry.replica_broker, i32, (R,)),
        replica_disk=_need("replica_disk", carry.replica_disk, i32, (R,)),
        replica_is_leader=_need("replica_is_leader", carry.replica_is_leader, b8, (R,)),
        broker_load=_need("broker_load", carry.broker_load, f32, (B, 4)),
        rcount=_need("broker_replica_count", carry.broker_replica_count, i32, (B,)),
        lcount=_need("broker_leader_count", carry.broker_leader_count, i32, (B,)),
        pot=_need("broker_potential_nw_out", carry.broker_potential_nw_out, f32, (B,)),
        lbin=_need("broker_leader_bytes_in", carry.broker_leader_bytes_in, f32, (B,)),
        topic_count=_need("broker_topic_count", carry.broker_topic_count, i32, (T, B)),
        part_rack_count=_need("part_rack_count", carry.part_rack_count, i32, (P, s.num_racks)),
        disk_load=_need("disk_load", carry.disk_load, f32, (B, D)),
        host_load=_need("host_load", carry.host_load, f32, (H, 4)),
        broker_rack=_need("broker_rack", st.broker_rack, i32, (B,)),
        broker_host=_need("broker_host", st.broker_host, i32, (B,)),
    )
    owners = _Owners(
        host_brokers=_need("host_brokers", sx.host_brokers, i32, (B,)),
        host_start=_need("host_start", sx.host_start, i32, (H + 2,)),
        slots=_need("apply_slots", sx.apply_slots, i32, (2, B)),
        events=_need("apply_events", sx.apply_events, f32, (2, B, 8)),
        gen=_need("gen", sx.gen.words, i32, (md.GEN_WORDS,)),
    )
    dims = _Dims(n_rel, n_lead, R, B, T, P, s.num_racks, D, H, int(r_off), int(p_off))
    if n_rel + n_lead == 0:
        return
    n_sm = torch.cuda.get_device_properties(sv_r.device).multi_processor_count
    max_rows = _MAX_WORDS_PER_BLOCK * 32 * n_sm
    if n_rel + n_lead > max_rows:
        raise ValueError(f"apply_moves: {n_rel + n_lead} rows, the kernel takes at most {max_rows} "
                         "(a block lists its slice's survivors in shared memory)")
    stream = torch.cuda.current_stream(sv_r.device).cuda_stream
    status = _fn()(dims, rel, lead, c, owners, n_sm, stream)
    _build.check(status, "apply_moves")
    kernels.count("apply_moves")


def apply_moves(sx, carry, sv_r, payr, sv_l, payl, *, r_off: int = 0, p_off: int = 0) -> None:
    """Scatter survivors into `carry` in place (engine.py:2715 `_apply`):
    the kernel for CUDA tensors, the plain version for CPU tensors.
    `r_off` / `p_off`: the global ids of the carry's first replica and
    partition row (a model shard's block; 0 otherwise)."""
    if kernels.route(sv_r, sv_l, carry.broker_load) == "cpu":
        apply_plain(sx, carry, sv_r, payr, sv_l, payl, r_off, p_off)
    else:
        apply_cuda(sx, carry, sv_r, payr, sv_l, payl, r_off, p_off)
