"""model_shard — the sharded-model mode's ownership gathers.

Replaces: the ownership psums of the JAX package's parallel/model_shard.py
`_ModelShardEngine` (`_own_take` :196, `_take_rows` :222, `_take_members`
:226, `_member_field` :231, `_rack_cell` :238 and the source resolution of
`_sample_sources` :285) and its sharded `compute_aggregates`' partition x
rack reduce-scatter (models/aggregates.py:93).

A model shard holds one block of the replica rows (global ids [r_off,
r_off + Rl)) and of the partition rows ([p_off, p_off + Pl)); values keep
global ids.  The candidates kernel gathers rows at global ids directly, so
the mode splits a step at each gather (`Bundles`): for each hop a kernel
here writes, for every requested id, the row this shard owns or zeros into
a packed i32 bundle (floats as their bits, bools as 0/1), and one NCCL
all_reduce(SUM) over the model row assembles it.  Exactly one shard owns
each id, so each word is one owner's bits plus zeros: exact whatever the
type, -0.0 and NaN included.  The hops of a step, by slot (the relocations,
the swaps' sources, the swaps' partners, the leadership targets; `slots`):

  1. `shard_sources`: the source ids from the replicated draws.  An
     importance-sampled source is resolved by ownership of its place in the
     broker-grouped order, which is the shards' local groups in shard order
     (`below`: a broker's replicas on lower shards); the uniform draws are
     replicated and written by shard 0 alone.
  2. `own_rows`: the sources' replica rows (ROW_FIELDS, 18 words).
  3. `own_parts`: their partitions' rows: the member ids, then every rack's
     cell (the whole row: the destination of a relocation is not known
     before its body runs).
  4. `own_member_rows`, one launch of the `own_rows` kernel into one
     bundle: the members' brokers (relocation and swap slots) and the
     leadership targets' members' whole rows (the partition's leader and
     its row).

Then the candidates kernel's body reads the assembled bundles in place of
the global arrays (csrc/candidates.cu SHARD).  Per round, `shard_prc` adds
this shard's rows into every partition x rack cell, which a reduce_scatter
leaves on each shard's own rows.

Bound on the card: latency; each kernel moves a step's few MB (the rows of
K ids) once, and a step's time is its four all_reduces and the launches
between them.  `shard_sources` and `own_rows` issue their loads together
and keep a warp on one path (csrc/model_shard.cu's note); `own_parts` and
`shard_prc` run a thread a word and a row.  The plain versions are the
same functions in PyTorch ops, which the CPU tests run over gloo.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build, threefry

#: the words of a replica row in a bundle (csrc/model_shard.cu row_word)
ROW_FIELDS = ("broker", "part", "disk", "topic", "valid", "lead", "pos", "orig_broker",
              "orig_lead", "orig_disk", "ll0", "ll1", "ll2", "ll3", "lf0", "lf1", "lf2", "lf3")
ROW_WORDS = len(ROW_FIELDS)
_FNS = None


@dataclasses.dataclass(frozen=True)
class Block:
    """A shard's rows: replica ids [r_off, r_off + r_local), partition ids
    [p_off, p_off + p_local); shard j of n."""

    r_off: int
    r_local: int
    p_off: int
    p_local: int
    j: int
    n: int

    @staticmethod
    def of(R: int, P: int, j: int, n: int) -> "Block":
        if R % n or P % n:
            raise ValueError(f"model sharding needs R={R}, P={P} divisible by n={n} "
                             "(pad with shard_multiple_shape)")
        return Block(j * (R // n), R // n, j * (P // n), P // n, j, n)


def slots(K_r: int, K_s: int, K_l: int) -> dict:
    """The first slot of each kind in a step's bundles and their count."""
    return dict(rel=0, swap_r=K_r, swap_q=K_r + K_s, lead=K_r + 2 * K_s, n=K_r + 2 * K_s + K_l)


def _uniform(key, n: int, dev) -> torch.Tensor:
    return threefry.uniform_plain(key.words, n, 0.0, 1.0, dev)


def _uniform_idx(key, n: int, bound: int, dev) -> torch.Tensor:
    return threefry.uniform_idx_plain(key.words, n, bound, dev)


def importance_draws(keys4, n: int, n_imp: int, cdf, count, gen, dev):
    """The plain `_sample_sources`' draws of the last n_imp of n sources:
    (bsel, j, fallback), each of n_imp (the kernel's `source_of`)."""
    _, k3, k4, k5 = keys4
    u = _uniform(k3, n_imp, dev)
    bsel = torch.minimum(torch.clamp(torch.searchsorted(cdf, u, right=True), min=0),
                         gen.n_brokers - 1)
    j = (_uniform(k4, n_imp, dev) * count[bsel]).to(torch.int32)
    return bsel, j, _uniform_idx(k5, n_imp, gen.n_source, dev)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------


def shard_sources_plain(cp, keys, sp, gen, blk: Block, has_plan: bool) -> torch.Tensor:
    """i32[slots n]: hop 1, the step's source ids by slot, own-or-zero.
    `keys` a StepKeys, `sp` the round's ShardPlan (parallel/model_shard.py)."""
    dev = sp.count.device
    K_r, K_s, K_l = cp.K_r, cp.K_s, cp.K_l
    first = blk.j == 0
    parts = []
    for n, keys4 in ((K_r, keys.rel_src), (K_s, keys.swap_src)):
        n_imp = cp.n_imp(n, sp if has_plan else None)
        uni = _uniform_idx(keys4[0], n - n_imp, gen.n_source, dev)
        parts.append(uni if first else torch.zeros_like(uni))
        if n_imp:
            bsel, j, fallback = importance_draws(keys4, n, n_imp, sp.broker_cdf, sp.count, gen, dev)
            lj = j - sp.below[bsel]
            own = (lj >= 0) & (lj < sp.count_local[bsel])
            slot = torch.clamp(sp.start[bsel] + lj, 0, blk.r_local - 1)
            ids = torch.where(own, sp.order[slot] + blk.r_off, 0)
            fb = fallback if first else torch.zeros_like(fallback)
            parts.append(torch.where(sp.count[bsel] > 0, ids, fb).to(torch.int32))
    q = _uniform_idx(keys.swap_q, K_s, gen.n_source, dev) if K_s else torch.zeros(0, dtype=torch.int32, device=dev)
    rt = _uniform_idx(keys.lead, K_l, gen.n_source, dev) if K_l else torch.zeros(0, dtype=torch.int32, device=dev)
    for t in (q, rt):
        parts.append(t if first else torch.zeros_like(t))
    out = torch.cat([p.to(torch.int32) for p in parts]) if parts else torch.zeros(0, dtype=torch.int32)
    return out.to(dev)


def row_columns(st, carry) -> dict:
    """A shard's replica columns, in ROW_FIELDS' sources: the carry's
    placement and the statics' state."""
    return dict(broker=carry.replica_broker, part=st.replica_partition, disk=carry.replica_disk,
                topic=st.replica_topic, valid=st.replica_valid, lead=carry.replica_is_leader,
                pos=st.replica_pos, orig_broker=st.replica_broker, orig_lead=st.replica_is_leader,
                orig_disk=st.replica_disk, load_leader=st.replica_load_leader,
                load_follower=st.replica_load_follower)


def own_rows_plain(ids: torch.Tensor, words: int, cols: dict, blk: Block) -> torch.Tensor:
    """i32[ids.numel(), words]: each id's replica row (ROW_FIELDS, or the
    broker alone at words=1) where this shard owns it, zeros elsewhere."""
    li = ids.reshape(-1).long() - blk.r_off
    own = (li >= 0) & (li < blk.r_local)
    lc = torch.clamp(li, 0, max(blk.r_local - 1, 0))
    i32 = torch.int32
    if words == 1:
        out = cols["broker"][lc].to(i32)[:, None]
    else:
        out = torch.cat([
            torch.stack([cols[f][lc].to(i32) for f in ROW_FIELDS[:10]], 1),
            cols["load_leader"][lc].contiguous().view(i32),
            cols["load_follower"][lc].contiguous().view(i32),
        ], 1)
    return torch.where(own[:, None], out, 0)


def own_member_rows_plain(parts: torch.Tensor, n_rs: int, max_rf: int, cols: dict,
                          blk: Block) -> torch.Tensor:
    """i32[n_rs max_rf + (n - n_rs) max_rf ROW_WORDS], hop 4's bundle: the
    brokers of the members of the first n_rs rows of `parts` (i32[n, pw],
    the member ids first), then the whole rows of the other rows' members,
    own-or-zero (`own_rows_plain` of each, one after the other)."""
    mb = own_rows_plain(parts[:n_rs, :max_rf], 1, cols, blk)
    ml = own_rows_plain(parts[n_rs:, :max_rf], ROW_WORDS, cols, blk)
    return torch.cat([mb.reshape(-1), ml.reshape(-1)])


def own_parts_plain(parts: torch.Tensor, members: torch.Tensor, prc: torch.Tensor,
                    blk: Block) -> torch.Tensor:
    """i32[n, max_rf + racks]: each partition id's member ids and rack cells
    where this shard owns it, zeros elsewhere."""
    lp = parts.reshape(-1).long() - blk.p_off
    own = (lp >= 0) & (lp < blk.p_local)
    lc = torch.clamp(lp, 0, max(blk.p_local - 1, 0))
    out = torch.cat([members[lc], prc[lc]], 1).to(torch.int32)
    return torch.where(own[:, None], out, 0)


def shard_prc_plain(st, replica_broker, num_parts: int) -> torch.Tensor:
    """i32[num_parts, racks]: this shard's rows counted into every
    partition x rack cell (the global partition ids)."""
    nr = st.shape.num_racks
    rack = st.broker_rack[replica_broker.long()]
    seg = torch.where(st.replica_valid, st.replica_partition.long() * nr + rack, num_parts * nr)
    out = torch.zeros(num_parts * nr + 1, dtype=torch.int32, device=replica_broker.device)
    out.index_add_(0, seg, st.replica_valid.to(torch.int32))
    return out[: num_parts * nr].reshape(num_parts, nr)


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------


class _SourceArgs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "K_r", "K_s", "K_l", "n_imp_r", "n_imp_s", "B", "r_off", "r_local", "shard", "step",
        "steps_per_round", "cdf_in_smem")] + [(f, ctypes.c_void_p) for f in (
        "key_table", "rnd", "cdf", "count", "count_local", "below", "start_local", "order_local",
        "gen", "out")]


class _RowSrc(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "broker", "part", "disk", "topic", "valid", "lead", "pos", "orig_broker", "orig_lead",
        "orig_disk", "load_leader", "load_follower")]


class _RowPart(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("n", "m", "stride")] + [
        (f, ctypes.c_void_p) for f in ("ids", "out")]


class _RowArgs(ctypes.Structure):
    _fields_ = [("r_off", ctypes.c_int), ("r_local", ctypes.c_int), ("src", _RowSrc),
                ("brokers", _RowPart), ("rows", _RowPart)]


class _PartArgs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("n", "stride", "p_off", "p_local", "max_rf", "racks")] + [
        (f, ctypes.c_void_p) for f in ("parts", "members", "prc", "out")]


class _PrcArgs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("R", "B", "P", "racks")] + [
        (f, ctypes.c_void_p) for f in ("broker", "part", "valid", "broker_rack", "prc")]


def _fns():
    global _FNS
    if _FNS is None:
        lib = _build.library("model_shard")
        fns = {}
        for name, args in (("cc_shard_sources", _SourceArgs), ("cc_own_rows", _RowArgs),
                           ("cc_own_parts", _PartArgs), ("cc_shard_prc", _PrcArgs)):
            fn = getattr(lib, name)
            fn.argtypes = [args, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name] = fn
        _FNS = fns
    return _FNS


#: `shard_sources` stages the broker CDF in shared memory, for its
#: binary search, where the CDF's 4 B bytes fit this; past it the search
#: probes global memory.  Every block of importance-sampled slots copies the
#: whole CDF, so the copy outgrows the probes it saves as B grows: on an
#: H100 staging saves ~10% up to 5,000 brokers and loses from 7,500 on
#: (PERF.md §6, `scripts/time_model_shard.py --brokers`).
SOURCES_CDF_SMEM_MAX = 24 * 1024


def _need(name, t, dtype, shape) -> int:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"model_shard: {name} must be contiguous CUDA {dtype}{list(shape)}, "
                         f"got {t.dtype}{list(t.shape)} on {t.device}")
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def shard_sources(cp, keys, sp, gen, blk: Block, has_plan: bool, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Hop 1 (see the module note): `keys` a StepKeys (CPU) or a
    KeyCursor (the kernel reads its row at the device's round index), `sp`
    the round's ShardPlan, `out` i32[slots n] (allocated when None)."""
    from cruise_control_tpu_torch.kernels import candidates as cand_k

    n = slots(cp.K_r, cp.K_s, cp.K_l)["n"]
    dev = sp.count.device
    if kernels.route(sp.count, gen.words) == "cpu":
        if isinstance(keys, cand_k.KeyCursor):
            keys = keys.step_keys()
        res = shard_sources_plain(cp, keys, sp, gen, blk, has_plan)
        return res if out is None else out.copy_(res)
    if not isinstance(keys, cand_k.KeyCursor):
        keys = cand_k.KeyCursor.of(keys, dev)
    if cp.prior or cp.intra:
        raise ValueError("model_shard: the card's sharded-model step runs the default kinds only "
                         "(no learned prior, no intra-broker moves)")
    out = torch.empty(n, dtype=torch.int32, device=dev) if out is None else out
    B = int(sp.count.shape[0])
    i32, f32 = torch.int32, torch.float32
    plan = sp if has_plan else None
    args = _SourceArgs(
        K_r=cp.K_r, K_s=cp.K_s, K_l=cp.K_l, n_imp_r=cp.n_imp(cp.K_r, plan),
        n_imp_s=cp.n_imp(cp.K_s, plan), B=B, r_off=blk.r_off, r_local=blk.r_local, shard=blk.j,
        step=keys.step, steps_per_round=keys.steps_per_round,
        cdf_in_smem=int(4 * B <= SOURCES_CDF_SMEM_MAX),
        key_table=_need("key_table", keys.table, i32, tuple(keys.table.shape)),
        rnd=_need("rnd", keys.rnd, i32, (1,)),
        cdf=_need("broker_cdf", sp.broker_cdf, f32, (B,)),
        count=_need("count", sp.count, i32, (B,)),
        count_local=_need("count_local", sp.count_local, i32, (B,)),
        below=_need("below", sp.below, i32, (B,)),
        start_local=_need("start", sp.start, i32, (B,)),
        order_local=_need("order", sp.order, i32, (blk.r_local,)),
        gen=_need("gen", gen.words, i32, tuple(gen.words.shape)),
        out=_need("out", out, i32, (n,)),
    )
    _build.check(_fns()["cc_shard_sources"](args, _stream(out)), "shard_sources")
    kernels.count("shard_sources")
    return out


def _row_src(cols: dict, blk: Block) -> _RowSrc:
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    Rl = blk.r_local
    types = dict(valid=b8, lead=b8, orig_lead=b8)
    src = _RowSrc(**{f: _need(f, cols[f], types.get(f, i32), (Rl,)) for f in (
        "broker", "part", "disk", "topic", "valid", "lead", "pos", "orig_broker", "orig_lead",
        "orig_disk")}, load_leader=_need("load_leader", cols["load_leader"], f32, (Rl, 4)),
        load_follower=_need("load_follower", cols["load_follower"], f32, (Rl, 4)))
    if (src.load_leader or 0) % 16 or (src.load_follower or 0) % 16:
        raise ValueError("model_shard: the load rows must start on 16 bytes (a float4 a row)")
    return src


def _row_part(ids: torch.Tensor, n: int, m: int, stride: int, out: torch.Tensor) -> _RowPart:
    if not ids.is_contiguous() or ids.dtype != torch.int32 or (
            n and ids.numel() < (n - 1) * stride + m):
        raise ValueError("model_shard: own_rows' ids must be a contiguous i32 buffer holding the rows")
    return _RowPart(n=n, m=m, stride=stride, ids=ids.data_ptr(), out=out.data_ptr())


def own_rows(ids: torch.Tensor, words: int, cols: dict, blk: Block, *, m: int = 1,
             stride: int = 1, n: int | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """Hop 2: i32[n * m, words] rows of ids[(k // m) * stride + k % m]
    (all of a 1-D `ids` by default), words = ROW_WORDS or 1 (the broker)."""
    if words not in (1, ROW_WORDS):
        raise ValueError(f"model_shard: a row is 1 or {ROW_WORDS} words, got {words}")
    if n is None:
        n = int(ids.numel()) // m if stride == 1 else int(ids.shape[0])
    if kernels.route(ids, cols["broker"]) == "cpu":
        sel = ids.reshape(-1, stride)[:n, :m] if stride != 1 or m != 1 else ids.reshape(-1)[:n]
        res = own_rows_plain(sel, words, cols, blk)
        return res if out is None else out.copy_(res)
    out = torch.empty((n * m, words), dtype=torch.int32, device=ids.device) if out is None else out
    _need("out", out, torch.int32, (n * m, words))
    if n * m == 0:
        return out
    part = _row_part(ids, n, m, stride, out)
    none = _RowPart(n=0, m=1, stride=1)
    args = _RowArgs(r_off=blk.r_off, r_local=blk.r_local, src=_row_src(cols, blk),
                    brokers=part if words == 1 else none, rows=none if words == 1 else part)
    _build.check(_fns()["cc_own_rows"](args, _stream(out)), "own_rows")
    kernels.count("own_rows")
    return out


def own_member_rows(parts: torch.Tensor, n_rs: int, max_rf: int, cols: dict, blk: Block,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Hop 4 in one launch of the own_rows kernel (`own_member_rows_plain`):
    `parts` i32[n, pw] hop 3's bundle, the member ids in its first max_rf
    words; the brokers of the first n_rs rows' members, then the whole
    rows of the other n - n_rs rows' members, into one flat bundle."""
    n, pw = int(parts.shape[0]), int(parts.shape[1])
    if not 0 <= n_rs <= n or not 0 < max_rf <= pw:
        raise ValueError(f"model_shard: hop 4 takes 0 <= n_rs <= {n} rows of {max_rf} <= {pw} "
                         f"members, got n_rs={n_rs}, max_rf={max_rf}")
    size = n_rs * max_rf + (n - n_rs) * max_rf * ROW_WORDS
    if kernels.route(parts, cols["broker"]) == "cpu":
        res = own_member_rows_plain(parts, n_rs, max_rf, cols, blk)
        return res if out is None else out.copy_(res)
    out = torch.empty(size, dtype=torch.int32, device=parts.device) if out is None else out
    _need("out", out, torch.int32, (size,))
    if size == 0:
        return out
    flat = parts.reshape(-1)
    mb = out[: n_rs * max_rf]
    args = _RowArgs(r_off=blk.r_off, r_local=blk.r_local, src=_row_src(cols, blk),
                    brokers=_row_part(flat, n_rs, max_rf, pw, mb),
                    rows=_row_part(flat[n_rs * pw:], n - n_rs, max_rf, pw, out[n_rs * max_rf:]))
    _build.check(_fns()["cc_own_rows"](args, _stream(out)), "own_rows")
    kernels.count("own_member_rows")
    return out


def own_parts(parts: torch.Tensor, n: int, stride: int, members: torch.Tensor, prc: torch.Tensor,
              blk: Block, out: torch.Tensor | None = None) -> torch.Tensor:
    """Hop 3: i32[n, max_rf + racks], partition ids at parts[k * stride]."""
    max_rf, racks = int(members.shape[1]), int(prc.shape[1])
    if kernels.route(parts, members, prc) == "cpu":
        res = own_parts_plain(parts.reshape(-1)[: (n - 1) * stride + 1: stride] if n else
                              parts.reshape(-1)[:0], members, prc, blk)
        return res if out is None else out.copy_(res)
    i32 = torch.int32
    out = torch.empty((n, max_rf + racks), dtype=i32, device=parts.device) if out is None else out
    if not parts.is_contiguous() or parts.dtype != i32:
        raise ValueError("model_shard: own_parts' ids must be a contiguous i32 buffer")
    args = _PartArgs(n=n, stride=stride, p_off=blk.p_off, p_local=blk.p_local, max_rf=max_rf,
                     racks=racks, parts=parts.data_ptr(),
                     members=_need("members", members, i32, (blk.p_local, max_rf)),
                     prc=_need("part_rack_count", prc, i32, (blk.p_local, racks)),
                     out=_need("out", out, i32, (n, max_rf + racks)))
    _build.check(_fns()["cc_own_parts"](args, _stream(out)), "own_parts")
    kernels.count("own_parts")
    return out


def shard_prc(st, replica_broker: torch.Tensor, num_parts: int, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """i32[num_parts, racks]: this shard's rows (`st`'s, with the placement
    `replica_broker`) counted into every partition x rack cell."""
    if kernels.route(replica_broker, st.replica_valid) == "cpu":
        res = shard_prc_plain(st, replica_broker, num_parts)
        return res if out is None else out.copy_(res)
    s = st.shape
    i32 = torch.int32
    nr = s.num_racks
    out = torch.empty((num_parts, nr), dtype=i32, device=replica_broker.device) if out is None else out
    _need("part_rack_count", out, i32, (num_parts, nr))
    out.zero_()
    args = _PrcArgs(R=s.R, B=s.B, P=num_parts, racks=nr,
                    broker=_need("replica_broker", replica_broker, i32, (s.R,)),
                    part=_need("replica_partition", st.replica_partition, i32, (s.R,)),
                    valid=_need("replica_valid", st.replica_valid, torch.bool, (s.R,)),
                    broker_rack=_need("broker_rack", st.broker_rack, i32, (s.B,)),
                    prc=out.data_ptr())
    _build.check(_fns()["cc_shard_prc"](args, _stream(out)), "shard_prc")
    kernels.count("shard_prc")
    return out
