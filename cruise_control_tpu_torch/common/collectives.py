"""Context-gated model-axis reductions for the sharded-model engine.

The goal chain and `compute_aggregates` reduce over the replica and
partition axes.  When the flattened model is *sharded* over the model axis
(parallel/model_shard.py) those tensors are shard-local slices, so every
such reduction must end with a sum over the model axis's process group to
recover the global value.  When the model is replicated (the plain engine,
the replicated mesh mode) the same code must run exactly as before.

Rather than thread a group argument through every goal signature, the
active model group rides in a contextvar: the engine brackets its
`chain.evaluate` / `compute_aggregates` call sites with
`model_axis_scope(group)`.  With no active scope every helper is the plain
op (`gsum(x)` is `x.sum()`, `gsegment_sum` an `index_add_` into zeros), so
the unsharded path is untouched by construction, as in the JAX package's
common/collectives.py.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

#: the model axis's ProcessGroup for the current scope, or None (replicated)
_MODEL_GROUP: contextvars.ContextVar = contextvars.ContextVar("cruise_model_group", default=None)

#: the model-axis collectives this process issued (a rank's own count, read
#: per run): calls by kind and the bytes of their inputs
COUNTS = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0, "bytes": 0}


def counts() -> dict:
    """A copy of `COUNTS`."""
    return dict(COUNTS)


def model_axis():
    """The process group reductions must sum over, or None."""
    return _MODEL_GROUP.get()


@contextlib.contextmanager
def model_axis_scope(group):
    """Bracket marking replica/partition tensors as sharded over `group`
    (a torch.distributed ProcessGroup).  `group=None` is a no-op scope."""
    tok = _MODEL_GROUP.set(group)
    try:
        yield
    finally:
        _MODEL_GROUP.reset(tok)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of `t` over `group` (the model axis), counted."""
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COUNTS["all_reduce"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()
    return t


def all_gather_rows(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """out = the ranks' `inp` concatenated in rank order over `group`, counted."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)
    COUNTS["all_gather"] += 1
    COUNTS["bytes"] += inp.numel() * inp.element_size()
    return out


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; bool through int32 (exact: one shard contributes
    a possibly-nonzero value an element)."""
    y = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
    all_reduce_sum(y, group)
    return y.to(torch.bool) if x.dtype == torch.bool else y


def gsum(x: torch.Tensor) -> torch.Tensor:
    """Global `x.sum()` over a (possibly model-sharded) replica/partition
    tensor: the shard-local sum, then a sum over the group.  `.sum()` when
    no model axis is active."""
    s = x.sum()
    group = _MODEL_GROUP.get()
    return s if group is None else _psum(s, group)


def global_rows(n_local: int) -> int:
    """The global count of a model-sharded axis of `n_local` rows a shard
    (equal blocks): `n_local` times the group's size, `n_local` when no
    model axis is active."""
    group = _MODEL_GROUP.get()
    if group is None:
        return n_local
    import torch.distributed as dist

    return n_local * dist.get_world_size(group)


def gsegment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Global segment sum whose *segment ids* are global (broker ids, say)
    but whose *data* rows are model-sharded: each shard sums its local rows
    into the segments, then the partials are summed over the group.  Exact
    for ints; for floats the order of the partial sums differs from a
    single process's, so a float sum holds to the last bits only where
    its values add exactly (the JAX package quantizes its parity loads)."""
    part = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                       device=data.device)
    part.index_add_(0, segment_ids.long(), data)
    group = _MODEL_GROUP.get()
    return part if group is None else _psum(part, group)


def gscatter_rows(full: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter a `[rows, ...]` partial over the model axis and keep
    only this shard's `rows / n` slice (the partition-indexed
    `part_rack_count` stays sharded in the carry).  Identity when no model
    axis is active.  `rows` must divide by the group's size."""
    group = _MODEL_GROUP.get()
    if group is None:
        return full
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if full.shape[0] % n:
        raise ValueError(f"{full.shape[0]} rows do not divide over {n} shards")
    out = torch.empty((full.shape[0] // n,) + tuple(full.shape[1:]), dtype=full.dtype,
                      device=full.device)
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, full.contiguous(), op=dist.ReduceOp.SUM, group=group)
    COUNTS["reduce_scatter"] += 1
    COUNTS["bytes"] += full.numel() * full.element_size()
    return out
