"""Layout rules for sharding the flattened model over the model axis.

The engine's model (models/state.ClusterState inside analyzer/engine.py
EngineStatics, and the EngineCarry) has three families of fields:

  * replica/partition-indexed   -- O(R) / O(P) rows: placements, loads, id
    columns, the partition->replica member table, the per-partition rack
    census.  These are the memory at north-star scale and the tensors the
    sharded-model mode (ROADMAP queue 1 item 10b) splits over the model
    axis.
  * broker/host/disk-indexed    -- O(B) rows; replicated.
  * scalars / tiny metadata     -- replicated.

The rule tables are ordered (regex, layout) pairs matched against a
field's "/"-joined path, first match wins, as the JAX package's
models/sharding.py `match_partition_rules` (SNIPPETS.md [1]-[3]) matches
them against its pytrees' key paths.  A layout is a tuple of axis names,
one a leading dimension ("model": split in contiguous row blocks over the
model axis), () replicated.  The sharded-model mode (parallel/model_shard.py)
cuts each rank's blocks of the fields the statics rules name;
`shard_multiple_shape` is what the mesh engine pads a sharded model to.
"""

from __future__ import annotations

import dataclasses
import re

from cruise_control_tpu_torch.models.state import ClusterShape

REPLICATED: tuple = ()


def statics_partition_rules(model_axis: str):
    """EngineStatics field -> layout: replica-row and partition-row fields
    shard over the model axis, broker/disk/host/scalar fields replicate."""
    return (
        (r"state/replica_", (model_axis,)),
        (r"(^|/)part_replicas$", (model_axis,)),
        (r".", REPLICATED),
    )


def carry_partition_rules(restart_axis: str, model_axis: str):
    """EngineCarry field -> layout with the leading per-restart block axis:
    mutable replica placements and the partition rack census shard over
    the model axis; broker aggregates and the PRNG key replicate across
    it."""
    return (
        (r"(^|/)replica_(broker|is_leader|disk)$", (restart_axis, model_axis)),
        (r"(^|/)part_rack_count$", (restart_axis, model_axis)),
        (r".", (restart_axis,)),
    )


def field_paths(obj, prefix: str = "") -> list[str]:
    """The "/"-joined paths of a dataclass's fields, nested dataclasses
    expanded (the statics' `state/replica_broker`, ...)."""
    out = []
    for f in dataclasses.fields(obj):
        path = f"{prefix}{f.name}"
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out.extend(field_paths(v, path + "/"))
        else:
            out.append(path)
    return out


def match_partition_rules(rules, paths) -> dict[str, tuple]:
    """{path: layout of the first rule whose regex `search`es it}; a path
    no rule matches is replicated."""
    out = {}
    for name in paths:
        out[name] = REPLICATED
        for pat, layout in rules:
            if re.search(pat, name):
                out[name] = layout
                break
    return out


def shard_multiple_shape(shape: ClusterShape, n: int) -> ClusterShape:
    """Round the replica and partition axes of an (already bucketed) shape
    up to multiples of `n` so every model shard holds an equal contiguous
    block.  Other axes are untouched: broker/topic/rack/host fields stay
    replicated."""
    if n <= 1:
        return shape

    def up(v: int) -> int:
        return ((int(v) + n - 1) // n) * n

    return dataclasses.replace(
        shape,
        num_replicas=up(shape.num_replicas),
        num_partitions=up(shape.num_partitions),
    )
