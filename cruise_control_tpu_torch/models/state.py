"""Tensor-encoded cluster workload state — the flattened ClusterModel.

The reference models a cluster as a mutable object graph
Rack -> Host -> Broker -> Disk -> Replica (reference: model/ClusterModel.java:48).
Here the same information is a dataclass of fixed-shape tensors so goal
scores are segment reductions and candidate moves are gather/scatter deltas
over thousands of candidates at once.

Encoding (R = replica rows, B = broker count, D = max disks/broker):

  replica axis [R]:
    replica_broker      i32  current broker id (padding rows point at broker 0
                             and are masked out by replica_valid everywhere)
    replica_partition   i32  global partition id
    replica_topic       i32  topic id of the partition
    replica_pos         i32  position in the partition's replica list (0 =
                             preferred leader)
    replica_is_leader   bool currently the partition leader
    replica_valid       bool padding mask
    replica_orig_broker i32  broker at model-build time
    replica_offline     bool on a dead broker / bad disk; must be relocated
    replica_disk        i32  disk index within broker (JBOD), 0 if single-disk
    replica_load_leader   f32[R, 4]  utilization if this replica leads
    replica_load_follower f32[R, 4]  utilization as a follower

  broker axis [B]:
    broker_capacity f32[B, 4], broker_rack i32, broker_host i32,
    broker_alive bool, broker_new bool, broker_valid bool,
    disk_capacity f32[B, D], disk_alive bool[B, D]

The effective load of a replica is `where(is_leader, load_leader,
load_follower)`; moving leadership between two replicas of a partition
shifts CPU/NW_OUT between their brokers (reference
model/ClusterModel.java:374).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

#: the tensor fields of ClusterState, in declaration order
STATE_FIELDS = (
    "replica_broker",
    "replica_partition",
    "replica_topic",
    "replica_pos",
    "replica_is_leader",
    "replica_valid",
    "replica_orig_broker",
    "replica_offline",
    "replica_disk",
    "replica_load_leader",
    "replica_load_follower",
    "broker_capacity",
    "broker_rack",
    "broker_host",
    "broker_alive",
    "broker_new",
    "broker_valid",
    "disk_capacity",
    "disk_alive",
)


@dataclasses.dataclass(frozen=True)
class ClusterShape:
    """Static shape/topology metadata for a ClusterState."""

    num_replicas: int  # R
    num_brokers: int  # B
    num_partitions: int  # P
    num_topics: int
    num_racks: int
    num_hosts: int
    max_disks_per_broker: int  # D

    @property
    def R(self) -> int:  # noqa: N802 — math-style aliases
        return self.num_replicas

    @property
    def B(self) -> int:  # noqa: N802
        return self.num_brokers

    @property
    def P(self) -> int:  # noqa: N802
        return self.num_partitions


@dataclasses.dataclass(frozen=True)
class ShapeBucketPolicy:
    """Geometric shape-bucketing policy for engine-cache stability.

    Engines and their captured graphs are built per exact ClusterShape; a
    Kafka cluster creates partitions and adds brokers continuously, so an
    exact shape key makes nearly every model generation under churn a cache
    miss.  Rounding each axis up to the next bucket of the series
    ceil(floor * growth^k) makes successive generations land in the SAME
    padded shape, so `Engine.rebind()` swaps in the fresh data and only a
    bucket overflow (>= growth x accumulated churn) builds a new engine.

    The padding is masked everywhere: `replica_valid` for replicas,
    `broker_valid` for brokers (never alive, zero capacity, never a
    destination, outside every goal's denominator), and shape-only padding
    for partitions, topics, racks and hosts (no replica references them).
    """

    enabled: bool = True
    #: bucket growth factor between adjacent buckets (> 1)
    growth: float = 1.25
    #: smallest bucket; also the series base
    floor: int = 8

    def __post_init__(self):
        if self.growth <= 1.0:
            raise ValueError(f"bucket growth must be > 1, got {self.growth}")
        if self.floor < 1:
            raise ValueError(f"bucket floor must be >= 1, got {self.floor}")

    def bucket(self, n: int) -> int:
        """Smallest bucket >= n in the series ceil(floor * growth^k)."""
        if not self.enabled:
            return int(n)
        if n <= self.floor:
            return self.floor
        # the float log gets within one step of the right k; walk to the
        # exact smallest bucket so the series is deterministic and monotone
        k = max(0, int(math.log(n / self.floor) / math.log(self.growth)) - 1)
        b = int(math.ceil(self.floor * self.growth**k))
        while b < n:
            k += 1
            b = int(math.ceil(self.floor * self.growth**k))
        return b

    def bucket_shape(self, shape: ClusterShape) -> ClusterShape:
        """Every churn-prone axis rounded up to its bucket (D stays exact:
        logdir counts change only on hardware refresh)."""
        if not self.enabled:
            return shape
        return ClusterShape(
            num_replicas=self.bucket(shape.num_replicas),
            num_brokers=self.bucket(shape.num_brokers),
            num_partitions=self.bucket(shape.num_partitions),
            num_topics=self.bucket(shape.num_topics),
            num_racks=self.bucket(shape.num_racks),
            num_hosts=self.bucket(shape.num_hosts),
            max_disks_per_broker=shape.max_disks_per_broker,
        )

    def next_bucket_shape(self, shape: ClusterShape) -> ClusterShape:
        """The shape one partition-churn overflow lands in: the replica and
        partition axes bumped past their current bucket, the other axes at
        their current bucket (their churn is an order of magnitude rarer)."""
        return ClusterShape(
            num_replicas=self.bucket(self.bucket(shape.num_replicas) + 1),
            num_brokers=self.bucket(shape.num_brokers),
            num_partitions=self.bucket(self.bucket(shape.num_partitions) + 1),
            num_topics=self.bucket(shape.num_topics),
            num_racks=self.bucket(shape.num_racks),
            num_hosts=self.bucket(shape.num_hosts),
            max_disks_per_broker=shape.max_disks_per_broker,
        )


#: the default policy (the JAX package's config keys tpu.shape.bucket.*)
DEFAULT_BUCKET_POLICY = ShapeBucketPolicy()


@dataclasses.dataclass(frozen=True)
class ClusterState:
    # --- replica axis [R] ---
    replica_broker: torch.Tensor
    replica_partition: torch.Tensor
    replica_topic: torch.Tensor
    replica_pos: torch.Tensor
    replica_is_leader: torch.Tensor
    replica_valid: torch.Tensor
    replica_orig_broker: torch.Tensor
    replica_offline: torch.Tensor
    replica_disk: torch.Tensor
    replica_load_leader: torch.Tensor  # [R, NUM_RESOURCES]
    replica_load_follower: torch.Tensor  # [R, NUM_RESOURCES]
    # --- broker axis [B] ---
    broker_capacity: torch.Tensor  # [B, NUM_RESOURCES]
    broker_rack: torch.Tensor
    broker_host: torch.Tensor
    broker_alive: torch.Tensor
    broker_new: torch.Tensor
    broker_valid: torch.Tensor
    disk_capacity: torch.Tensor  # [B, D]
    disk_alive: torch.Tensor  # [B, D]
    # --- static metadata ---
    shape: ClusterShape

    @property
    def device(self) -> torch.device:
        return self.replica_broker.device

    @functools.cached_property
    def members(self) -> torch.Tensor:
        """i32[P, max_rf] member table of the state's cluster on its device
        (`replica_members`), built once per state: membership never
        changes during optimization, so callers that hold the table (the
        engine's statics) pass it instead."""
        h = [t.cpu().numpy() for t in (self.replica_valid, self.replica_partition, self.replica_pos)]
        return torch.as_tensor(replica_members(*h, self.shape), device=self.device)

    @property
    def replica_load(self) -> torch.Tensor:
        """Effective [R, 4] utilization given current leadership."""
        lead = self.replica_is_leader[:, None]
        load = torch.where(lead, self.replica_load_leader, self.replica_load_follower)
        return torch.where(self.replica_valid[:, None], load, 0.0)

    def broker_segment_ids(self) -> torch.Tensor:
        """Replica->broker ids with padding routed to an overflow bucket B."""
        return torch.where(self.replica_broker >= 0, self.replica_broker, self.shape.B)

    def with_replicas_moved(
        self,
        replica_idx: torch.Tensor,
        new_broker: torch.Tensor,
        new_disk: torch.Tensor | None = None,
    ) -> "ClusterState":
        """Placement update (reference ClusterModel.relocateReplica:347)."""
        rb = self.replica_broker.clone()
        rb[replica_idx] = new_broker.to(rb.dtype)
        disk = self.replica_disk.clone()
        disk[replica_idx] = 0 if new_disk is None else new_disk.to(disk.dtype)
        # offline tracks destination health, not a blanket clear: landing on a
        # dead broker/logdir keeps the replica offline
        nb = rb[replica_idx].long()
        dest_ok = self.broker_alive[nb] & self.disk_alive[nb, disk[replica_idx].long()]
        off = self.replica_offline.clone()
        off[replica_idx] = ~dest_ok
        return dataclasses.replace(self, replica_broker=rb, replica_offline=off, replica_disk=disk)

    def with_leadership_moved(
        self, from_replica: torch.Tensor, to_replica: torch.Tensor
    ) -> "ClusterState":
        """Transfer leadership between two replicas of the same partition
        (reference ClusterModel.relocateLeadership:374)."""
        lead = self.replica_is_leader.clone()
        lead[from_replica] = False
        lead[to_replica] = True
        return dataclasses.replace(self, replica_is_leader=lead)


def replica_members(valid: np.ndarray, part: np.ndarray, pos: np.ndarray,
                    shape: ClusterShape) -> np.ndarray:
    """i32[P, max_rf] the valid replica rows of each partition, in position
    order, padded with R (host numpy).  Raises unless the table holds every
    valid row exactly once: two valid rows of one partition whose positions
    clamp to one slot would drop a row (the refresh counts partition x rack
    cells from this table)."""
    table = member_table(valid, part, pos, shape)
    held, n_valid = int((table < shape.R).sum()), int(np.count_nonzero(valid))
    if held != n_valid:
        raise ValueError(f"replica positions collide: the member table holds {held} of "
                         f"{n_valid} valid replicas")
    return table


def member_table(valid: np.ndarray, part: np.ndarray, pos: np.ndarray,
                 shape: ClusterShape, max_rf: int | None = None) -> np.ndarray:
    """i32[P, max_rf] the valid replica rows of each partition, by position,
    padded with R (host numpy), as the JAX package's
    `partition_replica_table` builds it: `max_rf` None is the most valid
    replicas of one partition (at least 1); a position past the last
    column lands in it, and of two rows in one cell the later one stays."""
    P, R = shape.P, shape.R
    if max_rf is None:
        max_rf = 1
        counts = np.bincount(part[valid], minlength=P)
        if counts.size:
            max_rf = max(1, int(counts.max()))
    table = np.full((P, max_rf), R, np.int32)
    idx = np.nonzero(valid)[0]
    slot = np.minimum(pos[idx], max_rf - 1)
    table[part[idx], slot] = idx
    return table


def member_width(state: ClusterState) -> int:
    """The width of the state's member table (`replica_members`' max_rf:
    the most valid replicas of one partition, at least 1), without
    building the table where the state has none yet: one count on the
    state's device and one small read.  With the shape, it sizes an
    engine's buffers and the graphs captured on them."""
    table = vars(state).get("members")
    if table is not None:
        return int(table.shape[1])
    P = state.shape.P
    if P == 0:
        return 1
    part = torch.where(state.replica_valid, state.replica_partition.long().clamp(0, P), P)
    counts = torch.zeros(P + 1, dtype=torch.int32, device=state.device)
    counts.scatter_add_(0, part, torch.ones_like(part, dtype=torch.int32))
    return max(1, int(counts[:P].max()))


#: check names for validate_on_device's count vector, in order
DEVICE_CHECKS = (
    "broker ids out of range",
    "replica on invalid broker",
    "partitions without exactly one leader",
    "duplicate replica of a partition on one broker",
    "non-finite or negative leader loads",
)


def validate_on_device(state: ClusterState) -> torch.Tensor:
    """The invariants of validate(), computed on the state's device as an
    i32[5] violation-count vector (decode nonzero entries against
    DEVICE_CHECKS, then run the host validate for the detailed message)."""
    valid = state.replica_valid
    B, P = state.shape.B, state.shape.P
    rb = state.replica_broker.long()
    in_range = (rb >= 0) & (rb < B)
    lead = state.replica_is_leader & valid

    n_oor = (valid & ~in_range).sum()
    brk_c = torch.where(valid & in_range, rb, 0)
    n_invalid_broker = (valid & in_range & ~state.broker_valid[brk_c]).sum()

    part = torch.where(valid, state.replica_partition.long(), 0)
    # ids outside [0, P) land on a sentinel row instead of faulting
    part_seg = torch.where((part >= 0) & (part < P), part, P)
    leaders_per_part = torch.zeros(P + 1, dtype=torch.int64, device=rb.device)
    leaders_per_part.index_add_(0, part_seg, lead.long())
    present = torch.zeros(P + 1, dtype=torch.int64, device=rb.device)
    present.index_add_(0, part_seg, valid.long())
    n_bad_leader = ((present[:P] > 0) & (leaders_per_part[:P] != 1)).sum()

    # duplicate (partition, broker): sort one int64 key per pair and compare
    # neighbours; padding sorts to the end and is excluded by the valid mask
    brk = torch.where(valid, rb, -1)
    part_key = torch.where(valid, part, P)
    key = part_key * (1 << 32) + (brk + (1 << 31))
    key, order = torch.sort(key, stable=True)
    vs = valid[order]
    n_dup = ((key[1:] == key[:-1]) & vs[1:] & vs[:-1]).sum()

    loads = torch.where(valid[:, None], state.replica_load_leader, 0.0)
    n_bad_load = (~torch.isfinite(loads)).sum() + (loads < 0).sum()

    return torch.stack([n_oor, n_invalid_broker, n_bad_leader, n_dup, n_bad_load]).to(
        torch.int32
    )


def validate(state: ClusterState, *, strict: bool = True) -> list[str]:
    """Host-side structural sanity check (reference ClusterModel.sanityCheck:1081).

    Checks, on host numpy copies: exactly one leader per partition, broker
    ids in range and on valid brokers, no duplicate (partition, broker)
    placement, non-negative finite loads.  Returns the list of problems;
    raises if strict and non-empty.
    """
    problems: list[str] = []
    valid = state.replica_valid.cpu().numpy()
    part = state.replica_partition.cpu().numpy()[valid]
    brk = state.replica_broker.cpu().numpy()[valid]
    lead = state.replica_is_leader.cpu().numpy()[valid]
    load_l = state.replica_load_leader.cpu().numpy()
    B, P = state.shape.B, state.shape.P

    if brk.size:
        in_range = (brk >= 0) & (brk < B)
        if not in_range.all():
            problems.append(f"replica broker ids out of range [0,{B}): {brk.min()}..{brk.max()}")
        bvalid = state.broker_valid.cpu().numpy()
        if not bvalid[brk[in_range]].all():
            problems.append("replica placed on invalid (padding) broker")

    leaders_per_part = np.bincount(part[lead], minlength=P)
    present = np.bincount(part, minlength=P) > 0
    bad = present & (leaders_per_part != 1)
    if bad.any():
        problems.append(f"{int(bad.sum())} partitions without exactly one leader")

    pb = part.astype(np.int64) * B + brk.astype(np.int64)
    if np.unique(pb).size != pb.size:
        problems.append("duplicate replica of a partition on one broker")

    loads = load_l[valid]
    if not np.isfinite(loads).all() or (loads < 0).any():
        problems.append("non-finite or negative leader loads")

    if problems and strict:
        raise ValueError("ClusterState sanity check failed: " + "; ".join(problems))
    return problems
