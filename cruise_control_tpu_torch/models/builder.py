"""Host-side builder: topology + per-partition loads -> ClusterState tensors.

Plays the role of reference model/ClusterModel.java's creation API
(createRack:892, createBroker:867, createReplica:768, setReplicaLoad:684):
callers feed it brokers and partitions (one at a time, `ClusterModelBuilder`,
or as columns, `build_state_columnar`); it emits the state's tensors on the
requested device.  With a `ShapeBucketPolicy` the shape is rounded up to
its bucket and the rows beyond the data become masked padding; `pad_state`
pads a built state the same way, and `prewarm_state` is a minimal valid
state of a given shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.models.state import (
    STATE_FIELDS,
    ClusterShape,
    ClusterState,
    ShapeBucketPolicy,
    replica_members,
)


@dataclasses.dataclass
class BrokerSpec:
    broker_id: int
    rack: str
    host: str | None = None  # defaults to one host per broker
    capacity: np.ndarray | None = None  # [4]; DISK overridden by disk sum if disks given
    disk_capacities: list[float] | None = None  # JBOD logdir capacities
    alive: bool = True
    new_broker: bool = False
    bad_disks: list[int] | None = None


@dataclasses.dataclass(frozen=True)
class ClusterCatalog:
    """Host-side id <-> name mappings of one built ClusterState: the state
    carries dense integer ids, and whatever talks to the outside world
    resolves names here."""

    topics: tuple[str, ...]  # topic name by topic id
    partitions: tuple[tuple[str, int], ...]  # (topic name, partition number) by global pid
    racks: tuple[str, ...] = ()
    hosts: tuple[str, ...] = ()

    def __post_init__(self):
        # name -> id dict built once (frozen dataclass: bypass the setattr guard)
        object.__setattr__(self, "_topic_idx", {t: i for i, t in enumerate(self.topics)})

    def topic_id(self, name: str) -> int:
        return self._topic_idx[name]

    def partition_key(self, pid: int) -> tuple[str, int]:
        return self.partitions[pid]

    def topic_names_by_id(self) -> dict[int, str]:
        return dict(enumerate(self.topics))


@dataclasses.dataclass
class PartitionSpec:
    topic: str
    partition: int
    replica_brokers: list[int]  # first entry = current leader
    leader_load: np.ndarray  # [4] utilization when leading
    follower_load: np.ndarray | None = None  # [4]; default derives from leader_load
    replica_disks: list[int] | None = None
    leader_pos: int = 0  # index into replica_brokers of the current leader


def default_follower_load(leader_load: np.ndarray, follower_cpu_fraction: float = 0.3) -> np.ndarray:
    """Follower load derived from leader load: NW_OUT drops to 0 (only leaders
    serve consumer fetch), CPU drops to a configured follower share
    (reference model/ModelUtils.getFollowerCpuUtilFromLeaderLoad:53-67),
    NW_IN and DISK are unchanged."""
    f = np.array(leader_load, dtype=np.float32).copy()
    f[Resource.NW_OUT] = 0.0
    f[Resource.CPU] = leader_load[Resource.CPU] * follower_cpu_fraction
    return f


@dataclasses.dataclass
class _BrokerArrays:
    racks: list[str]
    hosts: list[str]
    D: int
    capacity: np.ndarray  # [B, 4]
    rack: np.ndarray  # int32 [B]
    host: np.ndarray  # int32 [B]
    alive: np.ndarray  # bool [B]
    new: np.ndarray  # bool [B]
    disk_capacity: np.ndarray  # [B, D]
    disk_alive: np.ndarray  # bool [B, D]


def _broker_arrays(brokers: list[BrokerSpec]) -> _BrokerArrays:
    brokers = sorted(brokers, key=lambda b: b.broker_id)
    ids = [b.broker_id for b in brokers]
    if ids != list(range(len(ids))):
        raise ValueError(f"broker ids must be dense 0..B-1, got {ids}")
    B = len(brokers)
    racks = sorted({b.rack for b in brokers})
    rack_idx = {r: i for i, r in enumerate(racks)}
    hosts = sorted({b.host if b.host is not None else f"__host_{b.broker_id}" for b in brokers})
    host_idx = {h: i for i, h in enumerate(hosts)}

    D = max((len(b.disk_capacities) for b in brokers if b.disk_capacities), default=1)
    out = _BrokerArrays(
        racks=racks,
        hosts=hosts,
        D=D,
        capacity=np.zeros((B, NUM_RESOURCES), np.float32),
        rack=np.zeros(B, np.int32),
        host=np.zeros(B, np.int32),
        alive=np.zeros(B, bool),
        new=np.zeros(B, bool),
        disk_capacity=np.zeros((B, D), np.float32),
        disk_alive=np.zeros((B, D), bool),
    )
    for i, b in enumerate(brokers):
        cap = np.asarray(
            b.capacity if b.capacity is not None else [100.0, 1e5, 1e5, 1e6], np.float32
        )
        if b.disk_capacities:
            dc = np.asarray(b.disk_capacities, np.float32)
            out.disk_capacity[i, : len(dc)] = dc
            out.disk_alive[i, : len(dc)] = True
            cap = cap.copy()
            cap[Resource.DISK] = dc.sum()
        else:
            out.disk_capacity[i, 0] = cap[Resource.DISK]
            out.disk_alive[i, 0] = True
        for bad in b.bad_disks or []:
            out.disk_alive[i, bad] = False
        out.capacity[i] = cap
        out.rack[i] = rack_idx[b.rack]
        out.host[i] = host_idx[b.host if b.host is not None else f"__host_{b.broker_id}"]
        out.alive[i] = b.alive
        out.new[i] = b.new_broker
    return out


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Zero/False-pad the leading axis of `a` out to n rows."""
    if a.shape[0] == n:
        return a
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def state_from_numpy(arrays: dict, shape: ClusterShape, device) -> ClusterState:
    """ClusterState from host numpy arrays keyed by field name (int32 ids,
    bool masks, float32 loads), copied onto `device`."""
    dtypes = {np.dtype(bool): torch.bool, np.dtype(np.float32): torch.float32}

    def conv(a):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # e.g. a read-only view of another framework's buffer
            a = a.copy()
        dt = dtypes.get(a.dtype)
        if dt is None:
            a = a.astype(np.int32)
            dt = torch.int32
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return ClusterState(shape=shape, **{k: conv(v) for k, v in arrays.items()})


def _assemble_state(
    ba: _BrokerArrays,
    shape: ClusterShape,
    r_broker, r_part, r_topic, r_pos, r_leader, r_valid, r_offline, r_disk,
    r_ll, r_fl,
    device,
) -> ClusterState:
    # shape may be a bucketed superset of the data: replica rows beyond the
    # data and broker rows beyond the real brokers become padding
    B_real = ba.capacity.shape[0]
    B = shape.B
    broker_valid = np.zeros(B, bool)
    broker_valid[:B_real] = True
    D = shape.max_disks_per_broker
    R = shape.R
    arrays = dict(
        replica_broker=_pad_rows(r_broker, R),
        replica_partition=_pad_rows(r_part, R),
        replica_topic=_pad_rows(r_topic, R),
        replica_pos=_pad_rows(r_pos, R),
        replica_is_leader=_pad_rows(r_leader, R),
        replica_valid=_pad_rows(r_valid, R),
        replica_orig_broker=_pad_rows(r_broker.copy(), R),
        replica_offline=_pad_rows(r_offline, R),
        replica_disk=_pad_rows(r_disk, R),
        replica_load_leader=_pad_rows(r_ll, R),
        replica_load_follower=_pad_rows(r_fl, R),
        broker_capacity=_pad_rows(ba.capacity, B),
        broker_rack=_pad_rows(ba.rack, B),
        broker_host=_pad_rows(ba.host, B),
        broker_alive=_pad_rows(ba.alive, B),
        broker_new=_pad_rows(ba.new, B),
        broker_valid=broker_valid,
        disk_capacity=_pad_rows(ba.disk_capacity, B)[:, :D],
        disk_alive=_pad_rows(ba.disk_alive, B)[:, :D],
    )
    state = state_from_numpy(arrays, shape, device)
    # the member table (`ClusterState.members`) from the host arrays at
    # hand: a model built on the card reads nothing back for it
    state.__dict__["members"] = torch.as_tensor(
        replica_members(arrays["replica_valid"], arrays["replica_partition"], arrays["replica_pos"], shape),
        device=state.device,
    )
    return state


def _replica_arrays(R: int) -> dict:
    """Zeroed host arrays of the replica axis, in `_assemble_state`'s
    argument order."""
    return dict(
        r_broker=np.zeros(R, np.int32), r_part=np.zeros(R, np.int32),
        r_topic=np.zeros(R, np.int32), r_pos=np.zeros(R, np.int32),
        r_leader=np.zeros(R, bool), r_valid=np.zeros(R, bool), r_offline=np.zeros(R, bool),
        r_disk=np.zeros(R, np.int32), r_ll=np.zeros((R, NUM_RESOURCES), np.float32),
        r_fl=np.zeros((R, NUM_RESOURCES), np.float32),
    )


def build_state_columnar(
    brokers: list[BrokerSpec],
    cols,
    leader_load: np.ndarray,
    follower_load: np.ndarray,
    *,
    replica_capacity: int | None = None,
    bucket_policy: ShapeBucketPolicy | None = None,
    device=None,
) -> tuple[ClusterState, ClusterCatalog]:
    """Vectorized twin of ClusterModelBuilder.build for monitor-shaped input.

    `cols` is array-encoded partition metadata with the fields of the JAX
    package's monitor.topology.TopologyColumns: topic_names (by first-seen
    topic id), part_topic, part_num, part_leader_pos and replica_counts [P],
    replica_offsets [P] into the flat replica_broker array.  leader_load /
    follower_load: f32[P, 4] in cols' partition order.  The output (order,
    catalog and arrays) is what feeding the same data through
    ClusterModelBuilder one PartitionSpec at a time gives.
    """
    device = resolve_device(device)
    ba = _broker_arrays(brokers)
    B = ba.capacity.shape[0]
    # partitions sorted by (topic name, partition number), the builder's
    # order; topic ids in cols are first-seen, ranked here by name
    T = len(cols.topic_names)
    by_name = sorted(range(T), key=lambda i: cols.topic_names[i])
    topics_sorted = [cols.topic_names[i] for i in by_name]
    rank_of_tid = np.empty(T, np.int32)
    rank_of_tid[by_name] = np.arange(T, dtype=np.int32)
    part_rank = rank_of_tid[np.asarray(cols.part_topic)]
    order = np.lexsort((np.asarray(cols.part_num), part_rank))
    P = order.size

    counts_o = np.asarray(cols.replica_counts)[order].astype(np.int64)
    total = int(counts_o.sum())
    R = replica_capacity or total
    if R < total:
        raise ValueError(f"replica_capacity {R} < actual replicas {total}")

    # each sorted partition's replica segment of the flat array
    seg_start = np.repeat(np.asarray(cols.replica_offsets)[order], counts_o)
    new_off = np.concatenate(([0], np.cumsum(counts_o)))
    within = np.arange(total, dtype=np.int64) - np.repeat(new_off[:-1], counts_o)
    src = seg_start + within

    a = _replica_arrays(R)
    rb = np.asarray(cols.replica_broker)[src]
    a["r_broker"][:total] = rb
    a["r_part"][:total] = np.repeat(np.arange(P, dtype=np.int32), counts_o)
    a["r_topic"][:total] = np.repeat(part_rank[order], counts_o)
    a["r_pos"][:total] = within
    a["r_leader"][:total] = within == np.repeat(
        np.asarray(cols.part_leader_pos)[order].astype(np.int64), counts_o)
    a["r_valid"][:total] = True
    # the monitor places replicas on disk 0
    a["r_offline"][:total] = ~ba.alive[rb] | ~ba.disk_alive[rb, 0]
    a["r_ll"][:total] = np.repeat(np.asarray(leader_load, np.float32)[order], counts_o, axis=0)
    a["r_fl"][:total] = np.repeat(np.asarray(follower_load, np.float32)[order], counts_o, axis=0)

    names_by_part = [cols.topic_names[t] for t in np.asarray(cols.part_topic)[order]]
    catalog = ClusterCatalog(
        topics=tuple(topics_sorted),
        partitions=tuple(zip(names_by_part, np.asarray(cols.part_num)[order].tolist())),
        racks=tuple(ba.racks),
        hosts=tuple(ba.hosts),
    )
    shape = ClusterShape(
        num_replicas=R,
        num_brokers=B,
        num_partitions=P,
        num_topics=max(len(topics_sorted), 1),
        num_racks=max(len(ba.racks), 1),
        num_hosts=max(len(ba.hosts), 1),
        max_disks_per_broker=ba.D,
    )
    if bucket_policy is not None:
        shape = bucket_policy.bucket_shape(shape)
    return _assemble_state(ba, shape, *a.values(), device), catalog


_REPLICA_FIELDS = STATE_FIELDS[:11]
_BROKER_FIELDS = STATE_FIELDS[11:]


def pad_state(state: ClusterState, shape: ClusterShape) -> ClusterState:
    """An already-built ClusterState padded out to a (bucketed) superset
    shape, on the state's device: replica and broker rows beyond the
    current shape become masked padding (replica_valid / broker_valid
    False, zeros elsewhere); the partition, topic, rack and host axes grow
    in the shape only (no replica references them)."""
    s = state.shape
    if shape == s:
        return state
    for f in dataclasses.fields(ClusterShape):
        if getattr(shape, f.name) < getattr(s, f.name):
            raise ValueError(f"pad_state cannot shrink {f.name}: {s} -> {shape}")

    def pad(t: torch.Tensor, n: int) -> torch.Tensor:
        out = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        out[: t.shape[0]] = t
        return out

    kw = {f: pad(getattr(state, f), shape.R) for f in _REPLICA_FIELDS}
    D = shape.max_disks_per_broker
    for f in _BROKER_FIELDS:
        a = pad(getattr(state, f), shape.B)
        if f in ("disk_capacity", "disk_alive") and a.shape[1] < D:
            wide = torch.zeros((shape.B, D), dtype=a.dtype, device=a.device)
            wide[:, : a.shape[1]] = a
            a = wide
        kw[f] = a
    return dataclasses.replace(state, shape=shape, **kw)


def prewarm_state(shape: ClusterShape, *, max_rf: int = 1, device=None) -> ClusterState:
    """A minimal valid ClusterState of `shape`: one partition with max_rf
    replicas on distinct brokers, front-packed, everything else zeros or
    defaults (engines are built per shape, and the partition member
    table's width is the max replication factor)."""
    R, B, D = shape.R, shape.B, shape.max_disks_per_broker
    max_rf = max(1, min(int(max_rf), R, B))
    n = max_rf
    r_broker = np.zeros(R, np.int32)
    r_broker[:n] = np.arange(n, dtype=np.int32)
    r_pos = np.zeros(R, np.int32)
    r_pos[:n] = np.arange(n, dtype=np.int32)
    r_leader = np.zeros(R, bool)
    r_leader[0] = True
    r_valid = np.zeros(R, bool)
    r_valid[:n] = True
    zeros_load = np.zeros((R, NUM_RESOURCES), np.float32)
    arrays = dict(
        replica_broker=r_broker,
        replica_partition=np.zeros(R, np.int32),
        replica_topic=np.zeros(R, np.int32),
        replica_pos=r_pos,
        replica_is_leader=r_leader,
        replica_valid=r_valid,
        replica_orig_broker=r_broker.copy(),
        replica_offline=np.zeros(R, bool),
        replica_disk=np.zeros(R, np.int32),
        replica_load_leader=zeros_load,
        replica_load_follower=zeros_load.copy(),
        broker_capacity=np.ones((B, NUM_RESOURCES), np.float32),
        broker_rack=np.zeros(B, np.int32),
        broker_host=np.arange(B, dtype=np.int32) % max(1, shape.num_hosts),
        broker_alive=np.ones(B, bool),
        broker_new=np.zeros(B, bool),
        broker_valid=np.ones(B, bool),
        disk_capacity=np.ones((B, D), np.float32),
        disk_alive=np.ones((B, D), bool),
    )
    return state_from_numpy(arrays, shape, resolve_device(device))


class ClusterModelBuilder:
    def __init__(
        self,
        *,
        replica_capacity: int | None = None,
        follower_cpu_fraction: float = 0.3,
        bucket_policy: ShapeBucketPolicy | None = None,
    ):
        self._brokers: list[BrokerSpec] = []
        self._partitions: list[PartitionSpec] = []
        self._replica_capacity = replica_capacity
        self._follower_cpu_fraction = follower_cpu_fraction
        self._bucket_policy = bucket_policy
        #: the last build's catalog
        self.catalog: ClusterCatalog | None = None

    def add_broker(self, spec: BrokerSpec) -> "ClusterModelBuilder":
        self._brokers.append(spec)
        return self

    def add_partition(self, spec: PartitionSpec) -> "ClusterModelBuilder":
        self._partitions.append(spec)
        return self

    def build(self, device=None) -> ClusterState:
        device = resolve_device(device)
        ba = _broker_arrays(self._brokers)
        brokers = sorted(self._brokers, key=lambda b: b.broker_id)
        B = len(brokers)
        disk_alive = ba.disk_alive
        topics = sorted({p.topic for p in self._partitions})
        topic_idx = {t: i for i, t in enumerate(topics)}

        parts = sorted(self._partitions, key=lambda p: (p.topic, p.partition))
        P = len(parts)
        n_replicas = sum(len(p.replica_brokers) for p in parts)
        R = self._replica_capacity or n_replicas
        if R < n_replicas:
            raise ValueError(f"replica_capacity {R} < actual replicas {n_replicas}")

        r = _replica_arrays(R)
        r_broker, r_part, r_topic, r_pos, r_leader, r_valid, r_offline, r_disk, r_ll, r_fl = r.values()

        k = 0
        for pid, p in enumerate(parts):
            ll = np.asarray(p.leader_load, np.float32)
            fl = (
                np.asarray(p.follower_load, np.float32)
                if p.follower_load is not None
                else default_follower_load(ll, self._follower_cpu_fraction)
            )
            for pos, bid in enumerate(p.replica_brokers):
                r_broker[k] = bid
                r_part[k] = pid
                r_topic[k] = topic_idx[p.topic]
                r_pos[k] = pos
                r_leader[k] = pos == p.leader_pos
                r_valid[k] = True
                disk = (p.replica_disks or [0] * len(p.replica_brokers))[pos]
                r_disk[k] = disk
                r_offline[k] = (not brokers[bid].alive) or (not disk_alive[bid, disk])
                r_ll[k] = ll
                r_fl[k] = fl
                k += 1

        self.catalog = ClusterCatalog(
            topics=tuple(topics),
            partitions=tuple((p.topic, p.partition) for p in parts),
            racks=tuple(ba.racks),
            hosts=tuple(ba.hosts),
        )
        shape = ClusterShape(
            num_replicas=R,
            num_brokers=B,
            num_partitions=P,
            num_topics=max(len(topics), 1),
            num_racks=max(len(ba.racks), 1),
            num_hosts=max(len(ba.hosts), 1),
            max_disks_per_broker=ba.D,
        )
        if self._bucket_policy is not None:
            shape = self._bucket_policy.bucket_shape(shape)
        return _assemble_state(ba, shape, *r.values(), device)
