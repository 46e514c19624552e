"""Cluster topology description + metadata provider SPI.

Plays the role of the reference's Kafka `Cluster` metadata +
common/MetadataClient.java:1 (refreshMetadata against brokers).  The
monitor consumes topology through this SPI so the same LoadMonitor serves
a real Kafka-backed provider, the simulated cluster backend
(executor tests), and synthetic fixtures.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np


@dataclasses.dataclass(frozen=True)
class BrokerNode:
    broker_id: int
    rack: str
    host: str
    alive: bool = True
    logdirs: tuple[str, ...] = ()
    offline_logdirs: tuple[str, ...] = ()
    is_new: bool = False


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    topic: str
    partition: int
    leader: int  # broker id, -1 if none
    replicas: tuple[int, ...]  # broker ids, preferred order
    replica_logdirs: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    brokers: tuple[BrokerNode, ...]
    partitions: tuple[PartitionInfo, ...]
    generation: int = 0

    def broker_ids(self) -> list[int]:
        return [b.broker_id for b in self.brokers]

    def alive_broker_ids(self) -> set[int]:
        return {b.broker_id for b in self.brokers if b.alive}

    def topics(self) -> list[str]:
        seen: dict[str, None] = {}
        for p in self.partitions:
            seen.setdefault(p.topic, None)
        return list(seen)

    @property
    def num_replicas(self) -> int:
        return sum(len(p.replicas) for p in self.partitions)

    def columns(self) -> "TopologyColumns":
        """Columnar view of the partition list (cached per instance).

        ONE Python pass over the PartitionInfo objects; everything
        downstream of this (model generation, builder) is array ops —
        the reference meters cluster-model creation as a first-class
        sensor (monitor/LoadMonitor.java:100,510) and this is what keeps
        that path O(P) numpy instead of O(replicas) Python."""
        cached = getattr(self, "_columns_cache", None)
        if cached is not None:
            return cached
        topic_ids: dict[str, int] = {}
        P = len(self.partitions)
        part_topic = np.empty(P, np.int32)
        part_num = np.empty(P, np.int32)
        part_leader_pos = np.empty(P, np.int32)
        counts = np.empty(P, np.int32)
        flat: list[tuple[int, ...]] = [()] * P
        for i, p in enumerate(self.partitions):
            tid = topic_ids.setdefault(p.topic, len(topic_ids))
            part_topic[i] = tid
            part_num[i] = p.partition
            counts[i] = len(p.replicas)
            flat[i] = p.replicas
            # leader position within the replica list (0 when leaderless)
            part_leader_pos[i] = (
                p.replicas.index(p.leader) if p.leader in p.replicas else 0
            )
        replica_broker = np.fromiter(
            (b for r in flat for b in r), np.int32, count=int(counts.sum())
        )
        offsets = np.zeros(P + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        cols = TopologyColumns(
            topic_names=tuple(topic_ids),
            part_topic=part_topic,
            part_num=part_num,
            part_leader_pos=part_leader_pos,
            replica_counts=counts,
            replica_offsets=offsets,
            replica_broker=replica_broker,
        )
        object.__setattr__(self, "_columns_cache", cols)
        return cols


@dataclasses.dataclass(frozen=True)
class TopologyColumns:
    """Array-encoded ClusterTopology.partitions (see ClusterTopology.columns).

    Topic ids are FIRST-SEEN order — the same assignment rule the samplers
    use for PartitionEntity, so entity keys line up without a rename pass.
    """

    topic_names: tuple[str, ...]
    part_topic: np.ndarray  # int32 [P] first-seen topic id
    part_num: np.ndarray  # int32 [P]
    part_leader_pos: np.ndarray  # int32 [P] leader index into the replica list
    replica_counts: np.ndarray  # int32 [P]
    replica_offsets: np.ndarray  # int64 [P+1] segment starts into replica_broker
    replica_broker: np.ndarray  # int32 [sum(counts)] flattened replica lists


class MetadataProvider(Protocol):
    """Reference common/MetadataClient.java role."""

    def topology(self) -> ClusterTopology:
        ...

    def refresh(self) -> ClusterTopology:
        ...


class StaticMetadataProvider:
    """Fixed topology (tests, simulations); mutate via set_topology."""

    def __init__(self, topology: ClusterTopology):
        self._topology = topology

    def topology(self) -> ClusterTopology:
        return self._topology

    def refresh(self) -> ClusterTopology:
        return self._topology

    def set_topology(self, topology: ClusterTopology):
        self._topology = dataclasses.replace(
            topology, generation=self._topology.generation + 1
        )
