"""Cluster administration SPI + simulated backend.

Reference boundary: the Scala ZK bridge (ExecutorUtils.scala:31
executeReplicaReassignmentTasks / :95 executePreferredLeaderElection /
:103 partitionsBeingReassigned) + executor/ExecutorAdminUtils.java
(alterReplicaLogDirs, describe logdirs).  Modern Kafka does reassignment
through the AdminClient API, so the SPI is shaped like that — a real
implementation wraps an AdminClient; the simulated one mutates a
StaticMetadataProvider topology with throttle-limited progress, playing
the role of the reference's embedded-cluster test harness
(CCKafkaIntegrationTestHarness).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

from cruise_control_tpu_torch.monitor.topology import (
    ClusterTopology,
    PartitionInfo,
    StaticMetadataProvider,
)


@dataclasses.dataclass(frozen=True)
class ReassignmentSpec:
    topic: str
    partition: int
    new_replicas: tuple[int, ...]  # target replica list, leader candidate first
    data_to_move: float = 0.0


@dataclasses.dataclass(frozen=True)
class LeadershipSpec:
    topic: str
    partition: int
    preferred_leader: int


class ClusterAdmin(Protocol):
    """What the executor needs from the cluster."""

    def reassign_partitions(self, specs: list[ReassignmentSpec]) -> None:
        ...

    def in_progress_reassignments(self) -> set[tuple[str, int]]:
        ...

    def cancel_reassignments(self) -> None:
        ...

    def elect_leaders(self, specs: list[LeadershipSpec]) -> None:
        ...

    def alter_replica_logdirs(self, moves: list[tuple[str, int, int, int]]) -> None:
        """(topic, partition, broker, target_disk) intra-broker moves."""
        ...

    def in_progress_logdir_moves(self) -> set[tuple[str, int, int]]:
        """(topic, partition, broker) intra-broker copies still in flight
        (reference ExecutorAdminUtils DescribeLogDirs future replicas)."""
        ...

    def set_replication_throttle(self, rate_bytes_per_s: float, topics: set[str]) -> None:
        ...

    def clear_replication_throttle(self) -> None:
        ...

    def topology(self) -> ClusterTopology:
        ...

    # Optional capabilities the executor probes with hasattr():
    #
    #   reassignment_remaining_bytes() -> dict[(topic, part), float]
    #       per-reassignment bytes still to copy — feeds the stuck-move
    #       reaper's progress watermark (a KIP-455 admin derives this from
    #       replica log-end offsets vs the leader)
    #   cancel_partition_reassignments(keys: list[(topic, part)]) -> None
    #       cancel INDIVIDUAL reassignments, rolling each partition back to
    #       its original replica set (KIP-455 supports per-partition
    #       cancellation; cancel_reassignments above nukes everything)


#: ClusterAdmin methods that MUTATE the cluster — the full fencing
#: surface (fleet HA): a deposed lease holder must not be able to touch
#: the cluster through any of these
_MUTATING_ADMIN_OPS = frozenset({
    "reassign_partitions",
    "cancel_reassignments",
    "cancel_partition_reassignments",
    "elect_leaders",
    "alter_replica_logdirs",
    "set_replication_throttle",
    "clear_replication_throttle",
})


class FencedClusterAdmin:
    """ClusterAdmin decorator stamping the lease fence onto every cluster
    MUTATION (fleet/leases.py): each call in `_MUTATING_ADMIN_OPS` first
    runs `fence.check()` — a stale/absent lease epoch raises `FencedError`
    before anything reaches the cluster, so a zombie instance whose lease
    was taken over can neither submit, cancel, elect, move logdirs nor
    touch throttles.  Reads (topology, in-progress listings, watermarks)
    pass through unfenced — the degraded read-only mode keeps serving
    them — and optional capabilities (`tick`, `reassignment_remaining_
    bytes`, `logdir_of`, ...) delegate transparently so `hasattr` probes
    see exactly the wrapped admin's surface."""

    def __init__(self, admin: "ClusterAdmin", fence):
        self._admin = admin
        self._fence = fence

    def __getattr__(self, name: str):
        attr = getattr(self._admin, name)
        if name in _MUTATING_ADMIN_OPS and callable(attr):
            fence = self._fence

            def fenced(*args, __attr=attr, __name=name, **kwargs):
                fence.check(op=f"admin.{__name}")
                return __attr(*args, **kwargs)

            return fenced
        return attr


@dataclasses.dataclass
class _Inflight:
    spec: ReassignmentSpec
    remaining_bytes: float


class SimulatedClusterAdmin:
    """Deterministic simulated cluster: reassignments progress by
    `tick(seconds)` at min(throttle, link_rate) per partition."""

    def __init__(
        self,
        metadata: StaticMetadataProvider,
        *,
        link_rate_bytes_per_s: float = 50_000.0,
        fail_partitions: set[tuple[str, int]] | None = None,
        drop_partitions: set[tuple[str, int]] | None = None,
        intra_move_bytes: float = 0.0,
    ):
        self.metadata = metadata
        self.link_rate = link_rate_bytes_per_s
        #: bytes each simulated intra-broker (logdir) copy takes; 0 means
        #: moves land instantly
        self.intra_move_bytes = intra_move_bytes
        self._intra_inflight: dict[tuple[str, int, int], float] = {}
        self.throttle_rate: float | None = None
        self.throttled_topics: set[str] = set()
        self._inflight: dict[tuple[str, int], _Inflight] = {}
        self._fail = fail_partitions or set()
        #: reassignments the "controller" silently forgets ONCE: on the next
        #: tick the entry vanishes from in-progress without being applied
        #: (models the dropped reassignments reference
        #: Executor.maybeReexecuteTasks:1430 exists to catch); a re-submitted
        #: reassignment for the same partition then proceeds normally
        self._drop_once = set(drop_partitions or set())
        self.dropped_reassignments: list[tuple[str, int]] = []
        self.reassign_calls = 0
        self.election_calls = 0
        #: (topic, partition) -> row of the topology's partition tuple, and
        #: the tuple it indexes: tick() keeps both across its own applies
        #: (which keep every key at its row) and rebuilds them only when
        #: the topology's tuple is another one
        self._index: dict[tuple[str, int], int] = {}
        self._index_of: tuple[PartitionInfo, ...] | None = None

    # --- ClusterAdmin SPI ---

    def reassign_partitions(self, specs: list[ReassignmentSpec]) -> None:
        self.reassign_calls += 1
        for s in specs:
            key = (s.topic, s.partition)
            if key in self._inflight:
                raise ValueError(f"reassignment already in progress for {key}")
            self._inflight[key] = _Inflight(s, max(s.data_to_move, 0.0))

    def in_progress_reassignments(self) -> set[tuple[str, int]]:
        return set(self._inflight)

    def cancel_reassignments(self) -> None:
        # reference force-stop deletes the ZK node (Executor.java:1145)
        self._inflight.clear()

    def cancel_partition_reassignments(self, keys) -> None:
        """Per-partition cancellation (KIP-455): the move is dropped and
        the partition keeps its ORIGINAL replica set (the simulated
        topology was never touched mid-flight, so dropping the in-flight
        entry IS the rollback)."""
        for key in keys:
            self._inflight.pop(tuple(key), None)

    def reassignment_remaining_bytes(self) -> dict[tuple[str, int], float]:
        """Bytes still to copy per in-flight reassignment — the reaper's
        progress watermark source."""
        return {k: fl.remaining_bytes for k, fl in self._inflight.items()}

    def stall(self, *keys: tuple[str, int]) -> None:
        """Freeze the given reassignments: they stay in-progress but stop
        making byte progress (a wedged follower / saturated link)."""
        self._fail.update(keys)

    def unstall(self, *keys: tuple[str, int]) -> None:
        for key in keys:
            self._fail.discard(key)

    def elect_leaders(self, specs: list[LeadershipSpec]) -> None:
        self.election_calls += 1
        topo = self.metadata.topology()
        index = self._partition_index()
        parts = list(topo.partitions)
        for s in specs:
            i = index[(s.topic, s.partition)]
            p = parts[i]
            if s.preferred_leader in p.replicas:
                parts[i] = dataclasses.replace(p, leader=s.preferred_leader)
        self._set_partitions(topo, tuple(parts), 1)

    def alter_replica_logdirs(self, moves) -> None:
        # logdir placement is not modeled in the simulated topology, but
        # move DURATION is: each (t, p, broker) copy drains intra_move_bytes
        # at the link rate via tick() (0 bytes -> instant, the default)
        for topic, part, broker, _disk in moves:
            if self.intra_move_bytes > 0:
                self._intra_inflight[(topic, part, broker)] = self.intra_move_bytes

    def in_progress_logdir_moves(self) -> set[tuple[str, int, int]]:
        return set(self._intra_inflight)

    def set_replication_throttle(self, rate: float, topics: set[str]) -> None:
        self.throttle_rate = rate
        self.throttled_topics = set(topics)

    def clear_replication_throttle(self) -> None:
        self.throttle_rate = None
        self.throttled_topics = set()

    def topology(self) -> ClusterTopology:
        return self.metadata.topology()

    # --- simulation ---

    def tick(self, seconds: float) -> list[tuple[str, int]]:
        """Advance time; returns reassignments that completed this tick.

        Every reassignment that completes in the tick lands in ONE rebuild
        of the partition tuple, in `_inflight` order, instead of one
        rebuild (and one index of all partitions) per completion.  The
        result is the per-completion one exactly: nothing reads the
        topology between two applies of one tick, a partition has at most
        one reassignment in flight (so no apply sees another's row), and
        each apply replaces its row with the leader rule below on the
        row's state before the tick.  `set_topology` is called once per
        completed reassignment, as before, so the provider's generation
        grows by the same count every tick; an unknown partition raises
        the KeyError the per-completion apply raised, at the same point,
        after the earlier completions landed."""
        rate = self.link_rate
        if self.throttle_rate is not None:
            rate = min(rate, self.throttle_rate)
        done = []
        landed: list[tuple[int, ReassignmentSpec]] = []
        try:
            for key, fl in list(self._inflight.items()):
                if key in self._drop_once:
                    self._drop_once.discard(key)
                    self.dropped_reassignments.append(key)
                    del self._inflight[key]  # vanishes, topology unchanged
                    continue
                if key in self._fail:
                    continue  # stuck forever (tests exercise DEAD handling)
                fl.remaining_bytes -= rate * seconds
                if fl.remaining_bytes <= 0:
                    spec = fl.spec
                    landed.append((self._partition_index()[(spec.topic, spec.partition)], spec))
                    del self._inflight[key]
                    done.append(key)
        finally:
            if landed:
                self._apply(landed)
        for key3 in list(self._intra_inflight):
            self._intra_inflight[key3] -= rate * seconds
            if self._intra_inflight[key3] <= 0:
                del self._intra_inflight[key3]
        return done

    def _partition_index(self) -> dict[tuple[str, int], int]:
        parts = self.metadata.topology().partitions
        if self._index_of is not parts:
            self._index = {(p.topic, p.partition): i for i, p in enumerate(parts)}
            self._index_of = parts
        return self._index

    def _apply(self, landed: list[tuple[int, ReassignmentSpec]]):
        """Land completed reassignments, given as (row, spec) in
        completion order, with one rebuild of the partition tuple and one
        `set_topology` call per reassignment."""
        topo = self.metadata.topology()
        parts = list(topo.partitions)
        for i, spec in landed:
            p = parts[i]
            leader = p.leader if p.leader in spec.new_replicas else spec.new_replicas[0]
            parts[i] = PartitionInfo(
                topic=p.topic,
                partition=p.partition,
                leader=leader,
                replicas=tuple(spec.new_replicas),
            )
        self._set_partitions(topo, tuple(parts), len(landed))

    def _set_partitions(self, topo: ClusterTopology, rebuilt: tuple[PartitionInfo, ...], calls: int):
        """Set the topology with `rebuilt` as its partitions through `calls`
        set_topology calls: the later calls re-set the same partitions, so
        the provider's generation counts one call per landed reassignment,
        as it did when each landed on its own.  The partition index carries
        over: every row keeps its key."""
        self.metadata.set_topology(dataclasses.replace(topo, partitions=rebuilt))
        for _ in range(calls - 1):
            self.metadata.set_topology(self.metadata.topology())
        if self.metadata.topology().partitions is rebuilt and self._index_of is topo.partitions:
            self._index_of = rebuilt
