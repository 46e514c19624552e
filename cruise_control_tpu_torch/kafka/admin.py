"""ClusterAdmin / MetadataProvider adapters over the wire-protocol client.

KafkaClusterAdmin implements the exact SPI the executor drives
(executor/admin.py ClusterAdmin) against a live cluster:

  reassign_partitions        -> AlterPartitionReassignments (KIP-455; replaces
                                the reference's ZK znode writes,
                                ExecutorUtils.scala:31)
  in_progress_reassignments  -> ListPartitionReassignments
                                (ExecutorUtils.scala:103)
  cancel_reassignments       -> AlterPartitionReassignments with null targets
                                (replaces ZK node deletion, Executor.java:1145)
  elect_leaders              -> ElectLeaders PREFERRED (ExecutorUtils.scala:95)
  alter_replica_logdirs      -> AlterReplicaLogDirs per broker
                                (ExecutorAdminUtils.java:1, KIP-113)
  set/clear throttle         -> IncrementalAlterConfigs broker + topic configs
                                (ReplicationThrottleHelper.java:32-47)
  topology                   -> Metadata (+ DescribeLogDirs for logdir axes)

Disk indices: the framework models JBOD logdirs as dense per-broker disk
indices; the adapter maps index <-> path by sorting each broker's logdir
paths (stable across calls because brokers report a fixed logdir set).
"""

from __future__ import annotations

from cruise_control_tpu_torch.executor.admin import LeadershipSpec, ReassignmentSpec
from cruise_control_tpu_torch.kafka.client import KafkaAdminClient, KafkaProtocolError
from cruise_control_tpu_torch.monitor.topology import (
    BrokerNode,
    ClusterTopology,
    PartitionInfo,
)

_BROKER = 4  # config resource types (public protocol spec)
_TOPIC = 2
_SET = 0
_DELETE = 1

_THROTTLE_RATE_CONFIGS = (
    "leader.replication.throttled.rate",
    "follower.replication.throttled.rate",
)
_THROTTLE_REPLICA_CONFIGS = (
    "leader.replication.throttled.replicas",
    "follower.replication.throttled.replicas",
)


class KafkaClusterAdmin:
    """Real-cluster ClusterAdmin over the Kafka wire protocol."""

    def __init__(self, client: KafkaAdminClient):
        self.client = client
        self._throttled_brokers: set[int] = set()
        self._throttled_topics: set[str] = set()
        #: brokers with possibly in-flight AlterReplicaLogDirs copies —
        #: bounds the DescribeLogDirs polling set
        self._logdir_move_brokers: set[int] = set()
        #: last successfully observed future-replica set per broker — a
        #: transient DescribeLogDirs failure must NOT look like "no copies
        #: pending" (the executor treats absence as completion)
        self._last_futures: dict[int, set[tuple[str, int, int]]] = {}
        #: consecutive DescribeLogDirs failures per broker; past the cap the
        #: broker is only PROBED every _probe_every polls (bounded timeout
        #: cost, but a recovered broker is re-observed — its landed copies
        #: must not be reported dead)
        self._describe_failures: dict[int, int] = {}
        self._max_describe_failures = 5
        self._probe_every = 5
        self._probe_countdown: dict[int, int] = {}
        #: brokers described successfully in the CURRENT poll round — a
        #: cache miss for these means "replica not present anywhere", no
        #: redial needed
        self._described_ok: set[int] = set()
        #: replica -> dense dir index placement from the poll's describes,
        #: so landed-verification is cache-served instead of one RPC per
        #: verified partition
        self._last_placement: dict[tuple[str, int, int], int] = {}

    # --- ClusterAdmin SPI ---

    def reassign_partitions(self, specs: list[ReassignmentSpec]) -> None:
        results = self.client.alter_partition_reassignments({
            (s.topic, s.partition): list(s.new_replicas) for s in specs
        })
        errors = [(t, p, c) for t, p, c, _ in results if c != 0]
        if errors:
            raise KafkaProtocolError(
                "AlterPartitionReassignments", errors[0][2],
                f"{len(errors)} partitions rejected, first: {errors[0][:2]}",
            )

    def in_progress_reassignments(self) -> set[tuple[str, int]]:
        return self.client.list_partition_reassignments()

    def cancel_reassignments(self) -> None:
        in_progress = self.client.list_partition_reassignments()
        if in_progress:
            self.client.alter_partition_reassignments(
                {key: None for key in in_progress}
            )

    def cancel_partition_reassignments(self, keys) -> None:
        """Cancel INDIVIDUAL reassignments (KIP-455 null-replicas form):
        each partition rolls back to its original replica set — the
        stuck-move reaper's rollback path.  A move that completed between
        observation and cancellation (NO_REASSIGNMENT_IN_PROGRESS) is not
        an error: there is nothing left to cancel."""
        self.client.alter_partition_reassignments(
            {(k[0], k[1]): None for k in keys}
        )

    def elect_leaders(self, specs: list[LeadershipSpec]) -> None:
        """Realize leadership moves: make the target the PREFERRED (first)
        replica, then run a preferred election (ExecutorUtils.scala:95).

        A PREFERRED election elects the broker-side replica list's head — so
        when the target is not already first, the assignment must be
        reordered via AlterPartitionReassignments first.  A same-set reorder
        moves no data (every replica is already in ISR) and completes
        immediately on the broker.
        """
        md = self.client.metadata(sorted({s.topic for s in specs}))
        current: dict[tuple[str, int], list[int]] = {
            (t["name"], p["partition_index"]): list(p["replica_nodes"])
            for t in md["topics"]
            for p in t["partitions"]
        }
        reorders: dict[tuple[str, int], list[int]] = {}
        for s in specs:
            key = (s.topic, s.partition)
            replicas = current.get(key)
            if replicas is None or s.preferred_leader not in replicas:
                raise KafkaProtocolError(
                    "ElectLeaders", 3,
                    f"{key}: target {s.preferred_leader} not in assignment {replicas}",
                )
            if replicas[0] != s.preferred_leader:
                reorders[key] = [s.preferred_leader] + [
                    b for b in replicas if b != s.preferred_leader
                ]
        if reorders:
            results = self.client.alter_partition_reassignments(reorders)
            bad = [(t, p, c) for t, p, c, _ in results if c != 0]
            if bad:
                raise KafkaProtocolError(
                    "ElectLeaders", bad[0][2],
                    f"preferred-replica reorder rejected, first: {bad[0][:2]}",
                )
        results = self.client.elect_preferred_leaders(
            [(s.topic, s.partition) for s in specs]
        )
        # 84 = ELECTION_NOT_NEEDED (preferred replica already leads) is success
        errors = [(t, p, c) for t, p, c in results if c not in (0, 84)]
        if errors:
            raise KafkaProtocolError(
                "ElectLeaders", errors[0][2],
                f"{len(errors)} elections failed, first: {errors[0][:2]}",
            )

    def alter_replica_logdirs(self, moves: list[tuple[str, int, int, int]]) -> None:
        """(topic, partition, broker, target_disk_index) intra-broker moves."""
        by_broker: dict[int, dict[str, list[tuple[str, int]]]] = {}
        paths_cache: dict[int, list[str]] = {}
        for topic, part, broker, disk_idx in moves:
            paths = paths_cache.get(broker)
            if paths is None:
                paths = paths_cache[broker] = self._logdir_paths(broker)
            if disk_idx >= len(paths):
                raise ValueError(
                    f"broker {broker} has {len(paths)} logdirs, wanted index {disk_idx}"
                )
            by_broker.setdefault(broker, {}).setdefault(paths[disk_idx], []).append(
                (topic, part)
            )
        for broker, dir_moves in sorted(by_broker.items()):
            results = self.client.alter_replica_logdirs(broker, dir_moves)
            errors = [r for r in results if r[2] != 0]
            if errors:
                raise KafkaProtocolError(
                    "AlterReplicaLogDirs", errors[0][2],
                    f"{len(errors)} moves rejected on broker {broker}",
                )
            self._logdir_move_brokers.add(broker)
            # the submitted copies ARE pending until a describe says
            # otherwise: seed the last-known set so a transient describe
            # failure right after submit cannot read as "nothing pending",
            # drop any stale placement for the moved replicas, and give the
            # broker a fresh failure budget
            keys = {
                (t, p, broker) for tps in dir_moves.values() for (t, p) in tps
            }
            self._last_futures.setdefault(broker, set()).update(keys)
            for key in keys:
                self._last_placement.pop(key, None)
            self._describe_failures.pop(broker, None)

    def in_progress_logdir_moves(self) -> set[tuple[str, int, int]]:
        """(topic, partition, broker) triples whose intra-broker copy is
        still in flight — DescribeLogDirs reports the copying replica under
        the target dir with is_future_key=true (reference ExecutorAdminUtils
        polls log dirs to track AlterReplicaLogDirs completion)."""
        out: set[tuple[str, int, int]] = set()
        # placement cache + described-ok set are scoped to ONE poll round:
        # verification reads what this round's describes observed, never an
        # older execution's stale placements (and both stay bounded)
        self._last_placement.clear()
        self._described_ok.clear()
        for broker in sorted(self._logdir_move_brokers):
            failures = self._describe_failures.get(broker, 0)
            if failures > self._max_describe_failures:
                # past the cap, back off to probing every Nth poll — a
                # permanently-skipped broker could never recover, and a
                # recovered broker's landed copies must not be killed as
                # unverifiable (rolling restarts bounce brokers routinely)
                self._probe_countdown[broker] = (
                    self._probe_countdown.get(broker, 0) - 1
                )
                if self._probe_countdown[broker] > 0:
                    out |= self._last_futures.get(broker, set())
                    continue
                self._probe_countdown[broker] = self._probe_every
            try:
                dirs = self.client.describe_logdirs(broker)
            except (OSError, ConnectionError):
                self._describe_failures[broker] = failures + 1
                if failures + 1 > self._max_describe_failures:
                    # arm the probe backoff the moment the cap is crossed
                    self._probe_countdown[broker] = self._probe_every
                # transient (or probed-and-still-down): report the LAST
                # KNOWN pending copies as still pending — absence here
                # means completion to the executor, and a socket timeout
                # is not completion
                out |= self._last_futures.get(broker, set())
                continue
            self._describe_failures.pop(broker, None)
            self._probe_countdown.pop(broker, None)
            self._described_ok.add(broker)
            futures = set()
            for i, path in enumerate(sorted(dirs)):
                info = dirs[path]
                for t, p in info.get("future_replicas", ()):
                    futures.add((t, p, broker))
                for (t, p) in info.get("replicas", {}):
                    self._last_placement[(t, p, broker)] = i
            self._last_futures[broker] = futures
            out |= futures
            if not futures:
                self._logdir_move_brokers.discard(broker)
                self._last_futures.pop(broker, None)
        return out

    def logdir_of(self, topic: str, partition: int, broker: int) -> int | None:
        """Dense disk index currently hosting (topic, partition) on broker,
        or None if unknown — the executor verifies a finished
        AlterReplicaLogDirs actually LANDED on the target dir.

        Served from the placement observed by the poll's own describes when
        possible (a batch of completions would otherwise cost one full
        DescribeLogDirs round trip per verified partition)."""
        cached = self._last_placement.get((topic, partition, broker))
        if cached is not None:
            return cached
        if broker in self._described_ok:
            # this poll round ALREADY described the broker successfully and
            # the replica was in no dir (e.g. mid log recovery) — redialing
            # would return the same answer for another round trip
            return None
        if self._describe_failures.get(broker, 0) > self._max_describe_failures:
            # backed off (persistently unreachable): answering "unknown"
            # immediately avoids one socket timeout per verification; the
            # poll loop's periodic probe discovers recovery
            return None
        try:
            dirs = self.client.describe_logdirs(broker)
        except (OSError, ConnectionError):
            self._describe_failures[broker] = (
                self._describe_failures.get(broker, 0) + 1
            )
            return None
        self._describe_failures.pop(broker, None)
        out = None
        for i, path in enumerate(sorted(dirs)):
            for (t, p) in dirs[path]["replicas"]:
                self._last_placement[(t, p, broker)] = i
                if (t, p) == (topic, partition):
                    out = i
        return out

    def set_replication_throttle(self, rate_bytes_per_s: float, topics: set[str]) -> None:
        """Reference ReplicationThrottleHelper.java:32-47: per-broker rates +
        per-topic throttled-replica wildcards around an execution."""
        md = self.client.metadata()
        brokers = sorted(b["node_id"] for b in md["brokers"])
        rate = str(int(rate_bytes_per_s))
        resources = [
            (_BROKER, str(b), [(c, _SET, rate) for c in _THROTTLE_RATE_CONFIGS])
            for b in brokers
        ] + [
            (_TOPIC, t, [(c, _SET, "*") for c in _THROTTLE_REPLICA_CONFIGS])
            for t in sorted(topics)
        ]
        self.client.incremental_alter_configs(resources)
        self._throttled_brokers = set(brokers)
        self._throttled_topics = set(topics)

    def clear_replication_throttle(self) -> None:
        """Remove throttles discovered from CLUSTER state, not just this
        process's memory — a crash between set and clear must not leave the
        cluster capped forever (reference ReplicationThrottleHelper removes
        what it finds in the configs)."""
        md = self.client.metadata()
        broker_ids = sorted(b["node_id"] for b in md["brokers"])
        topic_names = sorted(
            t["name"] for t in md["topics"] if t["error_code"] == 0
        )
        # broker-resource describes must be routed TO that broker (dynamic
        # per-broker configs, KIP-226); topic describes may go anywhere
        throttled_brokers = set(self._throttled_brokers)
        for b in broker_ids:
            cfg = self.client.describe_configs(
                [(_BROKER, str(b))],
                names=list(_THROTTLE_RATE_CONFIGS),
                node_id=b,
            ).get((_BROKER, str(b)), {})
            if any(c in cfg for c in _THROTTLE_RATE_CONFIGS):
                throttled_brokers.add(b)
        described = self.client.describe_configs(
            [(_TOPIC, t) for t in topic_names],
            names=list(_THROTTLE_REPLICA_CONFIGS),
        )
        # only clear topic throttles bearing OUR signature (the "*"
        # wildcard set_replication_throttle writes) — an operator's static
        # per-replica throttle list is not ours to delete (reference
        # ReplicationThrottleHelper removes what it set)
        throttled_topics = {
            name for (rt, name), cfg in described.items()
            if rt == _TOPIC
            and any(cfg.get(c) == "*" for c in _THROTTLE_REPLICA_CONFIGS)
        } | self._throttled_topics
        resources = [
            (_BROKER, str(b), [(c, _DELETE, None) for c in _THROTTLE_RATE_CONFIGS])
            for b in sorted(throttled_brokers)
        ] + [
            (_TOPIC, t, [(c, _DELETE, None) for c in _THROTTLE_REPLICA_CONFIGS])
            for t in sorted(throttled_topics)
        ]
        if resources:
            self.client.incremental_alter_configs(resources)
        self._throttled_brokers = set()
        self._throttled_topics = set()

    def topology(self) -> ClusterTopology:
        return _topology_from_metadata(self.client, with_logdirs=True)

    # --- helpers ---

    def _logdir_paths(self, broker: int) -> list[str]:
        """Dense disk index -> logdir path (sorted for stability)."""
        return sorted(self.client.describe_logdirs(broker))


class KafkaMetadataProvider:
    """MetadataProvider over the wire protocol (reference MetadataClient)."""

    def __init__(self, client: KafkaAdminClient):
        self.client = client
        self._generation = 0
        self._topology: ClusterTopology | None = None

    def topology(self) -> ClusterTopology:
        if self._topology is None:
            return self.refresh()
        return self._topology

    def refresh(self) -> ClusterTopology:
        self._generation += 1
        topo = _topology_from_metadata(self.client, with_logdirs=False)
        self._topology = ClusterTopology(
            brokers=topo.brokers, partitions=topo.partitions,
            generation=self._generation,
        )
        return self._topology


def _topology_from_metadata(
    client: KafkaAdminClient, *, with_logdirs: bool
) -> ClusterTopology:
    md = client.metadata()
    brokers = []
    live_ids = set()
    for b in md["brokers"]:
        live_ids.add(b["node_id"])
        logdirs: tuple[str, ...] = ()
        offline: tuple[str, ...] = ()
        if with_logdirs:
            try:
                dirs = client.describe_logdirs(b["node_id"])
                logdirs = tuple(sorted(dirs))
                offline = tuple(
                    sorted(d for d, info in dirs.items() if info["error_code"] != 0)
                )
            except (OSError, ConnectionError):
                pass
        brokers.append(
            BrokerNode(
                broker_id=b["node_id"],
                rack=b["rack"] or "",
                host=b["host"],
                alive=True,
                logdirs=logdirs,
                offline_logdirs=offline,
            )
        )
    # brokers hosting replicas but absent from metadata = failed brokers:
    # surface them as dead BrokerNodes (the BrokerFailureDetector's signal —
    # replaces the reference's ZK /brokers/ids watch,
    # detector/BrokerFailureDetector.java:88)
    partitions = []
    referenced: set[int] = set()
    for t in md["topics"]:
        if t["error_code"] != 0 or t["is_internal"]:
            continue
        for p in t["partitions"]:
            replicas = tuple(p["replica_nodes"])
            referenced.update(replicas)
            partitions.append(
                PartitionInfo(
                    topic=t["name"],
                    partition=p["partition_index"],
                    leader=p["leader_id"],
                    replicas=replicas,
                )
            )
    for dead in sorted(referenced - live_ids):
        brokers.append(BrokerNode(broker_id=dead, rack="", host="", alive=False))
    brokers.sort(key=lambda b: b.broker_id)
    return ClusterTopology(brokers=tuple(brokers), partitions=tuple(partitions))
