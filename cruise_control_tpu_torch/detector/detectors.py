"""The five scheduled anomaly detectors.

Reference: detector/GoalViolationDetector.java:48 (per-goal optimize on a
fresh model), BrokerFailureDetector.java:44 (ZK liveness watch + persisted
failure times), DiskFailureDetector.java (logdir describe),
MetricAnomalyDetector.java + SlowBrokerFinder.java:99,255-267 (percentile
history + peer comparison), TopicAnomalyDetector +
TopicReplicationFactorAnomalyFinder / PartitionSizeAnomalyFinder.

The goal-violation check: where the reference re-runs the greedy
optimizer per detection goal, here one batched chain.evaluate() on the
array model, on the device that holds it, prices every goal at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.objective import GoalChain
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.config.balancing import BalancingConstraint, DEFAULT_CONSTRAINT
from cruise_control_tpu_torch.detector.anomalies import (
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    SlowBrokers,
    TopicPartitionSizeAnomaly,
    TopicReplicationFactorAnomaly,
)
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.monitor.topology import ClusterTopology


class GoalViolationDetector:
    """Reference detector/GoalViolationDetector.java:48,106.

    Uses a slacker constraint than optimization (threshold multiplier,
    reference AnalyzerConfig goal.violation.distribution.threshold.multiplier)
    so detection does not flap on clusters optimization considers balanced.
    """

    def __init__(
        self,
        model_provider: Callable[[], ClusterState],
        chain: GoalChain,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        *,
        violation_tolerance: float = 1e-6,
    ):
        self.model_provider = model_provider
        self.chain = chain
        mult = constraint.goal_violation_distribution_threshold_multiplier
        if mult != 1.0:
            constraint = dataclasses.replace(
                constraint,
                balance_threshold=tuple(
                    1.0 + (t - 1.0) * mult for t in constraint.balance_threshold
                ),
                replica_count_balance_threshold=1.0
                + (constraint.replica_count_balance_threshold - 1.0) * mult,
                leader_replica_count_balance_threshold=1.0
                + (constraint.leader_replica_count_balance_threshold - 1.0) * mult,
                topic_replica_count_balance_threshold=1.0
                + (constraint.topic_replica_count_balance_threshold - 1.0) * mult,
            )
        self.constraint = constraint
        self.tol = violation_tolerance
        #: the chain's weights staged on each device a model came on
        self._weights: dict[torch.device, torch.Tensor] = {}

    def _chain_weights(self, device: torch.device) -> torch.Tensor:
        w = self._weights.get(device)
        if w is None:
            w = torch.tensor(self.chain.weights, dtype=torch.float32)
            if device.type == "cuda":
                # from pinned memory without a sync: the evaluation runs
                # after the copy on the device's stream
                w = w.pin_memory().to(device, non_blocking=True)
            self._weights[device] = w
        return w

    def detect(self) -> GoalViolations | None:
        """The chain evaluates on the device that holds the model; the
        violations, the alive brokers' disk capacity and the total leader
        disk load come to the host in one transfer, the detection's one
        sync.  The two sums accumulate in f64."""
        state = self.model_provider()
        _, violations, _ = self.chain.evaluate(
            state, constraint=self.constraint, weights=self._chain_weights(state.device))
        disk = int(Resource.DISK)
        usable = state.broker_alive & state.broker_valid
        alive_disk = torch.where(usable, state.broker_capacity[:, disk], 0.0).double().sum()
        total_disk = state.replica_load_leader[:, disk].double().sum()
        host = torch.cat([violations.double(), alive_disk[None], total_disk[None]]).cpu().numpy()
        violations, alive_disk, total_load = host[:-2], float(host[-2]), float(host[-1])
        names = self.chain.names()
        hard = self.chain.hard_mask()
        fixable, unfixable = [], []
        for i, name in enumerate(names):
            if violations[i] <= self.tol:
                continue
            # a capacity goal whose total demand exceeds capacity is unfixable
            # by moves (reference marks unfixable via optimization failure)
            if hard[i] and name == "DiskCapacityGoal" and total_load > alive_disk:
                unfixable.append(name)
            else:
                fixable.append(name)
        if not fixable and not unfixable:
            return None
        return GoalViolations(
            fixable_violations=fixable, unfixable_violations=unfixable
        )


class BrokerFailureDetector:
    """Reference detector/BrokerFailureDetector.java:44 — watches broker
    liveness and persists first-failure times so restarts don't reset the
    self-healing clock (reference persists to a ZK node :123-127; here a
    JSON file)."""

    def __init__(
        self,
        topology_provider: Callable[[], ClusterTopology],
        *,
        persist_path: str | None = None,
        now_ms: Callable[[], int] | None = None,
    ):
        self.topology_provider = topology_provider
        self.persist_path = persist_path
        self._now = now_ms or (lambda: int(time.time() * 1000))
        self._failure_times: dict[int, int] = {}
        self._load()

    def _load(self):
        if self.persist_path and os.path.exists(self.persist_path):
            with open(self.persist_path) as f:
                self._failure_times = {int(k): int(v) for k, v in json.load(f).items()}

    def _persist(self):
        if self.persist_path:
            with open(self.persist_path, "w") as f:
                json.dump(self._failure_times, f)

    def detect(self) -> BrokerFailures | None:
        topo = self.topology_provider()
        dead = {b.broker_id for b in topo.brokers if not b.alive}
        now = self._now()
        changed = False
        for b in dead:
            if b not in self._failure_times:
                self._failure_times[b] = now
                changed = True
        for b in list(self._failure_times):
            if b not in dead:  # broker came back
                del self._failure_times[b]
                changed = True
        if changed:
            self._persist()
        if not self._failure_times:
            return None
        return BrokerFailures(failed_brokers=dict(self._failure_times))


class DiskFailureDetector:
    """Reference detector/DiskFailureDetector.java — offline logdirs."""

    def __init__(self, topology_provider: Callable[[], ClusterTopology]):
        self.topology_provider = topology_provider

    def detect(self) -> DiskFailures | None:
        topo = self.topology_provider()
        failed = {
            b.broker_id: list(b.offline_logdirs)
            for b in topo.brokers
            if b.alive and b.offline_logdirs
        }
        if not failed:
            return None
        return DiskFailures(failed_disks=failed)


class SlowBrokerFinder:
    """Reference detector/SlowBrokerFinder.java:99,255-267.

    Multi-family evidence: each broker reports SEVERAL latency-ish metric
    families (byte-rate-normalized log-flush time, request-latency means,
    queue sizes — reference collectSlowBrokerMetrics uses byte rates AND
    request latencies).  A family votes "slow" when the broker is
    simultaneously high versus its own history (percentile) and versus
    current peers (ratio to the peer median); a broker is flagged only when
    a MAJORITY of its evaluated families agree — one noisy metric spiking
    cannot false-positive a broker.  Persistent slowness escalates from
    demote to remove.
    """

    def __init__(
        self,
        *,
        history_percentile: float = 90.0,
        peer_ratio: float = 3.0,
        history_windows: int = 20,
        #: consecutive detections before escalating to removal
        removal_threshold: int = 3,
    ):
        self.history_percentile = history_percentile
        self.peer_ratio = peer_ratio
        self.history_windows = history_windows
        self.removal_threshold = removal_threshold
        self._history: dict[tuple[int, str], list[float]] = {}
        self._strikes: dict[int, int] = {}

    def _family_votes(self, family: str, values: dict[int, float]) -> dict[int, float]:
        """-> broker -> peer-ratio for brokers this family votes slow."""
        peer_median = float(np.median(np.asarray(list(values.values()))))
        votes: dict[int, float] = {}
        for b, v in values.items():
            hist = self._history.setdefault((b, family), [])
            slow_vs_peers = peer_median > 0 and v > self.peer_ratio * peer_median
            slow_vs_history = (
                len(hist) >= 3 and v > float(np.percentile(hist, self.history_percentile))
            )
            if slow_vs_peers and (slow_vs_history or len(hist) < 3):
                votes[b] = v / max(peer_median, 1e-9)
                # anomalous samples stay out of the clean history so a
                # persistently slow broker keeps comparing against its
                # healthy baseline (reference keeps separate normal-state
                # history, SlowBrokerFinder.java:255-267)
            else:
                hist.append(v)
                del hist[: -self.history_windows]
        return votes

    def detect(
        self, broker_metrics: dict[int, float] | dict[int, dict[str, float]]
    ) -> SlowBrokers | None:
        """broker_metrics: per alive broker, either one latency value
        (single-family compatibility) or {family: value} evidence."""
        if len(broker_metrics) < 2:
            return None
        sample = next(iter(broker_metrics.values()))
        if not isinstance(sample, dict):
            broker_metrics = {b: {"metric": v} for b, v in broker_metrics.items()}

        # evaluate each family across the brokers reporting it
        by_family: dict[str, dict[int, float]] = {}
        for b, fams in broker_metrics.items():
            for f, v in fams.items():
                by_family.setdefault(f, {})[b] = v
        votes: dict[int, list[float]] = {}
        evaluated: dict[int, int] = {}
        for f, values in by_family.items():
            # a family nobody reports a nonzero value for carries no signal
            # — counting it toward the evidence bar would let unpopulated
            # metric columns (a sampler that lacks the source) silently
            # raise the majority threshold past what real data can reach
            if len(values) < 2 or all(v == 0 for v in values.values()):
                continue
            for b in values:
                evaluated[b] = evaluated.get(b, 0) + 1
            for b, ratio in self._family_votes(f, values).items():
                votes.setdefault(b, []).append(ratio)

        slow: dict[int, float] = {}
        for b, ratios in votes.items():
            need = max(1, evaluated.get(b, 1) // 2 + 1)  # STRICT majority
            if len(ratios) >= need:
                slow[b] = float(np.mean(ratios))
                self._strikes[b] = self._strikes.get(b, 0) + 1
        for b in evaluated:
            if b not in slow:
                self._strikes.pop(b, None)
        if not slow:
            return None
        remove = any(self._strikes.get(b, 0) >= self.removal_threshold for b in slow)
        return SlowBrokers(slow_brokers=slow, remove_slow_brokers=remove)


class TopicReplicationFactorAnomalyFinder:
    """Reference detector/TopicReplicationFactorAnomalyFinder.java — topics
    whose partitions run below the target replication factor."""

    def __init__(
        self,
        topology_provider: Callable[[], ClusterTopology],
        target_rf: int = 2,
        topic_config_provider=None,
    ):
        """topic_config_provider (reference topic.config.provider.class):
        when present, a topic's effective floor is
        max(target_rf, min.insync.replicas + 1) — RF == minISR cannot
        survive a broker loss without dropping under min-ISR."""
        self.topology_provider = topology_provider
        self.target_rf = target_rf
        self.topic_config_provider = topic_config_provider

    def detect(self) -> TopicReplicationFactorAnomaly | None:
        from cruise_control_tpu_torch.monitor.topic_config import min_insync_replicas_map

        topo = self.topology_provider()
        topics = sorted({p.topic for p in topo.partitions})
        floors = {t: self.target_rf for t in topics}
        if self.topic_config_provider is not None:
            # one batch DescribeConfigs for ALL topics per detection tick
            for t, min_isr in min_insync_replicas_map(
                self.topic_config_provider, topics
            ).items():
                floors[t] = max(floors[t], min_isr + 1)
        bad: dict[str, int] = {}
        for p in topo.partitions:
            rf = len(p.replicas)
            if rf < floors[p.topic]:
                bad[p.topic] = min(bad.get(p.topic, rf), rf)
        if not bad:
            return None
        return TopicReplicationFactorAnomaly(bad_topics=bad, target_rf=self.target_rf)


class PartitionSizeAnomalyFinder:
    """Reference detector/PartitionSizeAnomalyFinder.java — partitions whose
    disk footprint exceeds a threshold."""

    def __init__(
        self,
        model_provider: Callable[[], ClusterState],
        catalog_provider: Callable[[], object],
        max_partition_size: float = 1e6,
        excluded_topics_pattern: str = "",
    ):
        """max_partition_size (reference
        self.healing.partition.size.threshold.byte, default 500MiB);
        excluded_topics_pattern (reference
        topic.excluded.from.partition.size.check)."""
        import re

        self.model_provider = model_provider
        self.catalog_provider = catalog_provider
        self.max_partition_size = max_partition_size
        self._excluded = (
            re.compile(excluded_topics_pattern) if excluded_topics_pattern else None
        )

    def detect(self) -> TopicPartitionSizeAnomaly | None:
        state = self.model_provider()
        catalog = self.catalog_provider()
        # the oversized leaders are picked where the model lives; only
        # their partitions and sizes come to the host
        lead = state.replica_is_leader & state.replica_valid
        sizes = state.replica_load_leader[:, int(Resource.DISK)]
        rows = torch.nonzero(lead & (sizes > self.max_partition_size))[:, 0]
        parts = state.replica_partition[rows].cpu().numpy()
        sizes = sizes[rows].cpu().numpy()
        oversized: dict[tuple[str, int], float] = {}
        for part, size in zip(parts.tolist(), sizes.tolist()):
            key = catalog.partition_key(part) if catalog else ("?", part)
            if self._excluded is not None and self._excluded.fullmatch(key[0]):
                continue
            oversized[key] = size
        if not oversized:
            return None
        return TopicPartitionSizeAnomaly(oversized=oversized)
