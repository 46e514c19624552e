"""Anomaly taxonomy: the JAX package's detector/anomalies.py, whole.

Reference: cruise-control-core detector/Anomaly.java + AnomalyType.java
(SPI) and the main-module payloads: detector/GoalViolations.java,
BrokerFailures.java, DiskFailures.java, SlowBrokers.java,
TopicReplicationFactorAnomaly.java, TopicPartitionSizeAnomaly.java.
The port's device scheduler (fleet/scheduler.py) raises `FleetOverload`
through its anomaly sink; the detectors that raise the others come with
the service.  Standard library only.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time


class AnomalyType(enum.Enum):
    """Reference KafkaAnomalyType; priority order matters — lower value is
    handled first (reference AnomalyDetector priority queue)."""

    BROKER_FAILURE = 0
    DISK_FAILURE = 1
    METRIC_ANOMALY = 2
    GOAL_VIOLATION = 3
    TOPIC_ANOMALY = 4
    #: the optimizer's device supervisor opened its circuit breaker —
    #: proposals are being served by the CPU greedy fallback (no reference
    #: analog: the reference has no accelerator to lose)
    OPTIMIZER_DEGRADED = 5
    #: the executor's stuck-move reaper cancelled a reassignment whose
    #: progress watermark stalled past executor.reaper.stuck.timeout.s
    EXECUTION_STUCK = 6
    #: this instance lost a cluster's ownership lease (fleet HA) — the
    #: cluster stepped down to read-only degraded mode while a peer
    #: instance takes over execution
    FLEET_LEASE_LOST = 7
    #: the device scheduler's overload protection engaged (fleet
    #: scheduler, fleet/scheduler.py): background cycles are being shed
    #: or browned out and interactive admissions may 429 — the shared
    #: device cannot keep up with the fleet's demand
    FLEET_OVERLOAD = 8
    #: an SLO's error budget is burning past its multi-window threshold
    #: (common/slo.py): proposal freshness, streaming publish latency,
    #: cold-start or urgent queue-wait is sustainedly out of objective
    SLO_BURN = 9
    #: the decision ledger's calibration loop (analyzer/ledger.py +
    #: service/facade.py) measured SUSTAINED prediction error: the goal
    #: scores/broker loads the engine predicted for executed proposals
    #: keep diverging from what the cluster actually measured afterwards
    MODEL_DRIFT = 10
    #: a mesh anneal lost a device (or a collective stalled on one) and
    #: the optimizer degraded to a narrower mesh width, resuming from the
    #: last carry checkpoint (parallel/ft.py) — capacity is reduced but
    #: proposals are still device-served
    MESH_DEGRADED = 11

    @property
    def priority(self) -> int:
        return self.value


_ids = itertools.count()


@dataclasses.dataclass
class Anomaly:
    anomaly_type: AnomalyType
    detected_ms: int = dataclasses.field(default_factory=lambda: int(time.time() * 1000))
    anomaly_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    #: whether the fix path is expected to change anything
    fixable: bool = True

    def description(self) -> str:
        return self.anomaly_type.name

    def __lt__(self, other: "Anomaly") -> bool:
        return (self.anomaly_type.priority, self.detected_ms) < (
            other.anomaly_type.priority,
            other.detected_ms,
        )


@dataclasses.dataclass
class GoalViolations(Anomaly):
    """Reference detector/GoalViolations.java — which goals are violated,
    split by whether optimization could fix them."""

    anomaly_type: AnomalyType = AnomalyType.GOAL_VIOLATION
    fixable_violations: list[str] = dataclasses.field(default_factory=list)
    unfixable_violations: list[str] = dataclasses.field(default_factory=list)

    def description(self) -> str:
        return (
            f"GoalViolations(fixable={self.fixable_violations}, "
            f"unfixable={self.unfixable_violations})"
        )


@dataclasses.dataclass
class BrokerFailures(Anomaly):
    """Reference detector/BrokerFailures.java."""

    anomaly_type: AnomalyType = AnomalyType.BROKER_FAILURE
    failed_brokers: dict[int, int] = dataclasses.field(default_factory=dict)  # id -> failed_ms

    def description(self) -> str:
        return f"BrokerFailures({sorted(self.failed_brokers)})"


@dataclasses.dataclass
class DiskFailures(Anomaly):
    """Reference detector/DiskFailures.java — (broker -> offline logdirs)."""

    anomaly_type: AnomalyType = AnomalyType.DISK_FAILURE
    failed_disks: dict[int, list[str]] = dataclasses.field(default_factory=dict)

    def description(self) -> str:
        return f"DiskFailures({self.failed_disks})"


@dataclasses.dataclass
class SlowBrokers(Anomaly):
    """Reference detector/SlowBrokers.java (a MetricAnomaly flavor)."""

    anomaly_type: AnomalyType = AnomalyType.METRIC_ANOMALY
    slow_brokers: dict[int, float] = dataclasses.field(default_factory=dict)  # id -> severity
    #: remove (true) vs demote (false) — reference SlowBrokerFinder config
    remove_slow_brokers: bool = False

    def description(self) -> str:
        return f"SlowBrokers({self.slow_brokers}, remove={self.remove_slow_brokers})"


@dataclasses.dataclass
class TopicReplicationFactorAnomaly(Anomaly):
    """Reference detector/TopicReplicationFactorAnomaly.java."""

    anomaly_type: AnomalyType = AnomalyType.TOPIC_ANOMALY
    bad_topics: dict[str, int] = dataclasses.field(default_factory=dict)  # topic -> observed RF
    target_rf: int = 2

    def description(self) -> str:
        return f"TopicReplicationFactorAnomaly({self.bad_topics} -> rf={self.target_rf})"


@dataclasses.dataclass
class OptimizerDegraded(Anomaly):
    """The device supervisor's circuit breaker opened: the optimizer is
    serving CPU-greedy proposals (common/device_watchdog.DeviceSupervisor).

    Not self-healable by this detector — recovery is the supervisor's
    half-open probe closing the breaker — so fixable=False: the notifier
    alerts operators and the anomaly is recorded, nothing is 'fixed'."""

    anomaly_type: AnomalyType = AnomalyType.OPTIMIZER_DEGRADED
    failure_class: str = "unknown"  # hang / compile / oom / transient
    last_error: str = ""
    open_epoch: int = 0
    fixable: bool = False

    def description(self) -> str:
        return (
            f"OptimizerDegraded(class={self.failure_class}, "
            f"epoch={self.open_epoch}, last_error={self.last_error!r})"
        )


@dataclasses.dataclass
class ExecutionStuck(Anomaly):
    """The executor's stuck-move reaper cancelled a reassignment that made
    no progress for executor.reaper.stuck.timeout.s (executor/executor.py
    _reap_stuck_move).

    Not self-healable: the reaper already acted (rollback via per-partition
    cancellation, or DEAD when the controller cannot cancel) — the anomaly
    exists so operators hear about the wedged move through the notifier and
    it lands in the /state anomaly history."""

    anomaly_type: AnomalyType = AnomalyType.EXECUTION_STUCK
    topic: str = ""
    partition: int = -1
    execution_id: int = -1
    uuid: str = ""
    stalled_s: float = 0.0
    #: True when the controller rolled the partition back to its original
    #: replica set; False means the task was declared DEAD
    rolled_back: bool = False
    fixable: bool = False

    def description(self) -> str:
        return (
            f"ExecutionStuck({self.topic}-{self.partition}, "
            f"task={self.execution_id}, stalled={self.stalled_s:.0f}s, "
            f"{'rolled back' if self.rolled_back else 'DEAD'})"
        )


@dataclasses.dataclass
class FleetLeaseLost(Anomaly):
    """This instance's lease on a cluster expired or was taken over
    (fleet/leases.py) — the cluster is now in read-only degraded mode
    here: proposals//state//fleet keep serving, the executor halted via
    the force-stop path, and every further journal append or cluster
    mutation is fenced on the stale epoch.

    Not self-healable: recovery is either re-acquiring the lease (the
    heartbeat keeps trying) or the peer holder serving the cluster —
    alert-only, like OPTIMIZER_DEGRADED."""

    anomaly_type: AnomalyType = AnomalyType.FLEET_LEASE_LOST
    cluster_id: str = ""
    instance_id: str = ""
    epoch: int = 0
    fixable: bool = False

    def description(self) -> str:
        return (
            f"FleetLeaseLost(cluster={self.cluster_id}, "
            f"instance={self.instance_id}, epoch={self.epoch})"
        )


@dataclasses.dataclass
class FleetOverload(Anomaly):
    """The device scheduler entered an overload episode
    (fleet/scheduler.py): the engine-dispatch queue breached its
    depth/deadline-miss threshold, so background cycles are being shed
    (or browned out under sustained overload) and interactive admissions
    may be 429'd.  Fired ONCE per episode by the scheduler itself.

    Not self-healable by the detector: the scheduler's shed/brownout
    ladder IS the mitigation — alert-only, like OPTIMIZER_DEGRADED, so
    operators learn the instance is past its density budget (add an
    instance, or shard the fleet: ROADMAP item 2c)."""

    anomaly_type: AnomalyType = AnomalyType.FLEET_OVERLOAD
    queue_depth: int = 0
    deadline_miss_ratio: float = 0.0
    episode: int = 0
    fixable: bool = False

    def description(self) -> str:
        return (
            f"FleetOverload(episode={self.episode}, "
            f"queueDepth={self.queue_depth}, "
            f"missRatio={self.deadline_miss_ratio})"
        )


@dataclasses.dataclass
class SloBurn(Anomaly):
    """An SLO registry (common/slo.py) observed its error budget burning
    at >= `slo.burn.threshold` times the sustainable rate over BOTH the
    fast and the slow window — a sustained breach, not a blip.  Fired
    EXACTLY once per breach episode by the registry itself; the episode
    re-arms only after the fast window recovers.

    Not self-healable by the detector: whatever is burning the budget
    (overload, a wedged device, a slow cold start) has its own
    mitigation ladder — alert-only, like OPTIMIZER_DEGRADED and
    FLEET_OVERLOAD, so operators hear the objective is at risk while
    the budget still has headroom."""

    anomaly_type: AnomalyType = AnomalyType.SLO_BURN
    slo: str = ""
    cluster_id: str = ""
    objective: float = 0.0
    fast_burn_rate: float = 0.0
    slow_burn_rate: float = 0.0
    episode: int = 0
    fixable: bool = False

    def description(self) -> str:
        return (
            f"SloBurn(slo={self.slo}, cluster={self.cluster_id or '-'}, "
            f"objective={self.objective}, burn={self.fast_burn_rate}x fast / "
            f"{self.slow_burn_rate}x slow, episode={self.episode})"
        )


@dataclasses.dataclass
class ModelDrift(Anomaly):
    """The calibration loop observed SUSTAINED prediction error: across
    the last `samples` calibrated executions, the mean absolute error
    between the goal scores the engine PREDICTED (decision records,
    analyzer/ledger.py) and the scores MEASURED after the moves landed
    crossed `analyzer.calibration.drift.threshold`.  Fired EXACTLY once
    per drift episode by the facade's calibration detector; the episode
    re-arms once the mean error falls back under the threshold.

    Not self-healable: a drifting model means the capacity model / goal
    chain inputs (broker capacities, CPU model, sample quality) need a
    human look — alert-only, like OPTIMIZER_DEGRADED."""

    anomaly_type: AnomalyType = AnomalyType.MODEL_DRIFT
    cluster_id: str = ""
    samples: int = 0
    mean_goal_error: float = 0.0
    mean_load_error: float = 0.0
    threshold: float = 0.0
    episode: int = 0
    fixable: bool = False

    def description(self) -> str:
        return (
            f"ModelDrift(cluster={self.cluster_id or '-'}, "
            f"goalErr={self.mean_goal_error:.4g}, "
            f"loadErr={self.mean_load_error:.4g} over {self.samples} "
            f"calibrations, threshold={self.threshold:.4g}, "
            f"episode={self.episode})"
        )


@dataclasses.dataclass
class MeshDegraded(Anomaly):
    """A mesh anneal lost one or more devices (or a collective stalled on
    them) and the optimizer's fault-tolerance ladder (parallel/ft.py)
    rebuilt the mesh over the survivors at a reduced width, resuming from
    the last slice-boundary checkpoint.

    Fired EXACTLY once per degrade episode by the facade's mesh-ft
    detector; the episode re-arms when a run completes back at full
    width.  Not self-healable by this detector — the width ladder IS the
    mitigation, and recovery to full width is the per-width breaker's
    half-open probe — so alert-only, like OPTIMIZER_DEGRADED."""

    anomaly_type: AnomalyType = AnomalyType.MESH_DEGRADED
    lost_devices: list[int] = dataclasses.field(default_factory=list)
    from_width: int = 0
    to_width: int = 0
    failure_class: str = "unknown"  # device_lost / collective_stall
    episode: int = 0
    fixable: bool = False

    def description(self) -> str:
        return (
            f"MeshDegraded(lost={self.lost_devices}, "
            f"width={self.from_width}->{self.to_width}, "
            f"class={self.failure_class}, episode={self.episode})"
        )


@dataclasses.dataclass
class TopicPartitionSizeAnomaly(Anomaly):
    """Reference detector/TopicPartitionSizeAnomaly.java."""

    anomaly_type: AnomalyType = AnomalyType.TOPIC_ANOMALY
    oversized: dict[tuple[str, int], float] = dataclasses.field(default_factory=dict)
    fixable: bool = False  # reference: self-healing not supported for this one

    def description(self) -> str:
        return f"TopicPartitionSizeAnomaly({len(self.oversized)} partitions)"
