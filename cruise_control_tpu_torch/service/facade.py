"""CruiseControl service facade — wires monitor, analyzer, executor, detector.

Reference: KafkaCruiseControl.java:100-117 (construction wires the four
subsystems), startUp():162 (start monitor + detection + proposal
precompute), optimizations():493, executeProposals():546, and the
operation runnables (servlet/handler/async/runnable/): RebalanceRunnable,
AddBrokersRunnable, RemoveBrokersRunnable, DemoteBrokerRunnable,
FixOfflineReplicasRunnable, UpdateTopicConfigurationRunnable.

Also implements the detector's SelfHealingActions so anomaly fixes run
through the exact same paths user requests do (reference GoalViolations
fix == RebalanceRunnable self-healing constructor).

One device serves a facade: the analyzer core's optimizer, scenario
evaluator and rightsizer run on it, and the monitor builds its models
there (service/main.py resolves it once).  On the card a supervised
route that fails raises `DeviceDegradedError` or `BreakerOpenError`
(common/device_watchdog.py), which the REST layer answers with a 503; no
work of the card is answered on the CPU.  Two modes of the JAX package
are not in this package yet and are refused with a `ConfigException`
naming the key: a `tpu.parallel.mode` other than "single" (the mesh
engine layer) and `controller.enabled=true` (the streaming controller).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import (
    GoalChain,
    GoalOptimizer,
    OptimizationOptions,
    OptimizerConfig,
    OptimizerResult,
)
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.common.sensors import SensorRegistry
from cruise_control_tpu_torch.config.app_config import CruiseControlConfig
from cruise_control_tpu_torch.config.config_def import ConfigException
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.detector import (
    AnomalyDetector,
    AnomalyType,
    BrokerFailureDetector,
    DiskFailureDetector,
    GoalViolationDetector,
    SelfHealingNotifier,
    TopicReplicationFactorAnomalyFinder,
)
from cruise_control_tpu_torch.executor import ExecutionOptions, Executor, OngoingExecutionError
from cruise_control_tpu_torch.executor.admin import ClusterAdmin
from cruise_control_tpu_torch.fleet.scheduler import WorkClass
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.monitor import (
    LoadMonitor,
    ModelCompletenessRequirements,
)
from cruise_control_tpu_torch.service.progress import (
    BatchedOptimization,
    ExecutingProposals,
    GeneratingClusterModel,
    OperationProgress,
    WaitingForClusterModel,
)

log = logging.getLogger(__name__)


def refuse_unported_modes(config: CruiseControlConfig) -> None:
    """Raise `ConfigException` for a mode the JAX package runs and this
    package does not have yet; the config itself parses both as the JAX
    package does."""
    mode = config.parallel_mode()
    if mode != "single":
        raise ConfigException(
            f"tpu.parallel.mode={mode!r} is not supported by this package "
            "yet: only 'single' runs (the mesh engine layer is ROADMAP "
            "queue 1 item 10)"
        )
    if config.get("controller.enabled"):
        raise ConfigException(
            "controller.enabled=true is not supported by this package yet: "
            "the streaming controller is ROADMAP queue 1 slice 20"
        )


@dataclasses.dataclass
class _CachedResult:
    result: OptimizerResult
    computed_ms: int  # wall clock, for reporting only
    #: monotonic stamp for expiry — a backwards wall-clock step (NTP) must
    #: not make cached proposals immortal (or instantly stale)
    computed_mono: float
    model_generation: object
    #: who filled this slot: "optimizer" (request/precompute path) or
    #: "controller" (streaming controller publish) — surfaced in /state
    #: so an operator can tell which pipeline the served proposal rode
    source: str = "optimizer"


class AnalyzerCore:
    """The SHARED half of the service: everything that is expensive and
    cluster-agnostic — the goal chain, the GoalOptimizer with its compiled-
    engine cache, the DeviceSupervisor (one circuit breaker for the whole
    instance), the ScenarioEvaluator/Rightsizer, the tracer, and the
    profiling surface.

    A classic deployment builds one implicitly inside its CruiseControl
    facade (behavior unchanged); the fleet controller (fleet/manager.py)
    builds ONE explicitly and hands it to N per-cluster facades, so
    clusters whose bucketed shapes coincide reuse the same compiled
    engines (observable via the `analyzer.engine-cache-*` counters on
    this core's registry) while the cheap per-cluster halves — monitors,
    executors, journals, detectors — multiply."""

    def __init__(
        self,
        config: CruiseControlConfig,
        *,
        sensors: SensorRegistry | None = None,
        tracer=None,
        chain: GoalChain | None = None,
        device=None,
    ):
        """device: where the optimizer, the scenario evaluator and the
        rightsizer run — the current CUDA device when None (raising
        without one), the CPU only when the caller names it."""
        refuse_unported_modes(config)
        self.config = config
        self.device = resolve_device(device)
        self.sensors = sensors if sensors is not None else SensorRegistry()
        #: flight recorder (config trace.*): ONE tracer per service — in a
        #: fleet every cluster facade records into this same store under a
        #: cluster-scoped component namespace (Tracer.scoped), so one
        #: operation's trace stays whole across shared and per-cluster
        #: subsystems
        self.tracer = tracer if tracer is not None else config.tracer()
        # device profiling surface: per-backend memory/live-buffer gauges
        # + per-device labeled collector, scrapeable via GET /metrics
        from cruise_control_tpu_torch.common.profiling import register_device_gauges

        self.peak_tracker = register_device_gauges(self.sensors)
        #: opt-in torch.profiler dump dir (config tpu.profiler.*)
        self.profiler_dir = (
            config.get("tpu.profiler.dump.dir")
            if config.get("tpu.profiler.enabled")
            else None
        )
        self.constraint = config.balancing_constraint()
        self.chain = chain or GoalChain.from_names(config.get("default.goals"))
        #: reference AnalyzerConfig goal.balancedness.{priority,strictness}.weight
        #: — used by EVERY optimizer built over this core, including the
        #: ad-hoc per-request ones (custom goals / rebalance_disk)
        self.balancedness_weights = (
            config.get("goal.balancedness.priority.weight"),
            config.get("goal.balancedness.strictness.weight"),
        )
        #: shape-bucketing policy the monitors build models under; the
        #: precompute loops pre-warm the NEXT bucket through it
        self.bucket_policy = config.shape_bucket_policy()
        #: ONE supervisor for every optimizer over this core (default +
        #: ad-hoc per-request ones + the precompute threads): they all feed
        #: the same circuit breaker, so a wedged device degrades the whole
        #: analyzer surface coherently instead of per-optimizer
        self.supervisor = config.device_supervisor(
            sensors=self.sensors, tracer=self.tracer, device=self.device
        )
        #: QoS-aware device scheduler (fleet/scheduler.py, config
        #: fleet.scheduler.*): ONE per core — it arbitrates the single
        #: shared device every facade over this core dispatches onto.
        #: None (the default) keeps every dispatch path byte-for-byte
        #: unscheduled.
        self.scheduler = None
        if config.get("fleet.scheduler.enabled"):
            from cruise_control_tpu_torch.fleet.scheduler import DeviceScheduler

            self.scheduler = DeviceScheduler(
                slice_budget_s=config.get("fleet.scheduler.slice.budget.s"),
                freshness_slo_s=config.get("fleet.scheduler.freshness.slo.s"),
                aging_s=config.get("fleet.scheduler.aging.s"),
                shed_queue_depth=config.get("fleet.scheduler.shed.queue.depth"),
                brownout_after_s=config.get("fleet.scheduler.brownout.after.s"),
                brownout_factor=config.get(
                    "fleet.scheduler.brownout.candidate.factor"
                ),
                fast_path_enabled=config.get(
                    "fleet.scheduler.fast.path.enabled"
                ),
                sensors=self.sensors,
            )
        #: black-box dispatch spool (common/blackbox.py, config
        #: blackbox.*): the PROCESS-WIDE recorder is configured here — one
        #: spool file per process under the journal/compile-cache mount,
        #: shared by every facade over this core, so a hang or a kill
        #: leaves a durable "last dispatch in flight" trail.  Disabled
        #: (one predicate per dispatch, zero writes) when no durable
        #: directory exists.
        from cruise_control_tpu_torch.common.blackbox import RECORDER as _bb

        bb_dir = config.blackbox_dir()
        if bb_dir:
            import os

            _bb.configure(
                os.path.join(
                    os.path.expanduser(bb_dir), f"spool-{os.getpid()}.jsonl"
                ),
                max_records=config.get("blackbox.spool.max.records"),
                fsync_batch=config.get("blackbox.fsync.batch.records"),
            )
        else:
            # blackbox.enabled=false / explicitly empty dir must DISABLE
            # a recorder an earlier core in this process configured — the
            # recorder is process-wide, and the disabled contract (zero
            # writes) is pinned
            _bb.configure(None)
        self.blackbox = _bb
        self.sensors.gauge(
            "blackbox.enabled", lambda: 1.0 if _bb.enabled else 0.0
        )
        self.sensors.gauge(
            "blackbox.records-written", lambda: float(_bb.state_json()["recordsWritten"])
        )
        self.sensors.gauge(
            "blackbox.write-errors", lambda: float(_bb.write_errors)
        )
        #: ONE SLO evaluation loop per core (common/slo.py SloTicker):
        #: every facade's registry ticks on this shared thread instead of
        #: N clusters running N wakeup loops; no thread exists until the
        #: first start_up adds a registry
        from cruise_control_tpu_torch.common.slo import SloTicker

        self.slo_ticker = SloTicker(
            interval_s=config.get("slo.tick.interval.s")
        )
        #: boot-prewarm manifest (tpu.prewarm.*, analyzer/prewarm.py; no
        #: AOT half in this package, so tpu.prewarm.aot.enabled has no
        #: effect): ONE per core, so N fleet facades MERGE their bucket
        #: working sets into one manifest instead of last-writer-wins,
        #: and a restart replays every cluster's buckets through
        #: claim_boot_entries() exactly once
        self.prewarm_store = None
        prewarm_dir = config.prewarm_manifest_dir()
        if prewarm_dir:
            from cruise_control_tpu_torch.analyzer.prewarm import PrewarmStore

            self.prewarm_store = PrewarmStore(
                prewarm_dir,
                chain=self.chain,
                constraint=self.constraint,
                max_entries=config.get("tpu.prewarm.max.entries"),
            )
        self.optimizer = GoalOptimizer(
            chain=self.chain,
            constraint=self.constraint,
            config=config.optimizer_config(),
            device=self.device,
            balancedness_weights=self.balancedness_weights,
            engine_cache_size=config.get("tpu.engine.cache.size"),
            sensors=self.sensors,
            supervisor=self.supervisor,
            degraded_budget_s=config.get("tpu.supervisor.degraded.greedy.budget.s"),
            tracer=self.tracer,
            profiler_dir=self.profiler_dir,
            prewarm_store=self.prewarm_store,
        )
        # per-bucket cold-start attribution as labeled /metrics series
        # (only the core's long-lived default optimizer feeds it; ad-hoc
        # per-request optimizers are too short-lived to own a collector)
        self.sensors.collector(
            "analyzer.engine-compile-seconds-by-bucket",
            self.optimizer.compile_attribution_values,
        )
        from cruise_control_tpu_torch.analyzer.scenario_eval import ScenarioEvaluator
        from cruise_control_tpu_torch.planner.rightsizer import Rightsizer

        #: scenario planner: batched what-if evaluation over the SAME goal
        #: chain, constraint, supervisor, and optimizer (engine cache) the
        #: proposal path uses — a simulated future and a real proposal are
        #: scored by one code path
        self.scenario_evaluator = ScenarioEvaluator(
            chain=self.chain,
            constraint=self.constraint,
            optimizer=self.optimizer,
            supervisor=self.supervisor,
            sensors=self.sensors,
            balancedness_weights=self.balancedness_weights,
            # +1: simulate() rides a baseline scenario in every batch; a
            # request of exactly planner.max.scenarios must not be pushed
            # over the evaluator's limit by the rider
            max_scenarios=config.get("planner.max.scenarios") + 1,
            device=self.device,
        )
        self.rightsizer = Rightsizer(
            self.scenario_evaluator,
            min_brokers=config.get("planner.rightsize.min.brokers"),
            max_broker_factor=config.get("planner.rightsize.max.broker.factor"),
            bucket=self.bucket_policy,
            sensors=self.sensors,
        )


class CruiseControl:
    """The service facade (reference KafkaCruiseControl.java).

    One facade per Kafka cluster: it OWNS the cluster-scoped subsystems
    (monitor, executor + journal, detector, notifier, proposal cache) and
    runs the analysis surface through an AnalyzerCore — its own private
    one by default, or a shared one handed in by the fleet controller
    (`core=`), in which case `cluster_id` namespaces the executor journal
    directory and the trace components."""

    def __init__(
        self,
        config: CruiseControlConfig,
        monitor: LoadMonitor,
        admin: ClusterAdmin,
        *,
        chain: GoalChain | None = None,
        sensors: SensorRegistry | None = None,
        core: AnalyzerCore | None = None,
        cluster_id: str | None = None,
        fence=None,
        device=None,
    ):
        """fence (fleet HA, fleet/leases.py): this cluster's lease fence.
        When set, the execution journal stamps/checks its epoch, journal
        reconciliation is DEFERRED until the fleet manager activates the
        cluster post-acquisition, and every execution start gates on it —
        a facade without the lease serves read-only.

        device: the facade's one device (the core's when a core is
        given); None takes the monitor's, else the current CUDA device,
        raising without one.  The monitor builds its models there."""
        refuse_unported_modes(config)
        if device is None:
            device = core.device if core is not None else getattr(monitor, "device", None)
        device = resolve_device(device)
        if core is not None and core.device != device:
            raise ValueError(f"the analyzer core runs on {core.device}, the facade on {device}")
        mon_dev = getattr(monitor, "device", None)
        if mon_dev is not None and resolve_device(mon_dev) != device:
            raise ValueError(f"the monitor builds on {mon_dev}, the facade runs on {device}")
        monitor.device = device
        self.device = device
        self.config = config
        self.monitor = monitor
        self.admin = admin
        self.fence = fence
        #: per-instance sensor catalog (module-global registries would mix
        #: counters across embedded instances; reference scopes its
        #: MetricRegistry per app, KafkaCruiseControlApp.java:39-41).  In a
        #: fleet this registry is cluster-labeled and distinct from the
        #: shared core's.
        self.sensors = sensors if sensors is not None else SensorRegistry()
        monitor.sensors = self.sensors
        if core is None:
            core = AnalyzerCore(config, sensors=self.sensors, chain=chain, device=device)
        self.core = core
        self.cluster_id = cluster_id
        #: cluster-scoped view of the core tracer: in a fleet, this
        #: cluster's monitor/executor/detector spans land in their own
        #: per-component retention rings (`<cluster>:executor`) while the
        #: trace ids stay instance-global
        self.tracer = (
            core.tracer.scoped(cluster_id) if cluster_id else core.tracer
        )
        monitor.tracer = self.tracer
        # shared-core aliases: every pre-fleet call site (and subclass)
        # keeps reading these off the facade
        self.profiler_dir = core.profiler_dir
        self.constraint = core.constraint
        self.chain = core.chain
        self.balancedness_weights = core.balancedness_weights
        self.bucket_policy = core.bucket_policy
        self.supervisor = core.supervisor
        self.optimizer = core.optimizer
        self.scenario_evaluator = core.scenario_evaluator
        self.rightsizer = core.rightsizer
        #: shared device scheduler (None when fleet.scheduler.enabled is
        #: off); the per-cluster freshness SLO rides each request as its
        #: deadline input
        self.scheduler = core.scheduler
        self._freshness_slo_s = config.get("fleet.scheduler.freshness.slo.s")
        from cruise_control_tpu_torch.executor.strategy import resolve_strategy_chain

        #: the configured strategy pool gates what requests may reference
        #: (reference ExecutorConfig replica.movement.strategies); dotted
        #: paths in the pool register custom classes on first resolve
        self.allowed_strategies = set(config.get("replica.movement.strategies"))
        notifier_cls = config.get("executor.notifier.class")
        # durable execution journal (crash-safe execution): constructing the
        # Executor replays it and reconciles anything a crashed predecessor
        # left in flight; start_up() resumes the remainder
        journal = None
        journal_dir = config.get("executor.journal.dir")
        if journal_dir:
            import os

            from cruise_control_tpu_torch.executor.journal import ExecutionJournal

            if cluster_id:
                # fleet: each cluster journals under its own subdirectory,
                # and each cluster's Executor replays ONLY its own journal
                # at construction — a fleet restart reconciles every
                # cluster's in-flight moves without one cluster ever
                # adopting another's (the ids are config-validated to be
                # path-safe)
                journal_dir = os.path.join(journal_dir, cluster_id)
            journal = ExecutionJournal(
                os.path.join(journal_dir, "execution-journal.jsonl"),
                fsync_batch=config.get("executor.journal.fsync.batch.size"),
                fence=fence,
                retention_count=config.get("executor.journal.retention.count"),
                retention_hours=config.get("executor.journal.retention.hours"),
            )
        self.executor = Executor(
            admin,
            strategy=resolve_strategy_chain(
                config.get("default.replica.movement.strategies"),
                allowed=self.allowed_strategies,
            ),
            sensors=self.sensors,
            tracer=self.tracer,
            removal_history_retention_ms=config.get(
                "removal.history.retention.time.ms"
            ),
            demotion_history_retention_ms=config.get(
                "demotion.history.retention.time.ms"
            ),
            notifier=notifier_cls() if notifier_cls is not None else None,
            journal=journal,
            # HA: reconciliation sweeps throttles on the live cluster —
            # it must wait for lease acquisition (FleetManager activates)
            defer_recovery=fence is not None,
        )
        if self.executor.recovery_info() is not None:
            log.warning(
                "executor journal reconciliation: %s",
                self.executor.recovery_info(),
            )
        self._cache: _CachedResult | None = None
        self._cache_lock = threading.Lock()
        self._proposal_expiration_ms = config.get("proposal.expiration.ms")
        webhook = config.get("slack.self.healing.notifier.webhook")
        notifier_cls = SelfHealingNotifier
        notifier_kwargs: dict = {}
        if webhook:
            from cruise_control_tpu_torch.detector.notifier import SlackSelfHealingNotifier

            notifier_cls = SlackSelfHealingNotifier
            notifier_kwargs = dict(
                webhook_url=webhook,
                channel=config.get("slack.self.healing.notifier.channel"),
                username=config.get("slack.self.healing.notifier.user"),
            )
        notifier = notifier_cls(
            **notifier_kwargs,
            self_healing={
                AnomalyType.BROKER_FAILURE: config.get("self.healing.broker.failure.enabled"),
                AnomalyType.GOAL_VIOLATION: config.get("self.healing.goal.violation.enabled"),
                AnomalyType.DISK_FAILURE: config.get("self.healing.disk.failure.enabled"),
                AnomalyType.METRIC_ANOMALY: config.get("self.healing.metric.anomaly.enabled"),
                AnomalyType.TOPIC_ANOMALY: config.get("self.healing.topic.anomaly.enabled"),
            },
            broker_failure_alert_threshold_ms=config.get("broker.failure.alert.threshold.ms"),
            broker_failure_self_healing_threshold_ms=config.get(
                "broker.failure.self.healing.threshold.ms"
            ),
        )
        self.notifier = notifier
        self.actions = SelfHealingAdapter(self)
        self.anomaly_detector = AnomalyDetector(
            notifier,
            self.actions,
            sensors=self.sensors,
            history_size=config.get("num.cached.recent.anomaly.states"),
            tracer=self.tracer,
        )
        # the stuck-move reaper reports EXECUTION_STUCK through the same
        # queue every detector feeds, so the notifier (Slack included)
        # alerts on wedged moves like any other anomaly
        self.executor.anomaly_sink = self.anomaly_detector.add_anomaly
        #: decision ledger (analyzer/ledger.py, config analyzer.ledger.*):
        #: one durable `decision` record per published proposal, joined by
        #: an `outcome` record when its execution finishes (the executor's
        #: finish hook below) and a `calibration` record once the next
        #: complete metric window measures what the moves actually did —
        #: ROADMAP item 3's training corpus and the GET /explain surface.
        #: Fleet deployments namespace one ledger per cluster, exactly
        #: like the execution journal.
        self.ledger = None
        ledger_dir = config.ledger_dir()
        if ledger_dir:
            import os

            from cruise_control_tpu_torch.analyzer.ledger import DecisionLedger

            if cluster_id:
                ledger_dir = os.path.join(ledger_dir, cluster_id)
            self.ledger = DecisionLedger(
                os.path.join(ledger_dir, "decision-ledger.jsonl"),
                retention_count=config.get("analyzer.ledger.retention.count"),
                retention_hours=config.get("analyzer.ledger.retention.hours"),
                sensors=self.sensors,
            )
        #: in-memory predictions of recent decisions (decision id ->
        #: predicted goal/load scores) awaiting their calibration join;
        #: bounded — a decision that never executes ages out
        from collections import OrderedDict, deque

        self._predictions: OrderedDict = OrderedDict()
        self._predictions_cap = 64
        self._ledger_lock = threading.Lock()
        #: decision id whose execution is currently in flight (the
        #: executor serializes executions, so one slot suffices)
        self._executing_decision: str | None = None
        #: calibrations awaiting the next complete metric window
        self._pending_calibrations: list[dict] = []
        #: recent calibration errors driving the MODEL_DRIFT episode —
        #: sized to hold at least drift.min.samples, or a large
        #: min-samples setting could silently never fire
        self._calibration_errors: deque = deque(
            maxlen=max(
                16, config.get("analyzer.calibration.drift.min.samples")
            )
        )
        self._drift_active = False
        self._drift_episodes = 0
        self._calibration_samples = 0
        self._last_calibration: dict | None = None
        self.executor.execution_observer = self._on_execution_finished
        if self.ledger is not None:
            self.sensors.gauge(
                "analyzer.calibration.pending",
                lambda: float(len(self._pending_calibrations)),
            )
            self.sensors.gauge(
                "analyzer.calibration.drift-active",
                lambda: 1.0 if self._drift_active else 0.0,
            )
        if core.scheduler is not None and core.scheduler.anomaly_sink is None:
            # FLEET_OVERLOAD is an INSTANCE-level episode: the first
            # facade built over the core claims the sink, so the anomaly
            # fires exactly once per episode instead of once per cluster
            core.scheduler.anomaly_sink = self.anomaly_detector.add_anomaly
        #: published-proposal age (the freshness the scheduler's SLO
        #: protects, observable): seconds since the cached proposal was
        #: computed, -1 while none is published.  Per cluster via this
        #: facade's (labeled) registry.
        self.sensors.gauge("analyzer.proposal-age-seconds", self.proposal_age_s)
        #: SLO registry (common/slo.py, config slo.*): per cluster, fed
        #: by the controller (publish latency), the scheduler (urgent
        #: queue wait), this facade (cold start) and a freshness probe;
        #: burn episodes raise SLO_BURN through this cluster's detector
        self.slo_registry = None
        self._coldstart_t0 = time.monotonic()
        self._coldstart_recorded = False
        if config.get("slo.enabled"):
            from cruise_control_tpu_torch.common.slo import SloRegistry, SloSpec

            reg = SloRegistry(
                fast_window_s=config.get("slo.burn.fast.window.s"),
                slow_window_s=config.get("slo.burn.slow.window.s"),
                burn_threshold=config.get("slo.burn.threshold"),
                sensors=self.sensors,
                anomaly_sink=self.anomaly_detector.add_anomaly,
                cluster_id=cluster_id or "",
            )
            fresh_s = self._freshness_slo_s
            reg.register(SloSpec(
                name="proposal-freshness",
                description="a published/cached proposal no older than "
                            "the per-cluster freshness SLO is available",
                objective=0.99,
                target=f"proposal age <= {fresh_s:g}s "
                       "(fleet.scheduler.freshness.slo.s)",
                # age < 0 = nothing published yet: no data, not a breach
                # (a cold service is the cold-start SLO's business)
                probe=lambda: (
                    None if (age := self.proposal_age_s()) < 0
                    else age <= self._freshness_slo_s
                ),
            ))
            reg.register(SloSpec(
                name="cold-start",
                description="start to first served/published proposal "
                            "within the restart SLO (one sample per "
                            "process; bench.py --coldstart is the gate)",
                objective=0.99,
                target=f"<= {config.get('slo.coldstart.target.s'):g}s "
                       "(slo.coldstart.target.s)",
            ))
            reg.register(SloSpec(
                name="streaming-publish",
                description="window-roll-to-published-proposal latency "
                            "of the streaming controller's hot path "
                            "(controller.window-roll-to-publish-seconds)",
                objective=0.99,
                target=f"<= {config.get('slo.streaming.publish.target.s'):g}s "
                       "(slo.streaming.publish.target.s)",
            ))
            if core.scheduler is not None:
                reg.register(SloSpec(
                    name="urgent-queue-wait",
                    description="URGENT engine dispatches granted within "
                                "one slice budget (the scheduler's "
                                "preemption bound)",
                    objective=0.99,
                    target="queue wait <= fleet.scheduler.slice.budget.s",
                ))
                if core.scheduler.slo_registry is None:
                    # like the FLEET_OVERLOAD sink: the first facade over
                    # the core claims the scheduler's SLO feed, so urgent
                    # waits are one instance-level series
                    core.scheduler.slo_registry = reg
            self.slo_registry = reg
        self._wire_detectors()
        self._started_ms = int(time.time() * 1000)
        self._precompute_thread: threading.Thread | None = None
        self._stop_precompute = threading.Event()
        #: LoadMonitorTaskRunner attached by build_service (bootstrap/train)
        self.task_runner = None
        #: streaming controller (controller/streaming.py, config
        #: controller.*): the always-on incremental rebalancing loop.
        #: While it runs it REPLACES the legacy proposal-precompute loop
        #: (it publishes a fresh proposal every window roll) and the
        #: bucket-prewarm path stands down (the controller's donated
        #: in-place updates invalidate published state arrays, which
        #: prewarm would otherwise re-pad).  In a fleet, every cluster
        #: facade builds its own instance from its cluster config.
        self.controller = None
        self._compile_cache_reported = False
        #: set once the boot-time manifest prewarm has ENQUEUED its
        #: engines (compiles continue on the warm pool); pre-set so
        #: facades that never start_up (tests, bench drivers) and
        #: deployments without a manifest behave exactly as today
        self._boot_prewarm_done = threading.Event()
        self._boot_prewarm_done.set()

    def _detect_optimizer_degraded(self):
        """OPTIMIZER_DEGRADED anomaly, once per breaker-open episode.

        Edge-triggered on the supervisor's open epoch: the breaker staying
        open across detection rounds is ONE degradation event, not a new
        anomaly per round (the /state supervisor block carries the live
        state); a close-then-reopen bumps the epoch and reports again."""
        sup = self.supervisor
        if sup is None or not sup.is_degraded:
            return None
        epoch = sup.open_epoch
        if epoch == self._degraded_reported_epoch:
            return None
        self._degraded_reported_epoch = epoch
        from cruise_control_tpu_torch.detector.anomalies import OptimizerDegraded

        last = sup.last_failure or {}
        return OptimizerDegraded(
            failure_class=last.get("class", "unknown"),
            last_error=str(last.get("error", "")),
            open_epoch=epoch,
        )

    def _detect_mesh_degraded(self):
        """MESH_DEGRADED anomaly, once per mesh degrade episode.

        The mesh-ft controller (parallel/ft.py) arms ONE pending event
        when an episode opens (first width reduction) and re-arms only
        after a run completes back at full width — so the breaker walking
        further down the ladder inside the same episode never re-fires
        (the /state meshFt block carries the live width)."""
        ft = getattr(self.optimizer, "_mesh_ft", None)
        if ft is None:
            return None
        event = ft.poll_event()
        if event is None:
            return None
        from cruise_control_tpu_torch.detector.anomalies import MeshDegraded

        return MeshDegraded(
            lost_devices=list(event.get("lost_devices", [])),
            from_width=int(event.get("from_width", 0)),
            to_width=int(event.get("to_width", 0)),
            failure_class=str(event.get("failure_class", "unknown")),
            episode=int(event.get("episode", 0)),
        )

    def _wire_detectors(self):
        """Reference AnomalyDetector.java:63-68 wiring."""
        from cruise_control_tpu_torch.detector.detectors import SlowBrokerFinder

        #: last breaker-open epoch reported as an anomaly (edge trigger)
        self._degraded_reported_epoch = 0

        req = ModelCompletenessRequirements(min_required_num_windows=1)
        # the violation detector watches its own (usually smaller) goal list
        # (reference AnomalyDetectorConfig anomaly.detection.goals:103-107)
        detection_goals = self.config.get("anomaly.detection.goals")
        detection_chain = (
            GoalChain.from_names(detection_goals) if detection_goals else self.chain
        )
        allow_est = self.config.get("anomaly.detection.allow.capacity.estimation")
        gvd = GoalViolationDetector(
            lambda: self.monitor.cluster_model(
                req, allow_capacity_estimation=allow_est
            ),
            detection_chain,
            self.constraint,
        )
        bfd = BrokerFailureDetector(
            self.admin.topology,
            persist_path=self.config.get("broker.failure.persisted.path"),
        )
        dfd = DiskFailureDetector(self.admin.topology)
        # pluggable topic-config provider feeds min.insync.replicas into RF
        # anomaly detection (reference topic.config.provider.class)
        tcp_cls = self.config.get("topic.config.provider.class")
        topic_config_provider = (
            tcp_cls(self.config, self.admin) if tcp_cls is not None else None
        )
        rf_finder_cls = self.config.get("topic.anomaly.finder.class")
        if rf_finder_cls is not None:
            rfd = rf_finder_cls(self.admin.topology, self.config)
        else:
            rfd = TopicReplicationFactorAnomalyFinder(
                self.admin.topology,
                target_rf=self.config.get("topic.anomaly.target.replication.factor"),
                topic_config_provider=topic_config_provider,
            )
        slow_finder_cls = self.config.get("metric.anomaly.finder.class")
        custom_slow = (
            slow_finder_cls(self.config) if slow_finder_cls is not None else None
        )
        slow = SlowBrokerFinder(
            history_percentile=self.config.get("slow.broker.history.percentile"),
            peer_ratio=self.config.get("slow.broker.peer.comparison.ratio"),
            removal_threshold=self.config.get("slow.broker.strike.removal.threshold"),
        )

        def slow_detect():
            """Feed the finder multi-family broker evidence: byte-rate-
            normalized log-flush time plus raw request latencies and queue
            depth (reference SlowBrokerFinder.java:99 collects byte rates
            AND request latencies; one family spiking must not flag)."""
            runner = self.task_runner
            agg = getattr(getattr(runner, "fetcher", None), "broker_aggregator", None)
            if agg is None or not agg.num_entities():
                return None
            try:
                from cruise_control_tpu_torch.monitor.aggregator import AggregationOptions

                res = agg.aggregate(
                    AggregationOptions(
                        max_allowed_extrapolations_per_entity=self.config.get(
                            "max.allowed.extrapolations.per.broker"
                        )
                    )
                )
            except ValueError:
                return None
            m = agg.metric_def

            def mid(name):
                try:
                    return m.metric_id(name)
                except KeyError:
                    return None

            flush = mid("BROKER_LOG_FLUSH_TIME_MS_MEAN")
            if flush is None:
                return None
            families = {
                "log_flush_time_ms_mean": flush,
                "produce_local_time_ms_mean": mid("BROKER_PRODUCE_LOCAL_TIME_MS_MEAN"),
                "request_queue_size": mid("BROKER_REQUEST_QUEUE_SIZE"),
            }
            bytes_ids = [mid("LEADER_BYTES_IN"), mid("REPLICATION_BYTES_IN_RATE")]
            evidence: dict[int, dict[str, float]] = {}
            for i, entity in enumerate(agg.entities()):
                valid = res.window_valid[i]
                if not valid.any():
                    continue
                w = int(np.nonzero(valid)[0][0])  # newest valid window
                row = res.values[i, w]
                fams: dict[str, float] = {}
                for name, idx in families.items():
                    if idx is not None:
                        fams[name] = float(row[idx])
                # byte-normalized flush time REPLACES the raw value when a
                # byte rate exists (reference divides latency by the byte
                # rate so a busier broker is not "slower"); keeping both
                # would double-count one correlated signal toward the
                # majority bar
                rate = sum(float(row[j]) for j in bytes_ids if j is not None)
                if rate > 0:
                    fams["log_flush_time_per_mb"] = fams.pop(
                        "log_flush_time_ms_mean"
                    ) / max(rate, 1e-9)
                evidence[int(getattr(entity, "broker_id", entity))] = fams
            # a configured metric.anomaly.finder.class replaces the builtin
            anomaly = (custom_slow or slow).detect(evidence)
            # removal (decommission + rebuild) is destructive; the dedicated
            # switch gates it regardless of strike count (reference
            # AnomalyDetectorConfig slow.broker removal switches)
            if (
                anomaly is not None
                and anomaly.remove_slow_brokers
                and not self.config.get("slow.broker.removal.enabled")
            ):
                anomaly = dataclasses.replace(anomaly, remove_slow_brokers=False)
            return anomaly

        self.broker_failure_detector = bfd
        self.slow_broker_finder = slow

        def _interval(key: str) -> float | None:
            ms = self.config.get(key)
            return ms / 1000.0 if ms else None

        reg = self.anomaly_detector.register_detector
        reg(gvd.detect, interval_s=_interval("goal.violation.detection.interval.ms"))
        # broker failures are watched every round (the reference's ZK
        # watcher is effectively continuous); the backoff key only delays
        # retries after a failed detection, it is NOT a cadence
        reg(
            bfd.detect,
            error_backoff_s=_interval("broker.failure.detection.backoff.ms"),
        )
        reg(dfd.detect, interval_s=_interval("disk.failure.detection.interval.ms"))
        reg(rfd.detect, interval_s=_interval("topic.anomaly.detection.interval.ms"))
        if self.config.get("partition.size.detection.enabled"):
            from cruise_control_tpu_torch.detector.detectors import (
                PartitionSizeAnomalyFinder,
            )

            psf = PartitionSizeAnomalyFinder(
                lambda: self.monitor.cluster_model(
                    req, allow_capacity_estimation=allow_est
                ),
                lambda: self.monitor.last_catalog,
                max_partition_size=self.config.get(
                    "self.healing.partition.size.threshold.byte"
                ),
                excluded_topics_pattern=self.config.get(
                    "topic.excluded.from.partition.size.check"
                ),
            )
            reg(psf.detect, interval_s=_interval("topic.anomaly.detection.interval.ms"))
        reg(slow_detect, interval_s=_interval("metric.anomaly.detection.interval.ms"))
        # supervisor breaker watch: every round (cheap property reads)
        reg(self._detect_optimizer_degraded)
        # mesh fault-tolerance watch: drains the once-per-episode
        # MESH_DEGRADED event the width ladder armed (cheap poll)
        reg(self._detect_mesh_degraded)
        # calibration loop + MODEL_DRIFT watch (decision ledger): cheap
        # when nothing is due — the measured-state scoring dispatch runs
        # only once an executed decision's next metric window completes
        reg(self._detect_model_drift)

    # ------------------------------------------------------------------
    # lifecycle (reference startUp():162)
    # ------------------------------------------------------------------

    def start_up(self, *, detection_interval_s: float | None = None, precompute: bool = False):
        self.monitor.start()
        self.anomaly_detector.start(
            detection_interval_s
            or self.config.get("anomaly.detection.interval.ms") / 1000.0
        )
        # boot prewarm (analyzer/prewarm.py): replay the durable manifest
        # through the warm pool so the ACTIVE buckets are compiling before
        # resume_recovered_execution() or the controller's first cycle
        # needs a proposal.  One claim per store: in a fleet, every
        # facade's start_up races here and exactly one runs the replay.
        store = getattr(self.optimizer, "prewarm_store", None)
        if store is not None:
            self._boot_prewarm_done.clear()
            threading.Thread(
                target=self._boot_prewarm, daemon=True, name="boot-prewarm"
            ).start()
        if self.executor.has_recovered_execution:
            # drive the journal-reconciled remainder off the startup path:
            # re-adopted moves progress without resubmission while the
            # service comes up (reference resumes its persisted execution
            # the same way)
            self.resume_recovered_async()
        if self.controller is not None:
            # the streaming controller IS the always-on precompute: it
            # publishes a fresh proposal every window roll, so the legacy
            # timer loop would only burn duplicate anneals beside it.
            # It starts immediately but lets the boot-time manifest
            # prewarm COMPLETE (bounded) before its first cycle takes
            # ownership — its donated in-place updates park the bucket
            # prewarm path, so boot is the one window this prewarm has.
            self.controller.start(boot_gate=self._boot_prewarm_done)
        elif precompute:
            self._precompute_thread = threading.Thread(
                target=self._precompute_loop, daemon=True, name="proposal-precompute"
            )
            self._precompute_thread.start()
        if self.slo_registry is not None:
            # continuous SLO evaluation: probes sampled + burn episodes
            # fired with nobody scraping /slo (the alert path must not
            # depend on being observed); the ticker thread is shared by
            # every facade over this core
            self.core.slo_ticker.add(self.slo_registry)
            self.core.slo_ticker.start()

    def resume_recovered_async(self):
        """Background-drive a journal-reconciled execution remainder.
        FencedError mid-resume (fleet HA: the lease was lost again) is an
        ordinary step-down, not a crashed thread."""

        def run():
            try:
                self.executor.resume_recovered_execution()
            except Exception as e:  # noqa: BLE001 — classify below
                from cruise_control_tpu_torch.fleet.leases import FencedError

                if isinstance(e, FencedError):
                    log.warning(
                        "recovery resume fenced (lease lost): %s", e
                    )
                else:
                    log.warning("recovery resume failed", exc_info=True)

        threading.Thread(target=run, daemon=True, name="executor-recovery").start()

    def shutdown(self):
        self._stop_precompute.set()
        if self.controller is not None:
            self.controller.stop()
        if self.slo_registry is not None:
            # the shared ticker stops itself once the last facade leaves
            self.core.slo_ticker.remove(self.slo_registry)
        self.anomaly_detector.shutdown()
        if self.ledger is not None:
            self.ledger.close()

    def _precompute_loop(self):
        """Reference GoalOptimizer.run precompute loop (GoalOptimizer.java:124-175).

        The FIRST pass runs immediately: it compiles the engine for the
        live cluster shape and fills the proposal cache, so the first user
        request pays cache-hit latency instead of the cold trace+compile+
        optimize warmup."""
        allow_est = self.config.get("allow.capacity.estimation.on.proposal.precompute")
        streak_gauge = self.sensors.gauge("analyzer.precompute-consecutive-failures")
        consecutive = 0
        from cruise_control_tpu_torch.fleet.scheduler import BackgroundShedError

        while True:
            try:
                # BACKGROUND: the periodic refresh is exactly the
                # steady-state load the scheduler's shed ladder exists
                # to relieve — under overload this cycle sheds (counted
                # by the scheduler, the cached proposal keeps serving)
                # instead of crowding out urgent/interactive dispatches.
                # Pre-check BEFORE the full model build: a cycle the
                # dispatch would shed anyway must not pay the expensive
                # host flatten while the instance is saturated.
                sched = self.scheduler
                if sched is not None and sched.should_shed_background():
                    sched.shed_background(op="precompute")
                    if self._stop_precompute.wait(
                        self._proposal_expiration_ms / 2000.0
                    ):
                        return
                    continue
                self.proposals(
                    OperationProgress(),
                    ignore_cache=True,
                    allow_capacity_estimation=allow_est,
                    work_class=WorkClass.BACKGROUND,
                )
                consecutive = 0
                streak_gauge.set(0)
                self._log_compile_cache_report()
            except BackgroundShedError:
                # a shed refresh is overload protection working, not a
                # precompute failure — don't touch the failing streak
                pass
            except Exception:  # noqa: BLE001 — the loop must keep ticking,
                # but a permanently broken precompute must be VISIBLE:
                # every failure counts, and three in a row start WARN
                # logging (one line per cycle, cycles are minutes apart).
                # Gauge before counter: a reader observing the counter must
                # never see a stale (smaller) streak.
                consecutive += 1
                streak_gauge.set(consecutive)
                self.sensors.counter("analyzer.precompute-failures").inc()
                if consecutive >= 3:
                    log.warning(
                        "proposal precompute failed %d times in a row",
                        consecutive,
                        exc_info=True,
                    )
            try:
                self._prewarm_next_bucket()
            except Exception:  # noqa: BLE001 — prewarm is best-effort
                self.sensors.counter("analyzer.prewarm-failures").inc()
            if self._stop_precompute.wait(self._proposal_expiration_ms / 2000.0):
                return

    def _boot_prewarm(self):
        """Replay the boot-prewarm manifest (analyzer/prewarm.py) through
        `GoalOptimizer.prewarm`, most-recent bucket first — the ACTIVE
        bucket's programs compile before any speculation (warm-pool
        priority = manifest rank).  Each entry builds a placeholder state
        of the recorded bucket shape (+ max_rf) and reconstructs the
        recorded OptimizerConfig, so the compiled programs are exactly
        the ones the live model of that bucket will run; entries from a
        different parallel mode are skipped.  Failures are counted, never
        fatal — a failed prewarm just means that bucket pays its cold
        compile like today."""
        t0 = time.monotonic()
        enqueued = 0
        try:
            store = self.optimizer.prewarm_store
            entries = store.claim_boot_entries() if store is not None else []
            for rank, entry in enumerate(entries):
                try:
                    shape, max_rf, cfg, pmode = store.entry_engine_inputs(entry)
                    if pmode != "single":
                        continue
                    from cruise_control_tpu_torch.models.builder import prewarm_state

                    self.optimizer.prewarm(
                        prewarm_state(shape, max_rf=max_rf, device=self.device),
                        config=cfg,
                        priority=rank,
                    )
                    enqueued += 1
                    self.sensors.counter("analyzer.boot-prewarm-buckets").inc()
                except Exception:  # noqa: BLE001 — per-entry, keep replaying
                    self.sensors.counter("analyzer.boot-prewarm-failures").inc()
                    log.warning(
                        "boot prewarm of manifest entry failed", exc_info=True
                    )
            if enqueued:
                log.info(
                    "boot prewarm: %d manifest bucket(s) compiling in the "
                    "background", enqueued,
                )
        except Exception:  # noqa: BLE001 — boot must never hang on prewarm
            self.sensors.counter("analyzer.boot-prewarm-failures").inc()
            log.warning("boot prewarm failed", exc_info=True)
        finally:
            self.sensors.gauge("analyzer.boot-prewarm-seconds").set(
                round(time.monotonic() - t0, 6)
            )
            self._boot_prewarm_done.set()

    def _log_compile_cache_report(self):
        """After the first proposal pass: how many files the kernel build
        cache gained since boot (libraries built fresh) against the ones
        it held at boot, and the engine captures per bucket — the
        observable half of tpu.compile.cache.dir."""
        if self._compile_cache_reported:
            return
        from cruise_control_tpu_torch.common.compilation_cache import boot_report

        report = boot_report()
        self._compile_cache_reported = True
        if report is not None:
            log.info(
                "kernel build cache after first proposal pass: %d new "
                "entries, %d were there at boot (%s); engine captures %s",
                report["newEntries"], report["entriesAtBoot"], report["dir"],
                report["engineCaptures"],
            )

    def _prewarm_next_bucket(self):
        """Background-compile the engine for the NEXT shape bucket up.

        Shape bucketing keeps the engine warm while churn stays inside the
        current bucket; the generation that overflows it (enough partition
        creates) would pay a cold compile exactly when the cluster is
        busiest.  Pre-warming a zero-padded copy of the latest model at the
        next bucket makes that overflow hit a compiled engine instead —
        `Engine` programs never depend on the padding data, only the shape.
        """
        if not self.bucket_policy.enabled:
            return
        if self.controller is not None and self.controller.running:
            # the controller's donated in-place updates invalidate the
            # cached result's state_before buffers — padding them here
            # would read deleted arrays (LiveState ownership contract)
            return
        with self._cache_lock:
            cached = self._cache
        if cached is None:
            return
        state = cached.result.state_before
        nxt = self.bucket_policy.next_bucket_shape(state.shape)
        # cheap checks BEFORE materializing the padded model: pad_state is
        # a full device->host->device round trip of every model array, and
        # this loop re-runs every proposal_expiration/2 seconds
        if nxt == state.shape or self.optimizer.has_engine_for(nxt):
            return
        sched = self.scheduler
        if sched is not None and sched.brownout_active:
            # speculation is pure luxury: brownout lets real background
            # cycles run (reduced), but a next-bucket guess must never
            # add device/compile pressure mid-episode — shed it, counted
            sched.shed_background(op="prewarm-next-bucket")
            return
        from cruise_control_tpu_torch.models.builder import pad_state

        # speculation compiles AFTER anything the boot prewarm or a
        # request enqueued (warm-pool priority ordering): the active
        # bucket's programs must never wait behind a next-bucket guess
        from cruise_control_tpu_torch.fleet.scheduler import BackgroundShedError

        padded = pad_state(state, nxt)
        try:
            self._scheduled(
                WorkClass.BACKGROUND,
                lambda: self.optimizer.prewarm(padded, priority=100),
                op="prewarm-next-bucket",
            )
        except BackgroundShedError:
            pass  # a shed speculation is overload protection working

    # ------------------------------------------------------------------
    # proposal computation + cache (reference optimizations():276-324,493)
    # ------------------------------------------------------------------

    def _cluster_model(
        self,
        progress: OperationProgress,
        *,
        allow_capacity_estimation: bool = True,
    ) -> ClusterState:
        progress.add_step(WaitingForClusterModel())
        with self.monitor.acquire_for_model_generation():
            progress.add_step(GeneratingClusterModel())
            req = ModelCompletenessRequirements(
                min_required_num_windows=1,
                min_monitored_partitions_percentage=self.config.get(
                    "min.valid.partition.ratio"
                ),
            )
            return self.monitor.cluster_model(
                req, allow_capacity_estimation=allow_capacity_estimation
            )

    def _make_optimizer(
        self, goals: list[str], *, intra_broker: bool = False
    ) -> GoalOptimizer:
        """Ad-hoc optimizer for a custom goal list (reference builds a
        per-request goalsByPriority); carries the SAME constraint/config/
        balancedness weights as the default optimizer so a request-scoped
        knob cannot silently fall back to hardcoded defaults."""
        cfg = self.config.optimizer_config()
        if intra_broker:
            cfg = dataclasses.replace(cfg, intra_broker=True)
        return GoalOptimizer(
            chain=GoalChain.from_names(goals),
            constraint=self.constraint,
            config=cfg,
            balancedness_weights=self.balancedness_weights,
            engine_cache_size=self.config.get("tpu.engine.cache.size"),
            sensors=self.sensors,
            device=self.device,
            supervisor=self.supervisor,
            degraded_budget_s=self.config.get(
                "tpu.supervisor.degraded.greedy.budget.s"
            ),
            tracer=self.tracer,
            profiler_dir=self.profiler_dir,
        )

    def proposals(
        self,
        progress: OperationProgress,
        *,
        ignore_cache: bool = False,
        options: OptimizationOptions | None = None,
        goals: list[str] | None = None,
        allow_capacity_estimation: bool = True,
        work_class: "WorkClass | None" = None,
    ) -> OptimizerResult:
        """Cached unless options/goals are non-default
        (reference ignoreProposalCache():469).

        A request that forbids capacity estimation must not be served from a
        cache the precompute loop filled with estimation allowed (reference
        sanity-checks capacityEstimationInfoByBrokerId on cached results) —
        it bypasses the cache and builds its own model under the flag.  Its
        RESULT is still stored: a no-estimation result is strictly safer
        than an estimated one, so a no-estimation precompute loop fills the
        cache rather than discarding every cycle."""
        storable = options is None and goals is None
        servable = storable and allow_capacity_estimation
        if servable and not ignore_cache:
            cached = self._valid_cache()
            if cached is not None:
                return cached
        state = self._cluster_model(
            progress, allow_capacity_estimation=allow_capacity_estimation
        )
        if options is None:
            # config-level always-excluded topics apply to the default path
            # too (reference AnalyzerConfig
            # topics.excluded.from.partition.movement)
            options = self._build_options(state)
        optimizer = self.optimizer if goals is None else self._make_optimizer(goals)
        progress.add_step(BatchedOptimization(optimizer.config.num_rounds))
        # reference GoalOptimizer proposal-computation-timer (:116,155);
        # the histogram twin feeds /metrics with aggregatable buckets
        with self.sensors.timer("analyzer.proposal-computation-timer").time():
            # INTERACTIVE under the device scheduler (REST path) unless
            # the caller says otherwise — the periodic precompute loop
            # passes BACKGROUND so steady-state refresh anneals sit in
            # the shed ladder's background rung; a self-healing fix
            # pipeline reaching here carries an URGENT tag that upgrades
            # either default
            result = self._scheduled(
                work_class if work_class is not None else WorkClass.INTERACTIVE,
                lambda: optimizer.optimize(
                    state, options=options or OptimizationOptions()
                ),
                op="proposals",
            )
        self.sensors.histogram("analyzer.proposal-computation-seconds").observe(
            result.wall_seconds
        )
        self._record_coldstart_once()
        if storable:
            gen = self.monitor.model_generation()
            with self._cache_lock:
                self._cache = _CachedResult(
                    result,
                    int(time.time() * 1000),
                    time.monotonic(),
                    gen,
                )
            # a stored result IS a published proposal (it will serve
            # /proposals until superseded): one ledger decision record
            self._record_decision(
                result, source="optimizer", generation=gen,
                work_class=(
                    work_class.name.lower() if work_class is not None
                    else "interactive"
                ),
            )
        return result

    def publish_proposal(
        self,
        result: OptimizerResult,
        *,
        source: str = "controller",
        generation=None,
        prior_table=None,
        calibration_eligible: bool = True,
    ) -> bool:
        """Publish a freshly computed result into the proposal cache —
        the streaming controller's output path.  `generation` is the
        model generation the result was COMPUTED FROM (the controller
        captures it when it syncs its live model); omitting it falls
        back to a publish-time read, which can overstate freshness when
        a window rolls mid-anneal.  The freshest generation wins: a
        publish STRICTLY older than the cached result is dropped
        (False); same-or-newer SUPERSEDES the cached proposal — a fresher
        anneal of the same generation replaces it, so `/proposals` can
        never serve a staler result than `/state`'s ControllerState
        reports.

        `prior_table` (controller publishes) rides into the decision
        record's per-move prior-contribution features;
        `calibration_eligible=False` excludes this decision from
        calibration sampling — the controller's FIRST (cold-compile)
        publish passes it, mirroring the streaming-publish SLO exclusion,
        so a restart can never fire a spurious MODEL_DRIFT."""
        gen = generation if generation is not None else self.monitor.model_generation()
        new_key = (gen.metadata_generation, gen.load_generation)
        with self._cache_lock:
            c = self._cache
            if c is not None and c.model_generation is not None:
                old = c.model_generation
                old_key = (old.metadata_generation, old.load_generation)
                if old_key > new_key:
                    return False  # cached proposal is already fresher
            self._cache = _CachedResult(
                result,
                int(time.time() * 1000),
                time.monotonic(),
                gen,
                source=source,
            )
        # the controller replaces the precompute loop, so the first
        # published anneal is this deployment's "first proposal pass" —
        # report the persistent compile cache's hit/miss split here too
        self._log_compile_cache_report()
        self._record_coldstart_once()
        self._record_decision(
            result, source=source, generation=gen, work_class="background",
            prior_table=prior_table, calibration_eligible=calibration_eligible,
        )
        return True

    def _record_coldstart_once(self) -> None:
        """The cold-start SLO's one sample per process: facade
        construction to the first computed/published proposal, good when
        it landed inside `slo.coldstart.target.s` (the budget
        bench.py --coldstart gates)."""
        if self._coldstart_recorded or self.slo_registry is None:
            return
        self._coldstart_recorded = True
        wall = time.monotonic() - self._coldstart_t0
        self.slo_registry.record(
            "cold-start", wall <= self.config.get("slo.coldstart.target.s")
        )

    # ------------------------------------------------------------------
    # decision ledger + calibration (analyzer/ledger.py)
    # ------------------------------------------------------------------

    @staticmethod
    def _ledger_decision_id(result: OptimizerResult) -> str | None:
        """The ledger decision id a result was recorded under (stamped
        into its timing record), or None when it was never recorded."""
        for h in result.history:
            if h.get("timing"):
                return h.get("ledger_decision_id")
        return None

    def _record_decision(
        self,
        result: OptimizerResult,
        *,
        source: str,
        generation=None,
        work_class: str = "",
        prior_table=None,
        calibration_eligible: bool = True,
    ) -> str | None:
        """Append one `decision` record for a published proposal; stamps
        the ledger id into the result's timing record so a later
        execution of the same result joins its outcome.  Best-effort:
        ledger failures are counted, never surfaced to the caller."""
        led = self.ledger
        if led is None:
            return None
        try:
            import hashlib

            from cruise_control_tpu_torch.analyzer.ledger import (
                build_decision_record,
                load_summary,
            )
            from cruise_control_tpu_torch.common.trace import current_trace_id

            rec = build_decision_record(
                result,
                source=source,
                trace_id=current_trace_id(),
                cluster_id=self.cluster_id or "",
                generation=generation,
                work_class=work_class,
                config_fingerprint=hashlib.sha1(
                    repr(self.optimizer.config).encode()
                ).hexdigest()[:12],
                prior_table=prior_table,
                calibration_eligible=calibration_eligible,
            )
            did = led.record_decision(rec)
            timing = next((h for h in result.history if h.get("timing")), None)
            if timing is not None:
                timing["ledger_decision_id"] = did
            with self._ledger_lock:
                self._predictions[did] = {
                    "goal_names": list(result.goal_names),
                    "violations": [
                        float(v) for v in np.asarray(result.violations_after)
                    ],
                    "objective": float(result.objective_after),
                    "balancedness": float(result.balancedness_after),
                    "load": load_summary(result.stats_after),
                    "eligible": bool(calibration_eligible),
                }
                while len(self._predictions) > self._predictions_cap:
                    self._predictions.popitem(last=False)
            return did
        except Exception:  # noqa: BLE001 — the ledger must never fail serving
            self.sensors.counter("analyzer.ledger.errors").inc()
            log.warning("decision-ledger record failed", exc_info=True)
            return None

    def _on_execution_finished(self, info: dict) -> None:
        """Executor finish hook (PR-4 observer path): join the executed
        decision's `outcome` record and, when calibration applies, queue
        the predicted-vs-measured check for the next complete window."""
        with self._ledger_lock:
            did = self._executing_decision
            self._executing_decision = None
        if did is None or self.ledger is None:
            return
        try:
            self.ledger.record_outcome(did, dict(info))
        except Exception:  # noqa: BLE001
            self.sensors.counter("analyzer.ledger.errors").inc()
            log.warning("decision-ledger outcome failed", exc_info=True)
            return
        pred = self._predictions.get(did)
        if (
            pred is None
            or not pred.get("eligible", True)
            or not self.config.get("analyzer.calibration.enabled")
            or info.get("fencedAbort")
            or not info.get("completed")
        ):
            return
        try:
            window = self.monitor.partition_aggregator.current_window_index
        except Exception:  # noqa: BLE001 — no aggregator (bare harnesses)
            window = None
        with self._ledger_lock:
            self._pending_calibrations.append({
                "id": did,
                "window": window,
                "finished_ms": info.get("finishedMs"),
            })

    def _run_calibration_once(self) -> list[dict]:
        """Score the MEASURED cluster state for every calibration whose
        next complete metric window has rolled; append `calibration`
        records and return them.  One batched ScenarioEvaluator dispatch
        regardless of how many decisions are due (they all compare
        against the same measured state)."""
        if self.ledger is None or not self._pending_calibrations:
            return []
        try:
            cur_w = self.monitor.partition_aggregator.current_window_index
        except Exception:  # noqa: BLE001
            return []
        with self._ledger_lock:
            due = [
                e for e in self._pending_calibrations
                if cur_w is not None
                and (e["window"] is None or cur_w > e["window"])
            ]
        if not due:
            return []
        from cruise_control_tpu_torch.analyzer.ledger import (
            load_summary,
            load_summary_error,
        )
        from cruise_control_tpu_torch.analyzer.objective import balancedness_score
        from cruise_control_tpu_torch.analyzer.scenario_eval import VIOLATION_TOL

        state = self._cluster_model(OperationProgress())
        obj, viol, stats, degraded = self.scenario_evaluator.score_state(state)
        pw, sw = self.balancedness_weights
        measured = {
            "objective": round(float(obj), 6),
            "violations": [round(float(v), 6) for v in viol],
            "balancedness": round(
                balancedness_score(
                    viol, self.chain, priority_weight=pw, strictness_weight=sw
                ), 3,
            ),
            "violatedGoals": [
                n for n, v in zip(self.chain.names(), viol)
                if v > VIOLATION_TOL
            ],
            "load": load_summary(stats),
            "windowIndex": int(cur_w),
            "degraded": bool(degraded),
        }
        out = []
        for entry in due:
            did = entry["id"]
            with self._ledger_lock:
                pred = self._predictions.pop(did, None)
            if pred is None:
                continue
            pv = np.asarray(pred["violations"], np.float64)
            mv = np.asarray(measured["violations"], np.float64)
            n = min(pv.size, mv.size)
            goal_err = np.abs(mv[:n] - pv[:n])
            load_err = load_summary_error(pred["load"], measured["load"])
            rec = {
                "predicted": {
                    "objective": round(pred["objective"], 6),
                    "violations": [round(float(v), 6) for v in pv],
                    "balancedness": round(pred["balancedness"], 3),
                    "load": pred["load"],
                },
                "measured": measured,
                "error": {
                    "goalAbs": [round(float(e), 6) for e in goal_err],
                    "goalMaxAbs": round(float(goal_err.max() if n else 0.0), 6),
                    "objectiveAbs": round(
                        abs(measured["objective"] - pred["objective"]), 6
                    ),
                    "load": load_err,
                },
            }
            try:
                self.ledger.record_calibration(did, rec)
            except Exception:  # noqa: BLE001
                self.sensors.counter("analyzer.ledger.errors").inc()
                continue
            self._calibration_samples += 1
            self._last_calibration = rec["error"]
            self.sensors.counter("analyzer.calibration.samples").inc()
            self.sensors.histogram("analyzer.calibration.goal-error").observe(
                rec["error"]["goalMaxAbs"]
            )
            self.sensors.histogram("analyzer.calibration.load-error").observe(
                rec["error"]["load"].get("maxAbsAvgError", 0.0)
            )
            with self._ledger_lock:
                self._calibration_errors.append((
                    rec["error"]["goalMaxAbs"],
                    rec["error"]["load"].get("maxAbsAvgError", 0.0),
                ))
            out.append(rec)
        with self._ledger_lock:
            done = {e["id"] for e in due}
            self._pending_calibrations = [
                e for e in self._pending_calibrations if e["id"] not in done
            ]
        return out

    def _detect_model_drift(self):
        """Detector-loop hook: run due calibrations, then watch for
        SUSTAINED prediction error.  MODEL_DRIFT fires EXACTLY once per
        episode (alert-only, like OPTIMIZER_DEGRADED); the episode
        re-arms once the mean error falls back under the threshold."""
        try:
            self._run_calibration_once()
        except Exception:  # noqa: BLE001 — calibration must not kill the loop
            self.sensors.counter("analyzer.calibration.failures").inc()
            log.warning("calibration cycle failed", exc_info=True)
        min_samples = self.config.get("analyzer.calibration.drift.min.samples")
        threshold = self.config.get("analyzer.calibration.drift.threshold")
        with self._ledger_lock:
            errs = list(self._calibration_errors)[-min_samples:]
        if len(errs) < min_samples:
            return None
        mean_goal = float(np.mean([g for g, _l in errs]))
        mean_load = float(np.mean([l for _g, l in errs]))
        if mean_goal <= threshold:
            self._drift_active = False  # episode re-arms on recovery
            return None
        if self._drift_active:
            return None  # once per episode
        self._drift_active = True
        self._drift_episodes += 1
        from cruise_control_tpu_torch.detector.anomalies import ModelDrift

        return ModelDrift(
            cluster_id=self.cluster_id or "",
            samples=len(errs),
            mean_goal_error=round(mean_goal, 6),
            mean_load_error=round(mean_load, 6),
            threshold=threshold,
            episode=self._drift_episodes,
        )

    def calibration_state(self) -> dict:
        """The /fleet //state calibration block: sample counts, last
        prediction error, drift-episode state."""
        with self._ledger_lock:
            pending = len(self._pending_calibrations)
        return {
            "samples": self._calibration_samples,
            "pending": pending,
            "lastError": self._last_calibration,
            "driftActive": self._drift_active,
            "driftEpisodes": self._drift_episodes,
        }

    def ledger_entries(self, *, limit: int = 50) -> list[dict]:
        """Joined decision→outcome→calibration episodes, newest first
        (GET /ledger raw passthrough)."""
        if self.ledger is None:
            return []
        return self.ledger.entries(limit=limit)

    def explain(
        self, *, trace_id: str | None = None, decision_id: str | None = None
    ) -> dict:
        """Replay one ledger episode as a structured explanation (GET
        /explain?trace_id=|proposal=): goal deltas, top moves by
        objective contribution, the convergence curve, and — when the
        episode progressed that far — its outcome and calibration.
        Raises KeyError when nothing matches (the server's 404),
        ValueError when the ledger is disabled (400)."""
        if self.ledger is None:
            raise ValueError(
                "decision ledger disabled (analyzer.ledger.enabled, "
                "analyzer.ledger.dir)"
            )
        if not trace_id and not decision_id:
            raise ValueError("explain needs trace_id= or proposal=")
        entry = self.ledger.find(decision_id=decision_id, trace_id=trace_id)
        if entry is None:
            raise KeyError(
                f"no ledger episode for "
                f"{'proposal ' + decision_id if decision_id else 'trace ' + (trace_id or '')}"
            )
        d = entry["decision"]
        goals = d.get("goals", {})
        names = goals.get("names", [])
        before = goals.get("violationsBefore", [])
        after = goals.get("violationsAfter", [])
        out = {
            "decisionId": d.get("id"),
            "traceId": d.get("trace_id", ""),
            "cluster": d.get("cluster", ""),
            "source": d.get("source", ""),
            "workClass": d.get("workClass", ""),
            "computedMs": d.get("ms"),
            "generation": d.get("generation"),
            "bucket": d.get("bucket"),
            "degraded": bool(d.get("degraded")),
            "goalDeltas": [
                {
                    "goal": n,
                    "before": b,
                    "after": a,
                    "delta": round(float(a) - float(b), 6),
                }
                for n, b, a in zip(names, before, after)
            ],
            "objective": {
                "before": goals.get("objectiveBefore"),
                "after": goals.get("objectiveAfter"),
            },
            "balancedness": {
                "before": goals.get("balancednessBefore"),
                "after": goals.get("balancednessAfter"),
            },
            "numReplicaMovements": d.get("numReplicaMovements"),
            "numLeaderMovements": d.get("numLeaderMovements"),
            "dataToMoveMB": d.get("dataToMoveMB"),
            "topMoves": d.get("moves", []),
            "convergence": d.get("convergence"),
            "predictedLoad": d.get("predictedLoad"),
            "outcome": entry.get("outcome"),
            "calibration": entry.get("calibration"),
        }
        return out

    def _valid_cache(self) -> OptimizerResult | None:
        with self._cache_lock:
            c = self._cache
            if c is None:
                return None
            expired = (
                time.monotonic() - c.computed_mono
            ) * 1000.0 > self._proposal_expiration_ms
            if c.source == "controller":
                # controller results refresh every window roll and are
                # stamped with the generation their live model REFLECTS;
                # an unrelated model build (detector round, cache-miss
                # request) bumping the monitor's load generation must not
                # sideline them — only a TOPOLOGY change (or expiry)
                # invalidates, and the controller re-flattens and
                # republishes on exactly that signal
                stale = (
                    c.model_generation.metadata_generation
                    != self.monitor.metadata.topology().generation
                )
            else:
                stale = c.model_generation != self.monitor.model_generation()
            if expired or stale:
                self._cache = None
                return None
            return c.result

    def invalidate_proposal_cache(self):
        with self._cache_lock:
            self._cache = None

    def proposal_age_s(self) -> float:
        """Age (seconds, monotonic) of the published/cached proposal; -1
        when none is cached.  The observable half of the scheduler's
        proposal-freshness SLO (`fleet.scheduler.freshness.slo.s`):
        exported as the `analyzer.proposal-age-seconds` gauge and the
        /fleet per-cluster `proposalAgeS` field."""
        with self._cache_lock:
            c = self._cache
        if c is None:
            return -1.0
        return round(time.monotonic() - c.computed_mono, 3)

    def _scheduled(self, work_class, fn, *, op: str):
        """Run one device-dispatching body under the shared device
        scheduler (no-op passthrough when fleet.scheduler.enabled is
        off).  The effective class is the dispatch site's default
        upgraded by any ambient pipeline tag — a self-healing fix
        pipeline tags itself URGENT (scheduler.tagged), so its inner
        proposals() dispatch acquires the slot urgently while its long
        executor phase holds nothing."""
        sched = self.scheduler
        if sched is None:
            return fn()
        from cruise_control_tpu_torch.fleet.scheduler import effective_class

        return sched.run(
            effective_class(work_class), fn,
            cluster_id=self.cluster_id or "",
            op=op,
            freshness_slo_s=self._freshness_slo_s,
        )

    # ------------------------------------------------------------------
    # operations (reference servlet/handler/async/runnable/*)
    # ------------------------------------------------------------------

    def _execute(
        self,
        result: OptimizerResult,
        progress: OperationProgress,
        *,
        removed: set[int] | None = None,
        demoted: set[int] | None = None,
        extra_proposals: list[ExecutionProposal] | None = None,
        execution_overrides: dict | None = None,
    ) -> dict:
        """execution_overrides: per-request values for the concurrency caps
        and throttle (reference request-level parameters,
        servlet/parameters/ParameterUtils.java: concurrent_partition_
        movements_per_broker, concurrent_leader_movements,
        replication_throttle)."""
        progress.add_step(ExecutingProposals())
        if self.fence is not None:
            # fleet HA: only the lease holder may start an execution — a
            # degraded (read-only) facade fails the request up front with
            # FencedError instead of fencing mid-batch
            self.fence.check(op="execute")
        ov = execution_overrides or {}
        proposals = list(result.proposals) + list(extra_proposals or [])
        strategy = None
        if ov.get("replica_movement_strategies"):
            from cruise_control_tpu_torch.executor.strategy import resolve_strategy_chain

            strategy = resolve_strategy_chain(
                ov["replica_movement_strategies"], allowed=self.allowed_strategies
            )
        self._hand_catalog_to_executor()
        did = None
        claimed = False
        if self.ledger is not None:
            # the decision about to be acted on: published results carry
            # their ledger id already; a custom (never-published) result
            # is recorded now so its outcome still has a join target
            did = self._ledger_decision_id(result)
            if did is None:
                did = self._record_decision(
                    result, source="request",
                    generation=self.monitor.model_generation(),
                    work_class="interactive",
                )
            if did is not None:
                # CLAIM, never overwrite: a concurrent second execution
                # attempt (about to be rejected with OngoingExecutionError)
                # must not clobber the in-flight execution's join slot —
                # that would orphan its real outcome forever and wedge
                # ledger rotation behind the stranded pending id
                with self._ledger_lock:
                    if self._executing_decision is None:
                        self._executing_decision = did
                        claimed = True
                if claimed:
                    self.ledger.begin_outcome(did)
        try:
            out = self.executor.execute_proposals(
                proposals, self._exec_options(ov),
                removed_brokers=removed, demoted_brokers=demoted,
                strategy=strategy,
            )
        except BaseException as e:
            # the executor's finish hook did not fire (setup failure or
            # mid-batch exception outside the fenced path): the episode's
            # outcome is the error — never leave a pending join forever.
            # Only the attempt that CLAIMED the slot may write it.
            still = False
            if claimed:
                with self._ledger_lock:
                    still = self._executing_decision == did
                    if still:
                        self._executing_decision = None
            if still and self.ledger is not None:
                try:
                    self.ledger.record_outcome(did, {
                        "error": repr(e), "completed": 0, "aborted": 0,
                        "dead": 0, "stopped": False, "fencedAbort": False,
                        "reaped": 0,
                    })
                except Exception:  # noqa: BLE001
                    pass
            raise
        if self.controller is not None:
            # executed proposals are the strongest signal the learned
            # move-acceptance prior gets (controller/prior.py)
            try:
                self.controller.observe_executed(proposals)
            except Exception:  # noqa: BLE001 — prior fitting is best-effort
                log.warning("controller prior execution feedback failed",
                            exc_info=True)
        self.invalidate_proposal_cache()
        return {
            "completed": out.completed,
            "aborted": out.aborted,
            "dead": out.dead,
            "stopped": out.stopped,
        }

    def _hand_catalog_to_executor(self) -> None:
        """The executor maps proposals through the monitor's latest
        catalog, and names throttled topics by the catalog's names: a
        catalog alone would leave it naming them by their dense ids
        ("0", "1", ...), which a real cluster refuses."""
        catalog = self.monitor.last_catalog
        self.executor.catalog = catalog
        if catalog is not None:
            self.executor.topic_names.update(catalog.topic_names_by_id())

    def _execution_eta(self, result, execution_overrides: dict | None = None) -> dict:
        """Per-phase execution ETA for an optimization result.

        Derived, transparently, from data-to-move over the caps THIS
        request's execution would run with: request execution overrides
        first, then any live mid-execution /admin override, then config:
          * interBroker/intraBroker: bytes over the aggregate replication
            bandwidth (per-broker throttle x brokers moving concurrently);
            null when no throttle applies (bandwidth unknown).
          * leadership: election batches x progress-check interval.
        The reference exposes only dataToMoveMB
        (executor/ExecutionProposal.java:106-229); the ETA is this
        framework's derived convenience, with its inputs echoed under
        "assumptions" so operators can audit it.
        """
        import math

        cfg = self.config
        ov = execution_overrides or {}
        req = (
            self.executor.requested_concurrency()
            if self.executor.has_ongoing_execution
            else {}
        )
        lead_cap = ov.get("concurrent_leader_movements") or req.get(
            "leadership", cfg.get("num.concurrent.leader.movements")
        )
        interval_s = req.get(
            "interval_s", cfg.get("execution.progress.check.interval.ms") / 1000.0
        )
        throttle = self._effective_throttle(ov)  # bytes/s per broker
        leads = result.num_leadership_moves
        # brokers shipping data concurrently.  The per-broker MOVE cap does
        # not appear in the formula on purpose: under a per-BROKER byte
        # throttle, splitting a broker's bandwidth across more concurrent
        # moves does not change its aggregate egress rate.
        ps = result.proposals
        if hasattr(ps, "source_brokers"):
            src_brokers = ps.source_brokers  # columnar, no materialization
        else:
            src_brokers = {
                b for p in ps if p.has_replica_action
                for b in p.old_replicas if b not in p.new_replicas
            }
        inter_s = intra_s = None
        if throttle:
            agg_bw = float(throttle) * max(1, len(src_brokers))
            inter_s = result.data_to_move * 1024.0 * 1024.0 / agg_bw
            intra_mb = (
                ps.intra_data_to_move
                if hasattr(ps, "intra_data_to_move")
                else sum(p.intra_broker_data_to_move for p in ps)
            )
            intra_s = intra_mb * 1024.0 * 1024.0 / agg_bw if intra_mb else 0.0
        lead_s = math.ceil(leads / max(1, lead_cap)) * interval_s if leads else 0.0
        return {
            "interBrokerSeconds": round(inter_s, 1) if inter_s is not None else None,
            "intraBrokerSeconds": round(intra_s, 1) if intra_s is not None else None,
            "leadershipSeconds": round(lead_s, 1),
            # only inputs the estimate actually uses, so operators can
            # audit it
            "assumptions": {
                "replicationThrottleBytesPerSec": throttle,
                "concurrentLeaderMovements": lead_cap,
                "progressCheckIntervalSeconds": interval_s,
                "sourceBrokers": len(src_brokers),
                "dataToMoveMB": result.data_to_move,
            },
        }

    def _effective_throttle(self, ov: dict | None = None) -> float | None:
        """Replication throttle for a request: request override, else the
        configured default; non-positive values (the conventional -1 =
        'disabled') normalize to None so neither the throttle helper nor
        the ETA ever sees a bogus negative rate."""
        v = (ov or {}).get("replication_throttle")
        if v is None:
            v = self.config.get("default.replication.throttle")
        return float(v) if v is not None and v > 0 else None

    def _exec_options(self, ov: dict | None = None) -> ExecutionOptions:
        """ExecutionOptions from config + per-request overrides — ONE
        builder for every execution path (rebalance/add/remove/demote/
        RF-change), so each honors the configured caps, timeouts and
        alerting floors."""
        ov = ov or {}

        def _ov(name, default_key):
            v = ov.get(name)
            return v if v is not None else self.config.get(default_key)

        return ExecutionOptions(
            concurrent_partition_movements_per_broker=_ov(
                "concurrent_partition_movements_per_broker",
                "num.concurrent.partition.movements.per.broker",
            ),
            concurrent_intra_broker_partition_movements=self.config.get(
                "num.concurrent.intra.broker.partition.movements"
            ),
            concurrent_leader_movements=_ov(
                "concurrent_leader_movements", "num.concurrent.leader.movements"
            ),
            max_num_cluster_movements=self.config.get("max.num.cluster.movements"),
            leader_movement_timeout_s=self.config.get("leader.movement.timeout.ms")
            / 1000.0,
            inter_broker_rate_alerting_mb_s=self.config.get(
                "inter.broker.replica.movement.rate.alerting.threshold"
            ),
            intra_broker_rate_alerting_mb_s=self.config.get(
                "intra.broker.replica.movement.rate.alerting.threshold"
            ),
            replication_throttle_bytes_per_s=self._effective_throttle(ov),
            progress_check_interval_s=self.config.get(
                "execution.progress.check.interval.ms"
            )
            / 1000.0,
            task_execution_alerting_s=self.config.get(
                "task.execution.alerting.threshold.ms"
            )
            / 1000.0,
            reaper_stuck_timeout_s=(
                self.config.get("executor.reaper.stuck.timeout.s")
                if self.config.get("executor.reaper.enabled")
                else None
            ),
            adaptive_enabled=self.config.get("executor.adaptive.enabled"),
            adaptive_min_concurrency=self.config.get("executor.adaptive.min"),
            adaptive_max_concurrency=self.config.get("executor.adaptive.max"),
            adaptive_backoff_factor=self.config.get(
                "executor.adaptive.backoff.factor"
            ),
            adaptive_recover_step=self.config.get(
                "executor.adaptive.recover.step"
            ),
            adaptive_urp_slack=self.config.get("executor.adaptive.urp.slack"),
            adaptive_stall_ticks=self.config.get("executor.adaptive.stall.ticks"),
        )

    def _build_options(
        self,
        state: ClusterState,
        *,
        destination_broker_ids: list[int] | None = None,
        excluded_topics_pattern: str | None = None,
        excluded_brokers_for_replica_move: list[int] | None = None,
        excluded_brokers_for_leadership: list[int] | None = None,
    ) -> OptimizationOptions:
        """Translate request parameters into array masks
        (reference OptimizationOptions construction in RunnableUtils).

        The config-level topics.excluded.from.partition.movement pattern is
        always merged in (reference AnalyzerConfig; per-request
        excluded_topics only ever widens the exclusion)."""
        import re

        bvalid = host_array(state.broker_valid)
        n_real = int(bvalid.sum())

        def _mask(ids, *, strict: bool):
            # strict (explicitly requested brokers, e.g. add_broker
            # destinations): an unknown id must FAIL the request — silently
            # dropping it would degrade add_broker into an unconstrained
            # full-cluster rebalance.  With shape bucketing the model's
            # broker axis carries padding rows past the real brokers, so
            # "known" means broker_valid, not merely in-range.  Non-strict
            # (history-derived exclusions): the recently-removed history
            # legitimately retains brokers the shrunken model no longer
            # has — drop those.
            unknown = [
                b for b in (ids or ())
                if not (0 <= b < state.shape.B and bvalid[b])
            ]
            if strict and unknown:
                raise ValueError(
                    f"broker ids {unknown} are not in the cluster model "
                    f"(brokers 0..{n_real - 1})"
                )
            ids = [b for b in (ids or ()) if 0 <= b < state.shape.B and bvalid[b]]
            if not ids:
                return None
            m = np.zeros(state.shape.B, bool)
            m[ids] = True
            return m

        excluded_topics = None
        patterns = [
            p
            for p in (
                self.config.get("topics.excluded.from.partition.movement"),
                excluded_topics_pattern,
            )
            if p
        ]
        if patterns and self.monitor.last_catalog is not None:
            rxs = [re.compile(p) for p in patterns]
            excluded_topics = np.array(
                [
                    any(rx.fullmatch(t) for rx in rxs)
                    for t in self.monitor.last_catalog.topics
                ],
                bool,
            )

        return OptimizationOptions(
            excluded_topics=excluded_topics,
            requested_destination_brokers=_mask(destination_broker_ids, strict=True),
            excluded_brokers_for_replica_move=_mask(
                excluded_brokers_for_replica_move, strict=False
            ),
            excluded_brokers_for_leadership=_mask(
                excluded_brokers_for_leadership, strict=False
            ),
        )

    def rebalance(
        self,
        progress: OperationProgress,
        *,
        dryrun: bool = True,
        goals: list[str] | None = None,
        destination_broker_ids: list[int] | None = None,
        excluded_topics_pattern: str | None = None,
        excluded_brokers_for_replica_move: list[int] | None = None,
        excluded_brokers_for_leadership: list[int] | None = None,
        rebalance_disk: bool = False,
        allow_capacity_estimation: bool = True,
        execution_overrides: dict | None = None,
    ) -> dict:
        """Reference RebalanceRunnable.workWithoutClusterModel:116.

        rebalance_disk selects the intra-broker (JBOD) goal chain and an
        engine whose candidates move replicas between a broker's own logdirs
        (reference rebalance_disk semantics; AnalyzerConfig.java:236
        default.intra.broker.goals)."""
        custom = bool(
            destination_broker_ids or excluded_topics_pattern or goals
            or rebalance_disk or excluded_brokers_for_replica_move
            or excluded_brokers_for_leadership
        )
        if custom:
            state = self._cluster_model(
                progress, allow_capacity_estimation=allow_capacity_estimation
            )
            options = self._build_options(
                state,
                destination_broker_ids=destination_broker_ids,
                excluded_topics_pattern=excluded_topics_pattern,
                excluded_brokers_for_replica_move=excluded_brokers_for_replica_move,
                excluded_brokers_for_leadership=excluded_brokers_for_leadership,
            )
            optimizer = self.optimizer
            if rebalance_disk:
                optimizer = self._make_optimizer(
                    goals or self.config.get("intra.broker.goals"),
                    intra_broker=True,
                )
            elif goals is not None:
                optimizer = self._make_optimizer(goals)
            progress.add_step(BatchedOptimization(optimizer.config.num_rounds))
            result = self._scheduled(
                WorkClass.INTERACTIVE,
                lambda: optimizer.optimize(state, options=options),
                op="rebalance",
            )
        else:
            result = self.proposals(
                progress, allow_capacity_estimation=allow_capacity_estimation
            )
        out = result.summary()
        out["estimatedExecutionTime"] = self._execution_eta(
            result, execution_overrides
        )
        out["proposals"] = [p.to_json() for p in result.proposals[:100]]
        if not dryrun:
            out["execution"] = self._execute(
                result, progress, execution_overrides=execution_overrides
            )
        return out

    def add_brokers(self, progress: OperationProgress, broker_ids: list[int], *,
                    dryrun: bool = True, execution_overrides: dict | None = None) -> dict:
        """Reference AddBrokersRunnable: only move replicas TO the new brokers."""
        return self.rebalance(
            progress, dryrun=dryrun, destination_broker_ids=broker_ids,
            execution_overrides=execution_overrides,
        )

    def remove_brokers(self, progress: OperationProgress, broker_ids: list[int], *,
                       dryrun: bool = True, execution_overrides: dict | None = None) -> dict:
        """Reference RemoveBrokersRunnable: evacuate the given brokers."""
        state = self._cluster_model(progress)
        state = _mark_brokers_dead(state, broker_ids)
        progress.add_step(BatchedOptimization(self.optimizer.config.num_rounds))
        dest_mask = np.ones(state.shape.B, bool)
        dest_mask[list(broker_ids)] = False
        options = OptimizationOptions(
            excluded_brokers_for_replica_move=~dest_mask,
            excluded_brokers_for_leadership=~dest_mask,
        )
        result = self._scheduled(
            WorkClass.INTERACTIVE,
            lambda: self.optimizer.optimize(state, options=options),
            op="remove_brokers",
        )
        out = result.summary()
        out["estimatedExecutionTime"] = self._execution_eta(
            result, execution_overrides
        )
        if not dryrun:
            out["execution"] = self._execute(
                result, progress, removed=set(broker_ids),
                execution_overrides=execution_overrides,
            )
        return out

    def demote_brokers(self, progress: OperationProgress, broker_ids: list[int], *,
                       dryrun: bool = True) -> dict:
        """Reference DemoteBrokerRunnable: move leadership (only) off brokers."""
        state = self._cluster_model(progress)
        proposals = _demotion_proposals(state, set(broker_ids), self.monitor.last_catalog)
        out = {
            "numLeaderMovements": len(proposals),
            "proposals": [p.to_json() for p in proposals[:100]],
        }
        if not dryrun and proposals:
            if self.fence is not None:
                self.fence.check(op="execute")
            self._hand_catalog_to_executor()
            progress.add_step(ExecutingProposals())
            r = self.executor.execute_proposals(
                proposals, self._exec_options(), demoted_brokers=set(broker_ids)
            )
            out["execution"] = {"completed": r.completed, "dead": r.dead}
        return out

    def fix_offline_replicas(self, progress: OperationProgress, *, dryrun: bool = True) -> dict:
        """Reference FixOfflineReplicasRunnable — the OfflineReplicaGoal
        drives evacuation of dead brokers/disks during a normal optimize."""
        result = self.proposals(progress, ignore_cache=True)
        out = result.summary()
        out["estimatedExecutionTime"] = self._execution_eta(result)
        out["proposals"] = [p.to_json() for p in result.proposals[:100]]
        if not dryrun:
            out["execution"] = self._execute(result, progress)
        return out

    def update_topic_replication_factor(
        self, progress: OperationProgress, topic_rf: dict[str, int], *, dryrun: bool = True
    ) -> dict:
        """Reference UpdateTopicConfigurationRunnable (RF change)."""
        state = self._cluster_model(progress)
        proposals = _rf_change_proposals(state, topic_rf, self.monitor.last_catalog)
        out = {
            "numProposals": len(proposals),
            "proposals": [p.to_json() for p in proposals[:100]],
        }
        if not dryrun and proposals:
            if self.fence is not None:
                self.fence.check(op="execute")
            self._hand_catalog_to_executor()
            progress.add_step(ExecutingProposals())
            r = self.executor.execute_proposals(proposals, self._exec_options())
            out["execution"] = {"completed": r.completed, "dead": r.dead}
        return out

    # ------------------------------------------------------------------
    # scenario planner (read-only what-if analysis; planner/)
    # ------------------------------------------------------------------

    def simulate(
        self,
        progress: OperationProgress,
        scenarios,
        *,
        optimize: bool | None = None,
        allow_capacity_estimation: bool = True,
    ) -> dict:
        """Batch-evaluate what-if scenarios against the live model
        (POST /simulate).  `scenarios`: planner.scenario.Scenario list (the
        parameter layer parses the JSON).  Never touches the cluster."""
        from cruise_control_tpu_torch.planner.scenario import Scenario

        t0 = time.monotonic()
        if optimize is None:
            optimize = self.config.get("planner.simulate.optimize.default")
        scenarios = list(scenarios)
        if len(scenarios) > self.config.get("planner.max.scenarios"):
            raise ValueError(
                f"{len(scenarios)} scenarios exceed planner.max.scenarios="
                f"{self.config.get('planner.max.scenarios')}"
            )
        state = self._cluster_model(
            progress, allow_capacity_estimation=allow_capacity_estimation
        )
        if optimize:
            progress.add_step(
                BatchedOptimization(self.optimizer.config.num_rounds)
            )
        with self.sensors.timer("planner.simulate-timer").time(), self.tracer.span(
            "planner.simulate",
            component="planner",
            scenarios=len(scenarios),
            optimize=bool(optimize),
        ) as sp:
            # the identity scenario rides the SAME batch so "vs today" in
            # the response cannot drift from the mutated states' scoring;
            # its optimize flag is False — the response never serializes a
            # baseline fix, so annealing it would be a wasted full anneal
            outcomes = self._scheduled(
                WorkClass.INTERACTIVE,
                lambda: self.scenario_evaluator.evaluate(
                    state,
                    [Scenario(name="__baseline__")] + scenarios,
                    self.monitor.last_catalog,
                    optimize=[False] + [bool(optimize)] * len(scenarios),
                    bucket=self.bucket_policy,
                ),
                op="simulate",
            )
            sp.set(degraded=any(o.degraded for o in outcomes))
        base, rest = outcomes[0], outcomes[1:]
        return {
            "scenarios": [o.to_json() for o in rest],
            "baseline": {
                "objective": base.objective,
                "violatedGoals": list(base.violated_goals),
                "balancedness": base.balancedness,
                "brokersAlive": base.brokers_alive,
            },
            "degraded": any(o.degraded for o in outcomes),
            "wallSeconds": round(time.monotonic() - t0, 3),
        }

    def _forecast_scenario(self, horizon_ms: int):
        """Load Scenario at `horizon_ms` from the partition aggregator's
        windowed history; None when too little history exists to trend."""
        from cruise_control_tpu_torch.planner.forecast import LoadForecaster

        try:
            history = self.monitor.partition_aggregator.history_snapshot()
        except ValueError:
            return None
        forecaster = LoadForecaster(
            method=self.config.get("planner.forecast.method"),
            min_windows=self.config.get("planner.forecast.min.windows"),
            max_factor=self.config.get("planner.forecast.max.factor"),
        )
        catalog = self.monitor.last_catalog
        trends = forecaster.fit(
            history,
            self.monitor.partition_aggregator.metric_def,
            catalog.topic_names_by_id() if catalog is not None else None,
        )
        if not trends:
            return None
        return forecaster.scenario_at(
            trends, horizon_ms, history.window_ms, name=f"forecast+{horizon_ms}ms"
        )

    def rightsize(
        self,
        progress: OperationProgress,
        *,
        horizon_ms: int | None = None,
        min_brokers: int | None = None,
        max_broker_factor: float | None = None,
        allow_capacity_estimation: bool = True,
    ) -> dict:
        """Minimum brokers satisfying all hard goals (GET /rightsize) —
        Cruise Control's ProvisionStatus, answered by a monotone what-if
        search.  With `horizon_ms`, the verdict is ALSO computed under the
        forecast load at that horizon and reported under `forecast`."""
        state = self._cluster_model(
            progress, allow_capacity_estimation=allow_capacity_estimation
        )
        progress.add_step(BatchedOptimization(self.optimizer.config.num_rounds))
        rs = self.rightsizer
        if min_brokers is not None or max_broker_factor is not None:
            from cruise_control_tpu_torch.planner.rightsizer import Rightsizer

            rs = Rightsizer(
                self.scenario_evaluator,
                min_brokers=min_brokers if min_brokers is not None else rs.min_brokers,
                max_broker_factor=(
                    max_broker_factor
                    if max_broker_factor is not None
                    else rs.max_broker_factor
                ),
                bucket=self.bucket_policy,
                sensors=self.sensors,
            )
        max_anneals = self.config.get("planner.rightsize.max.anneals")
        catalog = self.monitor.last_catalog
        with self.tracer.span("planner.rightsize", component="planner") as sp:
            out = self._scheduled(
                WorkClass.INTERACTIVE,
                lambda: rs.rightsize(state, catalog, max_anneals=max_anneals),
                op="rightsize",
            )
            sp.set(
                status=out.get("provisionStatus"),
                anneals=out.get("annealsRun"),
                min_brokers=out.get("minBrokers"),
            )
        # trend outlook at the CONFIGURED horizons (planner.forecast.
        # horizons.ms): the fitted per-topic scale factors, no extra
        # anneals — the full forecast VERDICT still needs an explicit
        # horizon_ms (a search per horizon is an operator's choice to pay)
        outlook = []
        for h in self.config.get("planner.forecast.horizons.ms"):
            sc = self._forecast_scenario(int(h))
            if sc is not None:
                outlook.append({"horizonMs": int(h), "scenario": sc.to_json()})
        out["forecastOutlook"] = outlook
        if horizon_ms is not None:
            load_sc = self._forecast_scenario(horizon_ms)
            if load_sc is None:
                out["forecast"] = {
                    "horizonMs": horizon_ms,
                    "error": "not enough windowed history to fit a trend",
                }
            else:
                fc = self._scheduled(
                    WorkClass.INTERACTIVE,
                    lambda: rs.rightsize(
                        state, catalog, load_scenario=load_sc,
                        max_anneals=max_anneals,
                    ),
                    op="rightsize-forecast",
                )
                fc["horizonMs"] = horizon_ms
                out["forecast"] = fc
        return out

    def stop_proposal_execution(self, *, force: bool = False) -> dict:
        self.executor.stop_execution(force=force)
        return {"message": "execution stop requested", "force": force}

    # ------------------------------------------------------------------
    # state (reference STATE endpoint aggregating all substates)
    # ------------------------------------------------------------------

    def state(self, substates: list[str] | None = None) -> dict:
        substates = [
            s.lower()
            for s in (
                substates
                or ["monitor", "executor", "analyzer", "controller",
                    "anomaly_detector", "sensors"]
            )
        ]
        out: dict = {"version": 1}
        if "sensors" in substates:
            # reference publishes these via JMX (KafkaCruiseControlApp.java:39-41,
            # docs/wiki/User Guide/Sensors.md); here they ride the /state JSON
            out["Sensors"] = self.sensors.snapshot()
        if "monitor" in substates:
            out["MonitorState"] = self.monitor.monitor_state()
            runner = getattr(self, "task_runner", None)
            if runner is not None:
                out["MonitorState"]["trainingState"] = runner.regression.state()
                out["MonitorState"]["bootstrapProgressPct"] = runner.state()[
                    "bootstrapProgressPct"
                ]
        if "executor" in substates:
            out["ExecutorState"] = self.executor.executor_state()
        if "analyzer" in substates:
            with self._cache_lock:
                cache = self._cache
            out["AnalyzerState"] = {
                "isProposalReady": cache is not None,
                "readyGoals": self.chain.names() if cache is not None else [],
                "goalReadiness": self.chain.names(),
                # which pipeline filled the cached proposal: "optimizer"
                # (request/precompute) or "controller" (streaming publish)
                "proposalSource": cache.source if cache is not None else None,
                # degraded-serving surface (supervised optimizer runtime):
                # degraded=true means proposals are currently CPU-greedy
                # because the device breaker is not closed
                "degraded": self.supervisor is not None
                and self.supervisor.is_degraded,
                # per-bucket cumulative cold-start bill (compile + first
                # run); the /metrics collector mirrors coldWallSeconds
                "compileAttribution": self.optimizer.compile_attribution(),
            }
            if self.supervisor is not None:
                # includes deviceHealth: latest per-device probe verdicts
                # from mesh attribution fan-outs (which chip, not just
                # which slice)
                out["AnalyzerState"]["supervisor"] = self.supervisor.state_json()
            mesh_ft = getattr(self.optimizer, "_mesh_ft", None)
            if mesh_ft is not None:
                out["AnalyzerState"]["meshFt"] = mesh_ft.state_json()
            if self.ledger is not None:
                # decision ledger + predicted-vs-measured calibration
                # (analyzer/ledger.py; full episodes on GET /ledger)
                out["AnalyzerState"]["ledger"] = self.ledger.state_json()
                out["AnalyzerState"]["calibration"] = self.calibration_state()
        if "controller" in substates and self.controller is not None:
            out["ControllerState"] = self.controller.state_json()
        if "anomaly_detector" in substates:
            out["AnomalyDetectorState"] = self.anomaly_detector.detector_state()
        return out


class SelfHealingAdapter:
    """detector.SelfHealingActions implementation over the facade — anomaly
    fixes run through the exact user-operation paths (reference: anomaly fix
    constructors of the runnables)."""

    def __init__(self, cc: CruiseControl):
        self.cc = cc
        #: last non-busy fix failure: surfaced by detector_state() so an
        #: operator reading /state sees WHY self-healing is not healing
        self.last_fix_failure: dict | None = None

    @property
    def fix_failure_info(self) -> dict | None:
        return self.last_fix_failure

    def _guarded(self, fn, *, op: str) -> bool:
        """Run one self-healing fix; False means it did not start.

        Busy executor is the EXPECTED no (the detector re-checks later)
        and stays silent.  Everything else used to be swallowed
        indistinguishably — now it is logged with the traceback, counted
        (`self-healing.fix-failed`), and kept as last-failure info.

        Under the device scheduler every fix pipeline is tagged URGENT:
        a broker-failure / EXECUTION_STUCK / lease-takeover re-anneal's
        engine dispatch preempts whatever background slice holds the
        device (never shed, never 429'd), while the pipeline's long
        executor phase — which dispatches nothing — holds no slot."""
        try:
            if self.cc.scheduler is not None:
                from cruise_control_tpu_torch.fleet.scheduler import tagged

                with tagged(WorkClass.URGENT):
                    fn()
            else:
                fn()
            return True
        except OngoingExecutionError:
            return False
        except Exception as e:  # noqa: BLE001 — fix failure is reported, not fatal
            self.cc.sensors.counter("self-healing.fix-failed").inc()
            self.last_fix_failure = {
                "operation": op,
                "error": repr(e),
                "ms": int(time.time() * 1000),
            }
            log.warning("self-healing fix %s failed to start", op, exc_info=True)
            return False

    def _healing_kwargs(self) -> dict:
        """Self-healing runs with its own goal list and keeps replicas and
        leadership off recently removed/demoted brokers (reference
        AnomalyDetectorConfig self.healing.goals +
        self.healing.exclude.recently.{removed,demoted}.brokers)."""
        cfg = self.cc.config
        kwargs: dict = {}
        healing_goals = cfg.get("self.healing.goals")
        if healing_goals:
            kwargs["goals"] = healing_goals
        ex = self.cc.executor
        if cfg.get("self.healing.exclude.recently.removed.brokers"):
            removed = sorted(ex.removed_brokers)
            if removed:
                kwargs["excluded_brokers_for_replica_move"] = removed
        if cfg.get("self.healing.exclude.recently.demoted.brokers"):
            demoted = sorted(ex.demoted_brokers)
            if demoted:
                kwargs["excluded_brokers_for_leadership"] = demoted
        return kwargs

    def rebalance(self, reason: str) -> bool:
        return self._guarded(
            lambda: self.cc.rebalance(
                OperationProgress(), dryrun=False, **self._healing_kwargs()
            ),
            op="rebalance",
        )

    def remove_brokers(self, broker_ids, reason: str) -> bool:
        # destructive-removal guard (reference AnomalyDetectorConfig
        # fixable.failed.broker.{count,percentage}.threshold:138-147): when
        # too much of the cluster is implicated the anomaly is not fixable
        # by removal and a human must intervene
        cfg = self.cc.config
        ids = list(broker_ids)
        if len(ids) > cfg.get("fixable.failed.broker.count.threshold"):
            return False
        try:
            total = len(self.cc.admin.topology().brokers)
        except Exception:  # noqa: BLE001 — unknown size: fall back to count gate
            total = 0
        if total and len(ids) / total > cfg.get(
            "fixable.failed.broker.percentage.threshold"
        ):
            return False
        return self._guarded(
            lambda: self.cc.remove_brokers(OperationProgress(), ids, dryrun=False),
            op="remove_brokers",
        )

    def demote_brokers(self, broker_ids, reason: str) -> bool:
        return self._guarded(
            lambda: self.cc.demote_brokers(OperationProgress(), list(broker_ids), dryrun=False),
            op="demote_brokers",
        )

    def fix_offline_replicas(self, reason: str) -> bool:
        return self._guarded(
            lambda: self.cc.fix_offline_replicas(OperationProgress(), dryrun=False),
            op="fix_offline_replicas",
        )

    def fix_topic_replication_factor(self, topics, target_rf: int, reason: str) -> bool:
        return self._guarded(
            lambda: self.cc.update_topic_replication_factor(
                OperationProgress(), {t: target_rf for t in topics}, dryrun=False
            ),
            op="fix_topic_replication_factor",
        )

    @property
    def is_busy(self) -> bool:
        return self.cc.executor.has_ongoing_execution


# ----------------------------------------------------------------------
# host-side proposal builders
# ----------------------------------------------------------------------


def host_array(t) -> np.ndarray:
    """A host numpy copy of one of a model's tensors (arrays pass)."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _mark_brokers_dead(state: ClusterState, broker_ids: list[int]) -> ClusterState:
    """The state with `broker_ids` dead and their replicas offline; the
    masks are built with torch on the state's device.  Ids index the
    broker axis as numpy does (an id out of range raises IndexError)."""
    dev = state.device
    rows = np.arange(state.broker_alive.shape[0])[list(broker_ids)]
    alive = state.broker_alive.clone()
    alive[torch.as_tensor(rows, dtype=torch.int64, device=dev)] = False
    ids = torch.as_tensor(list(broker_ids), dtype=state.replica_broker.dtype, device=dev)
    offline = state.replica_offline | torch.isin(state.replica_broker, ids)
    return dataclasses.replace(
        state,
        broker_alive=alive,
        replica_offline=offline & state.replica_valid,
    )


def _demotion_proposals(state: ClusterState, demoted: set[int], catalog) -> list[ExecutionProposal]:
    """Leadership-only proposals moving leaders off demoted brokers
    (reference DemoteBrokerRunnable + PreferredLeaderElectionGoal)."""
    valid = host_array(state.replica_valid)
    part = host_array(state.replica_partition)
    brk = host_array(state.replica_broker)
    lead = host_array(state.replica_is_leader)
    pos = host_array(state.replica_pos)
    alive = host_array(state.broker_alive)
    topic = host_array(state.replica_topic)
    proposals = []
    for p in np.unique(part[valid & lead & np.isin(brk, list(demoted))]):
        rows = np.nonzero(valid & (part == p))[0]
        rows = rows[np.argsort(pos[rows])]
        old_leader = int(brk[rows[lead[rows]]][0])
        candidates = [
            int(brk[r]) for r in rows if int(brk[r]) not in demoted and alive[brk[r]]
        ]
        if not candidates:
            continue
        new_leader = candidates[0]
        replicas = tuple(int(brk[r]) for r in rows)
        proposals.append(
            ExecutionProposal(
                partition=int(p),
                topic=int(topic[rows[0]]),
                old_leader=old_leader,
                new_leader=new_leader,
                old_replicas=replicas,
                new_replicas=replicas,
            )
        )
    return proposals


def _rf_change_proposals(
    state: ClusterState, topic_rf: dict[str, int], catalog
) -> list[ExecutionProposal]:
    """Replication-factor change proposals: grow rack-aware onto the least
    loaded brokers, shrink by dropping the most loaded non-leader replicas
    (reference TopicReplicationFactorAnomalyFinder fix semantics)."""
    from cruise_control_tpu_torch.common.resources import Resource

    valid = host_array(state.replica_valid)
    part = host_array(state.replica_partition)
    brk = host_array(state.replica_broker)
    lead = host_array(state.replica_is_leader)
    topic = host_array(state.replica_topic)
    rack = host_array(state.broker_rack)
    alive = host_array(state.broker_alive) & host_array(state.broker_valid)
    load = np.zeros(state.shape.B)
    eff = host_array(state.replica_load_leader)[:, Resource.DISK]
    for r in np.nonzero(valid)[0]:
        load[brk[r]] += eff[r]

    name_to_tid = {name: i for i, name in enumerate(catalog.topics)} if catalog else {}
    proposals = []
    for tname, target in topic_rf.items():
        tid = name_to_tid.get(tname)
        if tid is None:
            continue
        for p in np.unique(part[valid & (topic == tid)]):
            rows = np.nonzero(valid & (part == p))[0]
            replicas = [int(brk[r]) for r in rows]
            leader_rows = rows[lead[rows]]
            leader = int(brk[leader_rows[0]]) if leader_rows.size else replicas[0]
            new = list(replicas)
            if len(new) < target:
                used_racks = {int(rack[b]) for b in new}
                candidates = sorted(
                    (b for b in np.nonzero(alive)[0] if int(b) not in new),
                    key=lambda b: (int(rack[b]) in used_racks, load[b]),
                )
                for b in candidates[: target - len(new)]:
                    new.append(int(b))
                    used_racks.add(int(rack[b]))
            elif len(new) > target:
                droppable = sorted(
                    (b for b in new if b != leader), key=lambda b: -load[b]
                )
                for b in droppable[: len(new) - target]:
                    new.remove(b)
            if set(new) != set(replicas):
                proposals.append(
                    ExecutionProposal(
                        partition=int(p),
                        topic=tid,
                        old_leader=leader,
                        new_leader=leader,
                        old_replicas=tuple(replicas),
                        new_replicas=tuple([leader] + [b for b in new if b != leader]),
                    )
                )
    return proposals
