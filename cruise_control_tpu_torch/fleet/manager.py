"""Fleet controller: one service instance monitoring, rebalancing and
rightsizing N Kafka clusters.

The economics (ROADMAP item 4): the EXPENSIVE resources — the TPU, the
compiled engines, the DeviceSupervisor's breaker — are shared through one
`service.facade.AnalyzerCore`; the CHEAP ones — load monitors, executors
with their durable journals, detectors, sample streams — multiply per
cluster.  Shape buckets (PR 2) make the sharing real: clusters whose
bucketed model shapes coincide rebind the SAME compiled engine
(`analyzer.engine-cache-*` counters on the core registry prove it), and
same-bucket clusters are scored in one batched device dispatch through
the ScenarioEvaluator (`score_clusters`).

Ownership map:

  shared (AnalyzerCore, one per instance)    per cluster (ClusterContext)
  ----------------------------------------  ---------------------------------
  GoalChain + BalancingConstraint            LoadMonitor + aggregators
  GoalOptimizer (compiled-engine LRU)        Executor (+ journal under
  DeviceSupervisor (one circuit breaker)       <executor.journal.dir>/<id>/)
  ScenarioEvaluator / Rightsizer             AnomalyDetector + notifier
  Tracer store (per-cluster component        proposal cache + precompute loop
    namespaces ride Tracer.scoped)           SensorRegistry({cluster: <id>})

Admission control: the REST layer enforces `fleet.tenant.max.pending.tasks`
per cluster on the async user-task purgatory (429 + the cluster's
`fleet.tenant-rejections` counter on breach), so one noisy cluster cannot
starve the other clusters' proposal refreshes out of the shared pool.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


def shared_core_rollup(core, *, tenant_max_pending: int = 0) -> dict:
    """The `shared` block of the GET /fleet payload — one builder for the
    fleet and the single-cluster synthetic rollup (service/server.py), so
    the two deployments can't drift apart field by field."""
    opt = core.optimizer
    out: dict = {
        "compiledEngines": opt.cache_size,
        "engineCacheHits": opt.engine_cache_hits,
        "engineCacheMisses": opt.engine_cache_misses,
        "degraded": core.supervisor is not None and core.supervisor.is_degraded,
        "tenantMaxPendingTasks": tenant_max_pending,
    }
    if core.supervisor is not None:
        out["supervisor"] = core.supervisor.state_json()
    if getattr(core, "scheduler", None) is not None:
        # QoS-aware device scheduler (fleet/scheduler.py): queue depths,
        # shed/brownout ladder state, per-class wait quantiles
        out["scheduler"] = core.scheduler.state_json()
    return out


class ClusterContext:
    """Everything ONE cluster owns inside a fleet: its facade (which holds
    the monitor, executor, journal, detector) plus the sampling stack that
    feeds it."""

    def __init__(self, cluster_id: str, cc, *, fetcher=None, task_runner=None):
        self.cluster_id = cluster_id
        self.cc = cc
        self.fetcher = fetcher
        self.task_runner = task_runner
        #: lifecycle flags (fleet HA): `started` once cc.start_up ran
        #: (gated on lease acquisition when HA is on); `degraded` while
        #: the cluster serves read-only after a lease loss
        self.started = False
        self.degraded = False
        #: serializes activations (acquire -> activate runs off the
        #: heartbeat thread; a rapid lose/re-acquire must not interleave
        #: two activations of the same cluster)
        import threading

        self.lifecycle_lock = threading.Lock()
        #: consecutive activation failures (drives the relinquish
        #: backoff so a persistently failing activation flaps slowly)
        self.activation_failures = 0

    def rollup(self) -> dict:
        """Cheap per-cluster state summary for the GET /fleet rollup (no
        model build, no device work)."""
        cc = self.cc
        out = {
            "proposalReady": cc._valid_cache() is not None,
            # age of the published proposal (seconds; -1 = none) — the
            # observable the scheduler's freshness SLO
            # (fleet.scheduler.freshness.slo.s) is enforced against
            "proposalAgeS": cc.proposal_age_s(),
            "hasOngoingExecution": cc.executor.has_ongoing_execution,
            "executorState": cc.executor.executor_state().get("state"),
            "modelGeneration": str(cc.monitor.model_generation()),
            "selfHealingBusy": cc.actions.is_busy,
        }
        if cc.controller is not None:
            # per-cluster streaming controller (each facade builds its own
            # from its cluster config; the fleet start_up fans them out)
            out["controller"] = {
                "running": cc.controller.running,
                "windowRolls": cc.controller.state_json()["windowRolls"],
            }
            hist = cc.sensors.get(
                "controller.window-roll-to-publish-seconds"
            )
            if hist is not None and hist.count:
                # the streaming hot path's headline latency (ROADMAP item
                # 4's p99 target), estimated from the exportable buckets
                out["controller"]["windowRollToPublishSeconds"] = {
                    "count": hist.count,
                    "p50": round(hist.quantile(0.5), 6),
                    "p99": round(hist.quantile(0.99), 6),
                }
        if cc.slo_registry is not None:
            # burn-rate summary per SLO (full detail on GET /slo)
            out["slo"] = cc.slo_registry.summary_json()
        if cc.ledger is not None:
            # decision ledger + predicted-vs-measured calibration
            # (analyzer/ledger.py; raw episodes on GET /ledger)
            out["ledger"] = cc.ledger.state_json()
            out["calibration"] = cc.calibration_state()
        recovery = cc.executor.recovery_info()
        if recovery is not None:
            out["recovered"] = True
        return out


class FleetManager:
    """Owns the cluster contexts and the shared core; the REST layer
    resolves `cluster=` through it and serves GET /fleet from it."""

    def __init__(self, core, contexts: dict[str, ClusterContext], *,
                 sensors, config, lease_manager=None):
        """core: the shared service.facade.AnalyzerCore every context's
        facade was built over; sensors: the fleet-level (unlabeled)
        registry — normally the same one the core registers into.

        lease_manager (fleet HA, fleet/leases.py): when set, cluster
        contexts start ONLY after this instance acquires their lease —
        monitor, controller, detector, executor and the PR-4 recovery
        resume all gate on ownership — and a lost lease steps the
        cluster down to read-only degraded mode (executor force-stopped,
        FLEET_LEASE_LOST raised through the detector/notifier)."""
        self.core = core
        self.contexts = dict(contexts)
        self.sensors = sensors
        self.config = config
        self.tenant_max_pending = config.get("fleet.tenant.max.pending.tasks")
        self.lease_manager = lease_manager
        self._start_kwargs: dict = {}
        if lease_manager is not None:
            lease_manager.on_acquired = self._on_lease_acquired
            lease_manager.on_lost = self._on_lease_lost
        sensors.gauge("fleet.clusters", lambda: len(self.contexts))

    # ------------------------------------------------------------- lookup

    def cluster_ids(self) -> list[str]:
        return list(self.contexts)

    def cluster(self, cluster_id: str) -> ClusterContext:
        ctx = self.contexts.get(cluster_id)
        if ctx is None:
            raise KeyError(
                f"unknown cluster {cluster_id!r}; clusters: {self.cluster_ids()}"
            )
        return ctx

    def facade(self, cluster_id: str):
        return self.cluster(cluster_id).cc

    def registries(self) -> list:
        """Every sensor registry of the instance, shared core first — the
        `/metrics` exposition renders them together, each cluster's
        samples labeled by its registry's base_labels."""
        regs = [self.sensors]
        if self.core.sensors is not self.sensors:
            regs.append(self.core.sensors)
        regs.extend(ctx.cc.sensors for ctx in self.contexts.values())
        return regs

    # ---------------------------------------------------------- lifecycle

    def start_up(self, *, detection_interval_s: float | None = None,
                 precompute: bool = False) -> None:
        """Start every cluster's monitor/detector (and recovery resume +
        precompute loop) — the fleet twin of CruiseControl.start_up.

        With a lease manager attached (fleet HA) nothing starts here:
        the heartbeat acquires leases in the background and
        _on_lease_acquired activates each cluster the moment this
        instance owns it."""
        self._start_kwargs = dict(
            detection_interval_s=detection_interval_s, precompute=precompute
        )
        if self.lease_manager is not None:
            self.lease_manager.start()
            return
        for ctx in self.contexts.values():
            ctx.cc.start_up(
                detection_interval_s=detection_interval_s, precompute=precompute
            )
            ctx.started = True

    def shutdown(self) -> None:
        if self.lease_manager is not None:
            # release held leases FIRST so a peer can take over without
            # waiting out the TTL
            self.lease_manager.stop()
        for ctx in self.contexts.values():
            try:
                ctx.cc.shutdown()
            except Exception:  # noqa: BLE001 — one cluster must not wedge the rest
                log.warning(
                    "shutdown of cluster %s failed", ctx.cluster_id, exc_info=True
                )

    # ------------------------------------------------------ fleet HA

    def _on_lease_acquired(self, cluster_id: str, lease, takeover: bool) -> None:
        """Lease heartbeat callback: this instance now owns the cluster.
        Activation runs on its OWN thread — reconciliation against a
        slow/unreachable admin must not stall the heartbeat and cost the
        instance its OTHER clusters' renewals."""
        import threading

        threading.Thread(
            target=self._activate_cluster,
            args=(cluster_id, lease, takeover),
            daemon=True,
            name=f"fleet-activate-{cluster_id}",
        ).start()

    def _activate_cluster(self, cluster_id: str, lease, takeover: bool) -> None:
        """Runs PR-4 restart reconciliation against the (shared)
        namespaced journal — on a takeover that is the DEAD holder's
        journal — then starts (or, after a loss/re-acquire cycle,
        resumes) the cluster's subsystems.  The fence was granted before
        this runs, so every admin call here is already fenced-in."""
        import time as _time

        ctx = self.cluster(cluster_id)
        cc = ctx.cc
        lm = self.lease_manager
        with ctx.lifecycle_lock:
            # a same-holder re-acquire can land while the previous fenced
            # abort is still winding down (the force-stopped loop exits on
            # its next tick) — wait it out so reconciliation is never
            # silently skipped, leaving the abort's throttle unswept
            deadline = _time.monotonic() + 60.0
            while (
                cc.executor.has_ongoing_execution
                and _time.monotonic() < deadline
                and lm.owns(cluster_id)
            ):
                _time.sleep(0.1)
            try:
                if not cc.executor.has_ongoing_execution:
                    # replays the journal, sweeps leaked throttles,
                    # reconciles in-flight moves; prunes journal archives
                    cc.executor.reconcile_journal()
                else:
                    log.warning(
                        "skipping journal reconciliation of %s: an "
                        "execution is still winding down", cluster_id,
                    )
            except Exception:  # noqa: BLE001 — reconciliation failure must
                # not forfeit the lease; the executor stays idle and logs
                log.warning(
                    "journal reconciliation of %s failed on lease "
                    "acquisition", cluster_id, exc_info=True,
                )
            try:
                if not ctx.started:
                    cc.start_up(**self._start_kwargs)  # resumes recovery
                    ctx.started = True
                elif cc.executor.has_recovered_execution:
                    cc.resume_recovered_async()
                ctx.activation_failures = 0
            except Exception:  # noqa: BLE001 — an activation failure must
                # not strand the cluster leased-but-unserved forever: give
                # the lease back so the next heartbeat (ours or a healthy
                # peer's) acquires and retries activation, backing OUR
                # retries off exponentially so a persistent failure flaps
                # slowly instead of every renew beat
                ctx.activation_failures += 1
                cooldown = min(300.0, lm.renew_s * 2 ** ctx.activation_failures)
                log.warning(
                    "activation of %s failed (attempt %d) — relinquishing "
                    "its lease, retrying in >= %.1fs",
                    cluster_id, ctx.activation_failures, cooldown,
                    exc_info=True,
                )
                ctx.degraded = True
                lm.relinquish(cluster_id, cooldown_s=cooldown)
                return
            # the lease may have been lost again while activation ran —
            # degraded must reflect the CURRENT ownership, not the state
            # at acquisition
            ctx.degraded = not lm.owns(cluster_id)
        log.info(
            "cluster %s activated (epoch %d%s)",
            cluster_id, lease.epoch, ", takeover" if takeover else "",
        )

    def _on_lease_lost(self, cluster_id: str, lease) -> None:
        """Lease heartbeat callback: ownership is gone (missed renewals
        past skew slack, or a peer took over).  Step the cluster down to
        read-only degraded mode: the executor halts mid-batch via the
        existing force-stop path (its fenced admin/journal calls raise
        anyway — this just makes the halt immediate), proposals//state//
        /fleet keep serving, and FLEET_LEASE_LOST flows through the
        detector/notifier so operators hear about it."""
        ctx = self.cluster(cluster_id)
        ctx.degraded = True
        cc = ctx.cc
        try:
            if cc.executor.has_ongoing_execution:
                cc.executor.stop_execution(force=True)
        except Exception:  # noqa: BLE001
            log.warning("force-stop of %s failed on lease loss",
                        cluster_id, exc_info=True)
        from cruise_control_tpu_torch.detector.anomalies import FleetLeaseLost

        try:
            cc.anomaly_detector.add_anomaly(FleetLeaseLost(
                cluster_id=cluster_id,
                instance_id=self.lease_manager.holder_id,
                epoch=lease.epoch,
            ))
        except Exception:  # noqa: BLE001 — anomaly delivery is best-effort
            pass

    # ------------------------------------------------------------ rollups

    def fleet_state(self, cluster_id: str | None = None) -> dict:
        """The GET /fleet payload: per-cluster summaries + the shared-core
        view (engine cache, supervisor, admission control).  With fleet
        HA on, every cluster entry carries its `ownership` (owned/holder/
        epoch/degraded) and the payload an `ha` block (instance id, lease
        timings, owned set)."""
        ids = [cluster_id] if cluster_id else self.cluster_ids()
        clusters = {cid: self.cluster(cid).rollup() for cid in ids}
        lm = self.lease_manager
        if lm is not None:
            for cid in ids:
                ownership = lm.ownership_json(cid)
                ownership["degraded"] = self.cluster(cid).degraded
                clusters[cid]["ownership"] = ownership
        out = {
            "numClusters": len(self.contexts),
            "clusters": clusters,
            "shared": shared_core_rollup(
                self.core, tenant_max_pending=self.tenant_max_pending
            ),
        }
        if lm is not None:
            out["ha"] = lm.state_json()
        return out

    def score_clusters(self, *, allow_capacity_estimation: bool = True) -> dict:
        """Score every cluster's CURRENT placement on the shared goal
        chain, batching same-bucket clusters through the ScenarioEvaluator's
        one-dispatch path: clusters are grouped by their (bucketed) model
        shape, and each group rides one batched device program instead of
        N sequential evaluations.  Returns {cluster_id: score dict}."""
        from cruise_control_tpu_torch.analyzer.objective import balancedness_score
        from cruise_control_tpu_torch.service.progress import OperationProgress
        from cruise_control_tpu_torch.analyzer.scenario_eval import VIOLATION_TOL

        states: dict[str, object] = {}
        out: dict[str, dict] = {}
        for cid, ctx in self.contexts.items():
            try:
                states[cid] = ctx.cc._cluster_model(
                    OperationProgress(),
                    allow_capacity_estimation=allow_capacity_estimation,
                )
            except Exception as e:  # noqa: BLE001 — a cluster without a
                # valid model yet (still sampling) must not sink the rollup
                out[cid] = {"error": repr(e)}
        groups: dict[object, list[str]] = {}
        for cid, state in states.items():
            groups.setdefault(state.shape, []).append(cid)
        ev = self.core.scenario_evaluator
        chain = self.core.chain
        names = chain.names()
        pw, sw = self.core.balancedness_weights
        sched = getattr(self.core, "scheduler", None)
        for shape, cids in groups.items():
            if sched is None:
                objs, viols, degraded = ev.evaluate_states(
                    [states[c] for c in cids]
                )
            else:
                # fleet-wide batched scoring is BACKGROUND work: under
                # overload the whole group's dispatch sheds (reported,
                # never silent) rather than delaying an urgent re-anneal
                from cruise_control_tpu_torch.fleet.scheduler import (
                    BackgroundShedError,
                    WorkClass,
                )

                try:
                    objs, viols, degraded = sched.run(
                        WorkClass.BACKGROUND,
                        lambda cs=[states[c] for c in cids]: (
                            ev.evaluate_states(cs)
                        ),
                        op="fleet-score",
                    )
                except BackgroundShedError:
                    for cid in cids:
                        out[cid] = {"shed": True}
                    continue
            for i, cid in enumerate(cids):
                v = viols[i]
                out[cid] = {
                    "objective": float(objs[i]),
                    "balancedness": balancedness_score(
                        v, chain, priority_weight=pw, strictness_weight=sw
                    ),
                    "violatedGoals": [
                        n for n, x in zip(names, v) if x > VIOLATION_TOL
                    ],
                    "degraded": bool(degraded),
                    #: how many clusters shared this batch's device
                    #: dispatch (same bucketed shape) — 1 means this
                    #: cluster scored alone
                    "batchedWith": len(cids),
                }
        if groups:
            self.sensors.counter("fleet.batched-score-runs").inc(len(groups))
            self.sensors.counter("fleet.batched-score-clusters").inc(
                sum(len(c) for c in groups.values())
            )
        return out
