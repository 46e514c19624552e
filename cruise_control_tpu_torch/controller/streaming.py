"""StreamingController — the always-on incremental rebalancing loop.

Today's proposal path re-flattens the whole ClusterModel and anneals from
scratch on every request; under heavy traffic the service repays the full
model-build + anneal bill on every window roll.  The controller inverts
that: it owns a device-resident flattened ClusterState (models/whatif.py
LiveState) and, each time the partition aggregator rolls a metric window,

  1. extracts the window DELTA from two WindowedHistory snapshots
     (monitor/delta.py) — honoring the completeness mask, so half-sampled
     windows never read as traffic drops — and scatters only the changed
     partitions' loads into the live tensors, in place (the scatter_loads
     kernel; no re-flatten while the shape bucket holds);
  2. re-anneals INCREMENTALLY: the previous accepted placement seeds the
     run (the engine's warm start) and the learned per-topic-pair
     move-acceptance prior (controller/prior.py) is folded into the
     engine's destination sampling, so converged regions are not
     re-derived from uniform luck;
  3. publishes the result into the facade's proposal cache
     (CruiseControl.publish_proposal), superseding any staler cached
     proposal — `/proposals` always serves the freshest answer `/state`
     reports.

Topology deltas: a broker death/revival applies in place
(LiveState.set_broker_liveness); entity churn (topics/partitions created
or deleted) and metadata-generation bumps force a full re-flatten —
counted by `controller.full-reflattens`, which stays at the initial 1
across metric-only windows.  A fused cycle that fails leaves live loads
the controller cannot trust (its scatter into them may or may not have
run, and the window it consumed is gone), so the next cycle re-flattens
under its own reason, "failed-cycle".

Ownership: the live load tensors are rewritten in place by every window,
so a published result's `state_before` loads show the NEXT window's
values; everything served from a published result (the summary, the
proposals, the decision record) is read from host-side fields.

Cold-parity contract: with warm starts off, the delta path off, and a
cold prior, one controller cycle is byte-for-byte today's
re-flatten-and-anneal (tests/test_torch_controller_parity.py and
chip_smoke.py phase 28).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np

from cruise_control_tpu_torch.common.blackbox import RECORDER as _BLACKBOX
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.controller.prior import MoveAcceptancePrior
from cruise_control_tpu_torch.models.whatif import LiveState
from cruise_control_tpu_torch.monitor import ModelCompletenessRequirements
from cruise_control_tpu_torch.monitor.delta import extract_window_delta

log = logging.getLogger(__name__)

#: latency-shaped bucket boundaries for the streaming hot path — finer
#: below 1 s than the default ladder because the headline target
#: (`slo.streaming.publish.target.s`, ROADMAP item 4) is sub-second
STREAMING_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0,
    1.5, 2.5, 5.0, 10.0, 30.0, 60.0,
)


@dataclasses.dataclass
class _ModelIndex:
    """Host-side join index of one flatten: everything needed to map a
    window delta's (topic, partition) entities onto replica rows without
    touching the device."""

    topology_generation: int
    catalog: object
    history: object  # WindowedHistory the live arrays are synced to
    part_rows: np.ndarray  # i32[P, max_rf] replica rows per pid (R pads)
    part_lookup: dict  # (first-seen topic_id, partition_number) -> pid
    #: ReducedLoads of `history` — cached so the next cycle's diff does
    #: not re-reduce the [E, W, 4] tensor it already reduced as `cur`
    reduced: object = None

    def model_generation(self):
        """The generation the live model REFLECTS right now: the topology
        generation it was flattened from + the aggregator generation of
        the window snapshot its loads are synced to (both counters are
        the same ones LoadMonitor.model_generation reports, so publish
        freshness comparisons stay meaningful across sources).  Advances
        with every delta cycle — a publish must never be stamped with the
        reflatten-time generation or the first unrelated model build
        (detector rounds) would sideline the controller permanently."""
        from cruise_control_tpu_torch.monitor.load_monitor import ModelGeneration

        return ModelGeneration(
            metadata_generation=self.topology_generation,
            load_generation=int(self.history.generation),
        )


class StreamingController:
    """One per cluster facade; the fleet manager's per-cluster facades
    each own one (CruiseControl builds it when `controller.enabled`)."""

    def __init__(self, cc):
        cfg = cc.config
        self.cc = cc
        self.monitor = cc.monitor
        self.optimizer = cc.optimizer
        self.sensors = cc.sensors
        self.tracer = cc.tracer
        self.poll_interval_s = cfg.get("controller.poll.interval.ms") / 1000.0
        self.warm_start = cfg.get("controller.warm.start.enabled")
        self.delta_enabled = cfg.get("controller.delta.enabled")
        #: fuse delta-scatter + re-anneal + extraction into ONE graph
        #: launch on steady-state cycles (controller.fusion.enabled);
        #: requires warm starts (the fused cycle seeds from the prior
        #: placement) and a single-device engine
        self.fusion_enabled = cfg.get("controller.fusion.enabled")
        #: size the candidate plan from the delta's changed-entity count
        #: (controller.plan.*): quantized width steps so capture count
        #: stays bounded (one engine and capture a width), full-K on
        #: reflatten
        self.plan_sizing = cfg.get("controller.plan.sizing.enabled")
        self.plan_cands_per_partition = cfg.get(
            "controller.plan.candidates.per.partition"
        )
        self.plan_min_candidates = cfg.get("controller.plan.min.candidates")
        self.prior = MoveAcceptancePrior(
            mix=cfg.get("controller.prior.mix"),
            decay=cfg.get("controller.prior.decay"),
            min_observations=cfg.get("controller.prior.min.observations"),
        )
        # warm-start carry and the move-acceptance prior are single-device
        # engine features; under a mesh mode the controller still runs —
        # device-resident deltas + always-fresh publishes — but each
        # anneal is cold (passing warm inputs would make EVERY cycle
        # raise and the "always-on" loop would be permanently dead)
        if self.optimizer.parallel_mode != "single":
            if self.warm_start or self.prior.mix > 0.0:
                log.warning(
                    "streaming controller: warm starts and the move-"
                    "acceptance prior are disabled under "
                    "tpu.parallel.mode=%r (single-device features)",
                    self.optimizer.parallel_mode,
                )
            self.warm_start = False
            self.prior.mix = 0.0
            self.fusion_enabled = False
        #: prior sampling is captured only when a non-zero mix could ever
        #: apply — mix 0 keeps the engine (and its cache key) the request
        #: path's
        self._opt_config = dataclasses.replace(
            cfg.optimizer_config(), prior_enabled=self.prior.mix > 0.0
        )
        self._requirements = ModelCompletenessRequirements(
            min_required_num_windows=1,
            min_monitored_partitions_percentage=cfg.get(
                "min.valid.partition.ratio"
            ),
        )
        #: streaming publish-latency SLO target (`slo.streaming.publish.
        #: target.s`): each window-roll-to-publish wall feeds the
        #: "streaming-publish" SLO as a good/bad sample
        self._publish_target_s = cfg.get("slo.streaming.publish.target.s")
        # mint the hot-path histograms EAGERLY so their boundaries are
        # always the streaming ladder — a reader getting there first must
        # never fix them at the default ladder
        for stage in (
            "window-roll-to-publish", "delta-extract", "scatter", "anneal",
            "host-extract", "publish",
        ):
            self.sensors.histogram(
                f"controller.{stage}-seconds", buckets=STREAMING_BUCKETS
            )
        self._live: LiveState | None = None
        self._index: _ModelIndex | None = None
        self._warm = None  # (shape, replica_broker, replica_is_leader, replica_disk)
        #: fetch_before_host of the reflattened state — placement columns
        #: are delta-invariant between reflattens, so the fused cycle
        #: reuses this dict (only replica_disk_bytes refreshes, from the
        #: cycle payload) instead of re-fetching bulk arrays every window
        self._before_host: dict | None = None
        self._last_window: int | None = None
        #: set when a fused cycle raised: its scatter into the live loads
        #: may or may not have run, so the next cycle re-flattens
        self._live_suspect = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._boot_gate: threading.Event | None = None
        self._lock = threading.Lock()  # one cycle at a time (thread + run_once)
        # /state ControllerState internals (sensors carry the same counts
        # as monotonic series; these are the structured view)
        self._stats = dict(
            windowRolls=0, deltaApplies=0, fullReflattens=0,
            # per-reason breakout of fullReflattens (initial / topology /
            # delta-disabled / entities) so a p99 regression attributes
            # to a cause; the aggregate stays for compatibility
            fullReflattensByReason={},
            incrementalAnneals=0, warmStarts=0, proposalsPublished=0,
            fusedCycles=0, planSizedCycles=0,
            lastRounds=None, lastObjective=None, lastWallSeconds=None,
            lastWindowIndex=None, lastPublishMs=None, lastError=None,
            lastCycleDispatches=None, coldCycleSeconds=None,
            fusedColdCycleSeconds=None,
            loopFailures=0, cyclesShed=0, brownoutCycles=0,
        )

    # ----------------------------------------------------------- lifecycle

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, *, boot_gate: threading.Event | None = None) -> None:
        """`boot_gate` (facade start_up): the boot-time manifest prewarm's
        completion event.  The loop thread starts immediately (running is
        True) but waits — bounded — for the gate before its first cycle,
        so the active buckets' captures are already in flight on the warm
        pool when the controller takes ownership of proposal publishing
        (the bucket-prewarm path stands down while the controller runs;
        boot is the one window the manifest prewarm has)."""
        if self.running:
            return
        self._boot_gate = boot_gate
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="streaming-controller"
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Join the loop for at most `timeout_s`.  The loop reads its stop
        event only between cycles, so a cycle in flight (a graph capture
        under `kernels.graph_lock` included) runs to its end on the daemon
        thread after a join that timed out, then the thread exits."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
        self._thread = None

    def _loop(self) -> None:
        gate = getattr(self, "_boot_gate", None)
        if gate is not None:
            # bounded: a wedged prewarm must not keep the always-on loop
            # parked forever — after the budget the controller proceeds
            # and the remaining captures just overlap its first cycles
            deadline = time.monotonic() + 120.0
            while (
                not gate.is_set()
                and not self._stop.is_set()
                and time.monotonic() < deadline
            ):
                gate.wait(0.2)
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — the loop must keep ticking
                self._stats["loopFailures"] += 1
                self._stats["lastError"] = repr(e)
                self.sensors.counter("controller.loop-failures").inc()
                log.warning("streaming controller cycle failed", exc_info=True)

    # ------------------------------------------------------------- one tick

    def run_once(self):
        """One control cycle; returns a cycle-info dict when a window roll
        was processed, None when there was nothing to do.  Public so tests
        and chip_smoke.py drive the loop deterministically."""
        with self._lock:
            return self._run_once_locked()

    def _run_once_locked(self):
        agg = self.monitor.partition_aggregator
        cur_w = agg.current_window_index
        if cur_w is None:
            return None
        if (
            self._last_window is not None
            and cur_w <= self._last_window
            and self._live is not None
        ):
            return None  # no window roll since the last cycle
        try:
            history = agg.history_snapshot()
        except ValueError:
            return None  # no completed window yet
        t0 = time.monotonic()
        with self.tracer.span(
            "controller.window-roll", component="controller",
            window_index=int(cur_w),
        ) as sp:
            from cruise_control_tpu_torch.common.dispatch import dispatch_meter

            # per-cycle device-dispatch accounting: the fused steady-state
            # contract is <= 2 (one graph launch + one host extraction),
            # proved by counting at the choke points
            with dispatch_meter() as meter:
                if _BLACKBOX.enabled:
                    # the cycle is a dispatch-bearing unit of work: its
                    # begin/end (and any hang between them) belongs in the
                    # durable spool beside the engine records it triggers
                    with _BLACKBOX.record(
                        "controller-cycle", window=int(cur_w),
                        cluster=self.cc.cluster_id or "",
                    ):
                        info = self._cycle(history, sp)
                else:
                    info = self._cycle(history, sp)
            wall = time.monotonic() - t0
            self._stats["lastCycleDispatches"] = meter.total
            self.sensors.gauge("controller.cycle-dispatches").set(meter.total)
            info["dispatches"] = dict(meter.counts)
            if info.get("published"):
                first_fused = bool(
                    info.get("fused") and self._stats["fusedCycles"] == 1
                )
                if self._stats["proposalsPublished"] > 1 and not first_fused:
                    # the HEADLINE latency: metric-window roll observed ->
                    # superseding proposal published, with the cycle's
                    # trace id as the OpenMetrics exemplar so a p99
                    # outlier on a dashboard links straight to its /trace
                    # replay.  The FIRST published cycle is excluded — it
                    # pays the engine build and capture, and one restart sample
                    # would dominate a steady-state p99 (same exclusion
                    # the calibration sampler and streaming-publish SLO
                    # apply); it reports through the one-shot cold-compile
                    # sensor below instead.
                    self.sensors.histogram(
                        "controller.window-roll-to-publish-seconds",
                        buckets=STREAMING_BUCKETS,
                    ).observe(
                        wall,
                        exemplar=(
                            {"trace_id": sp.trace_id} if sp.trace_id else None
                        ),
                    )
                elif first_fused:
                    # the first FUSED cycle captures the cycle's graphs —
                    # its wall is a capture artifact too, so it
                    # reports through its own one-shot sensor instead of
                    # skewing the steady-state p99
                    self._stats["fusedColdCycleSeconds"] = round(wall, 6)
                    self.sensors.gauge(
                        "controller.fused-cold-compile-cycle-seconds"
                    ).set(wall)
                elif self._stats["coldCycleSeconds"] is None:
                    # one-shot cold-compile sensor: the first published
                    # cycle's wall (engine build + capture + anneal), kept
                    # out of the steady-state histogram but never hidden
                    self._stats["coldCycleSeconds"] = round(wall, 6)
                    self.sensors.gauge(
                        "controller.cold-compile-cycle-seconds"
                    ).set(wall)
                reg = getattr(self.cc, "slo_registry", None)
                # the FIRST cycle pays the cold capture and will blow
                # any sub-second target — that wall is the cold-start
                # SLO's sample, and feeding it here would fire a spurious
                # SLO_BURN on every restart (the histogram above still
                # reports it honestly)
                if reg is not None and self._stats["incrementalAnneals"] > 1:
                    reg.record(
                        "streaming-publish", wall <= self._publish_target_s
                    )
        self._last_window = cur_w
        self._stats["windowRolls"] += 1
        self._stats["lastWindowIndex"] = int(cur_w)
        self._stats["lastWallSeconds"] = round(wall, 6)
        self.sensors.counter("controller.window-rolls").inc()
        return info

    def _cycle(self, history, sp) -> dict:
        info: dict = dict(reflattened=False, delta_partitions=0)
        delta_rows = None
        topo_gen = self.monitor.metadata.topology().generation
        idx = self._index
        if (
            self._live is None
            or idx is None
            or not self.delta_enabled
            or topo_gen != idx.topology_generation
            or self._live_suspect
        ):
            # topology outranks delta-disabled: the reason decides whether
            # the warm placement survives, and a membership change must
            # clear it in EVERY mode (a stale warm start could
            # double-place a partition)
            if self._live is None or idx is None:
                reason = "initial"
            elif topo_gen != idx.topology_generation:
                reason = "topology"
            elif self._live_suspect:
                reason = "failed-cycle"
            else:
                reason = "delta-disabled"
            self._reflatten(history, reason=reason)
            info["reflattened"] = True
            info["reflatten_reason"] = reason
        else:
            t_ex = time.monotonic()
            delta = extract_window_delta(
                idx.history, history,
                self.monitor.partition_aggregator.metric_def,
                prev_reduced=idx.reduced,
            )
            self._stage_observe(
                "controller.delta-extract-seconds", time.monotonic() - t_ex, sp
            )
            if delta.requires_reflatten:
                # topics/partitions appeared or vanished mid-stream: the
                # in-place path cannot express membership churn
                self._reflatten(history, reason="entities")
                info["reflattened"] = True
                info["reflatten_reason"] = "entities"
            else:
                delta_rows = self._delta_rows(delta)
                info["delta_partitions"] = delta_rows[3]
                self._stats["deltaApplies"] += 1
                self.sensors.counter("controller.delta-applies").inc()
                if delta_rows[3]:
                    self.sensors.counter("controller.delta-partitions").inc(
                        delta_rows[3]
                    )
                idx.history = history
                idx.reduced = delta.reduced
        sp.set(
            reflattened=info["reflattened"],
            delta_partitions=info["delta_partitions"],
        )
        info.update(self._anneal(sp, delta=delta_rows))
        return info

    def _stage_observe(self, name: str, wall_s: float, sp) -> None:
        """One hot-path stage sample into its latency Histogram, exemplar
        = this cycle's trace id (delta-extract / scatter / anneal /
        host-extract / publish — the stages `controller.window-roll-to-
        publish-seconds` is the sum of)."""
        self.sensors.histogram(name, buckets=STREAMING_BUCKETS).observe(
            wall_s,
            exemplar={"trace_id": sp.trace_id} if sp.trace_id else None,
        )

    # ----------------------------------------------------- flatten / delta

    def _reflatten(self, history, *, reason: str) -> None:
        """Full model build — the slow path the delta machinery exists to
        avoid; every occurrence is counted and reasoned."""
        from cruise_control_tpu_torch.analyzer.engine import partition_replica_table

        # generation BEFORE the build: if a metadata refresh lands while
        # the model builds, this stamp is older than what the build
        # consumed and the next cycle's generation check re-flattens —
        # the safe direction (stamping the AFTER generation could pin a
        # pre-refresh model as current until the next topology bump)
        topo_gen = self.monitor.metadata.topology().generation
        with self.monitor.acquire_for_model_generation():
            state = self.monitor.cluster_model(self._requirements)
        catalog = self.monitor.last_catalog
        # aggregator entities carry FIRST-SEEN topology topic ids (the
        # sampler/partitions_fn space the monitor's own load join uses);
        # the catalog/state ids are name-rank.  The lookup must bridge the
        # two spaces or a cluster whose topics first appear out of name
        # order scatters window loads onto the wrong topics' replicas.
        lookup = {}
        if catalog is not None:
            parts = self.monitor.metadata.topology().partitions
            if self.monitor.topic_filter is not None:
                parts = tuple(
                    p for p in parts if self.monitor.topic_filter(p.topic)
                )
            first_seen: dict = {}
            for p in parts:
                first_seen.setdefault(p.topic, len(first_seen))
            pid_by_name = {
                (tname, int(pnum)): pid
                for pid, (tname, pnum) in enumerate(catalog.partitions)
            }
            for p in parts:
                pid = pid_by_name.get((p.topic, int(p.partition)))
                if pid is not None:
                    lookup[(first_seen[p.topic], int(p.partition))] = pid
        self._live = LiveState(state)
        self._live_suspect = False
        self._index = _ModelIndex(
            topology_generation=topo_gen,
            catalog=catalog,
            history=history,
            part_rows=partition_replica_table(state),
            part_lookup=lookup,
        )
        if self._warm is not None and self._warm[0] != state.shape:
            self._warm = None  # bucket changed: the placement axes moved
        if reason in ("topology", "entities"):
            # membership may have changed under the old placement — a
            # stale warm start could double-place a partition
            self._warm = None
        # the fused cycle's BEFORE-placement host cache: placement columns
        # are delta-invariant until the next reflatten, so one fetch here
        # (off the steady-state path) serves every fused extraction
        if self.fusion_enabled:
            from cruise_control_tpu_torch.analyzer.proposals import fetch_before_host

            self._before_host = fetch_before_host(state)
        else:
            self._before_host = None
        self._stats["fullReflattens"] += 1
        by = self._stats["fullReflattensByReason"]
        by[reason] = by.get(reason, 0) + 1
        self.sensors.counter("controller.full-reflattens").inc()
        self.sensors.counter(f"controller.reflatten.{reason}").inc()

    def _delta_rows(self, delta):
        """One window delta as a replica-row scatter triple
        `(rows, ll_rows, fl_rows, n_partitions)` — shared by the staged
        path (LiveState.set_partition_loads) and the fused cycle (the
        same scatter, in-graph); `(None, None, None, 0)` when no mapped
        partition changed."""
        idx = self._index
        changed = delta.changed
        if not changed.any():
            return None, None, None, 0
        ents = [e for e, c in zip(delta.entities, changed) if c]
        ll = delta.loads[changed]
        pids = []
        keep = []
        for i, e in enumerate(ents):
            pid = idx.part_lookup.get((int(e.topic), int(e.partition)))
            if pid is not None:
                pids.append(pid)
                keep.append(i)
        if not pids:
            return None, None, None, 0
        ll = ll[keep]
        fl = self.monitor.follower_loads(ll)
        rows_p = idx.part_rows[np.asarray(pids)]  # [n, max_rf], R pads
        R = self._live.shape.R
        valid = rows_p < R
        counts = valid.sum(1)
        rows = rows_p[valid].astype(np.int32)
        ll_rows = np.repeat(ll, counts, axis=0)
        fl_rows = np.repeat(fl, counts, axis=0)
        return rows, ll_rows, fl_rows, len(pids)

    # -------------------------------------------------------------- anneal

    def _plan_config(self, cfg, delta_partitions: int):
        """Delta-sized candidate plan: a 50-partition window roll must not
        pay the full-K sampling plan.  The width needed is
        max(plan.min.candidates, delta_partitions x candidates-per-
        partition), quantized to one of THREE fixed fractions of full K
        (1/2, 1/4, 1/8) so each base config yields at most three extra
        engine-cache keys (brownout_config's bounded-capture idiom) —
        never an exact per-delta width, which would capture per cycle.
        Full K whenever the need reaches K/2 (and always on reflatten,
        where there is no delta)."""
        K = cfg.num_candidates
        needed = max(
            int(self.plan_min_candidates),
            int(delta_partitions) * int(self.plan_cands_per_partition),
        )
        if needed * 2 > K:
            return cfg
        f = 0.5
        while f > 0.125 and K * (f / 2) >= needed:
            f /= 2
        return dataclasses.replace(
            cfg,
            num_candidates=max(64, int(K * f)),
            leadership_candidates=max(8, int(cfg.leadership_candidates * f)),
            swap_candidates=max(0, int(cfg.swap_candidates * f)),
        )

    def _anneal(self, sp, delta=None) -> dict:
        """One cycle's re-anneal.  `delta` is the window's scatter triple
        `(rows, ll_rows, fl_rows, n_partitions)` on steady-state cycles
        (None on reflatten cycles, whose scatter is the flatten itself).

        Steady state prefers the FUSED path: scatter + warm re-anneal +
        extraction as one graph launch and one sync
        (GoalOptimizer.optimize_streaming_cycle), submitted INTERACTIVE —
        an operator-facing latency path — and granted unsegmented by the
        scheduler's fast path when nothing else waits.  The staged path
        (host scatter, then a supervised BACKGROUND optimize) remains the
        fallback for: fusion off, no warm placement yet, no cached engine
        (the staged run builds and caches it, so the NEXT cycle fuses),
        mesh parallel modes, and supervisor-breaker-open."""
        state = self._live.state
        catalog = self._index.catalog
        warm = None
        if self.warm_start and self._warm is not None and self._warm[0] == state.shape:
            warm = self._warm[1:]
        prior_table = (
            self.prior.table(catalog, state.shape)
            if self._opt_config.prior_enabled
            else None
        )
        options = self.cc._build_options(state)
        # drift cycles are BACKGROUND work on the shared device: under
        # the scheduler they run segmented (preemptible by URGENT fix
        # pipelines), shed under transient overload (counted — the cycle
        # is skipped, the stale proposal keeps serving inside its
        # freshness SLO), and run BROWNED OUT — reduced candidate width,
        # not skipped — under sustained overload
        sched = self.cc.scheduler
        cfg = self._opt_config
        plan_sized = False
        if delta is not None and self.plan_sizing:
            sized = self._plan_config(cfg, delta[3])
            plan_sized = sized is not cfg
            cfg = sized
        brownout = False
        if sched is not None and sched.brownout_active:
            cfg = sched.brownout_config(cfg)
            brownout = True
        # fused eligibility is decided BEFORE submission so the work
        # class is honest: only a cycle that will actually take the
        # one-dispatch fast path rides the INTERACTIVE queue.  The
        # engine-cache check makes the first cycle after a (re)start or a
        # fresh plan width go staged — which builds and caches the
        # engine — and every later one fused.  A cached engine that another
        # run rebound since (a re-flatten, another cluster of the bucket, a
        # request with options of its own) makes optimize_streaming_cycle
        # answer None before its scatter, and the cycle goes staged below.
        fused_ready = (
            delta is not None
            and self.fusion_enabled
            and warm is not None
            and self.optimizer.parallel_mode == "single"
            and self.optimizer.has_engine_for(state.shape, config=cfg)
        )
        if delta is not None and not fused_ready:
            # staged scatter, BEFORE submission: a shed cycle must still
            # leave the live loads current (the window was consumed —
            # idx.history already advanced)
            rows, ll_rows, fl_rows, _n = delta
            t_sc = time.monotonic()
            if rows is not None:
                self._live.set_partition_loads(rows, ll_rows, fl_rows)
            self._stage_observe(
                "controller.scatter-seconds", time.monotonic() - t_sc, sp
            )
            state = self._live.state
        ran = dict(fused=False)

        def _run():
            # the anneal timer lives INSIDE the scheduled body: it must
            # keep measuring anneal wall, not scheduler queue wait —
            # fleet.scheduler.wait-timer.background already reports the
            # wait separately
            t_an = time.monotonic()
            with self.sensors.timer("controller.anneal-timer").time():
                r = None
                if fused_ready:
                    rows, ll_rows, fl_rows, _n = delta
                    if rows is None:
                        # nothing changed this window: an empty scatter
                        # (all-sentinel rows) still re-anneals fused
                        rows = np.zeros(0, np.int32)
                        ll_rows = fl_rows = np.zeros(
                            (0, NUM_RESOURCES), np.float32
                        )
                    try:
                        out = self.optimizer.optimize_streaming_cycle(
                            state,
                            rows=rows,
                            leader_loads=ll_rows,
                            follower_loads=fl_rows,
                            initial_placement=warm,
                            options=options,
                            config=cfg,
                            prior=prior_table,
                            before_host=self._before_host,
                        )
                    except BaseException:
                        # the in-graph scatter may or may not have run:
                        # the live loads are suspect until a re-flatten
                        self._live_suspect = True
                        raise
                    if out is not None:
                        r, (new_ll, new_fl) = out
                        # ownership hand-back: the cycle scattered into
                        # the live load tensors and returned the pair
                        self._live.adopt_loads(new_ll, new_fl)
                        ran["fused"] = True
                if r is None:
                    if fused_ready:
                        # lost the engine-cache race between the check
                        # and the call, or the engine is bound to another
                        # state or other options: the in-graph scatter
                        # never ran, so scatter staged before annealing
                        rows, ll_rows, fl_rows, _n = delta
                        if rows is not None:
                            self._live.set_partition_loads(
                                rows, ll_rows, fl_rows
                            )
                    r = self.optimizer.optimize(
                        self._live.state,
                        options=options,
                        config=cfg,
                        initial_placement=warm,
                        prior=prior_table,
                    )
            self._stage_observe(
                "controller.anneal-seconds", time.monotonic() - t_an, sp
            )
            return r

        if sched is None:
            result = _run()
        else:
            from cruise_control_tpu_torch.fleet.scheduler import (
                BackgroundShedError,
                WorkClass,
            )

            try:
                result = sched.run(
                    WorkClass.INTERACTIVE if fused_ready
                    else WorkClass.BACKGROUND,
                    _run,
                    cluster_id=self.cc.cluster_id or "",
                    op="controller-cycle",
                    freshness_slo_s=self.cc._freshness_slo_s,
                )
            except BackgroundShedError:
                self._stats["cyclesShed"] += 1
                self.sensors.counter("controller.cycles-shed").inc()
                sp.set(shed=True)
                return dict(shed=True, rounds=0, warm_start=False,
                            published=False)
        if brownout:
            self._stats["brownoutCycles"] += 1
        if ran["fused"]:
            self._stats["fusedCycles"] += 1
            self.sensors.counter("controller.fused-cycles").inc()
        if plan_sized:
            self._stats["planSizedCycles"] += 1
            self.sensors.counter("controller.plan-sized-cycles").inc()
        timing = next((h for h in result.history if h.get("timing")), {})
        if timing.get("host_extract_s") is not None:
            # the fused run's one blocking host fetch — the stage the
            # ROADMAP fusion audit targets, now measured per cycle
            self._stage_observe(
                "controller.host-extract-seconds",
                timing["host_extract_s"], sp,
            )
        rounds = sum(1 for h in result.history if not h.get("timing"))
        after = result.state_after
        self._warm = (
            state.shape, after.replica_broker, after.replica_is_leader,
            after.replica_disk,
        )
        observed = self.prior.observe_proposals(result.proposals, catalog)
        t_pub = time.monotonic()
        published = self.cc.publish_proposal(
            result, generation=self._index.model_generation(),
            prior_table=prior_table,
            # the FIRST publish (cold-compile cycle) is excluded from
            # calibration sampling — the same exclusion the streaming-
            # publish SLO applies — so restarts can't fire a spurious
            # MODEL_DRIFT off a cold, possibly-degraded first anneal
            calibration_eligible=self._stats["incrementalAnneals"] > 0,
        )
        self._stage_observe(
            "controller.publish-seconds", time.monotonic() - t_pub, sp
        )
        self._stats["incrementalAnneals"] += 1
        self._stats["lastRounds"] = rounds
        self._stats["lastObjective"] = result.objective_after
        if warm is not None:
            self._stats["warmStarts"] += 1
            self.sensors.counter("controller.warm-starts").inc()
        if published:
            self._stats["proposalsPublished"] += 1
            self._stats["lastPublishMs"] = int(time.time() * 1000)
            self.sensors.counter("controller.proposals-published").inc()
        self.sensors.counter("controller.incremental-anneals").inc()
        self.sensors.gauge("controller.rounds-last").set(rounds)
        self.sensors.gauge("controller.prior-observations").set(
            self.prior.observations
        )
        sp.set(
            rounds=rounds,
            warm_start=warm is not None,
            prior_mix=(prior_table.mix if prior_table is not None else 0.0),
            published=published,
            objective_after=result.objective_after,
            fused=ran["fused"],
            plan_candidates=cfg.num_candidates,
        )
        return dict(
            rounds=rounds,
            warm_start=warm is not None,
            objective=result.objective_after,
            prior_observed=observed,
            published=published,
            fused=ran["fused"],
            result=result,
        )

    # ---------------------------------------------------- executor feedback

    def observe_executed(self, proposals) -> None:
        """Executed proposals are the strongest acceptance signal the
        prior gets (facade._execute feeds every execution through here)."""
        idx = self._index
        catalog = idx.catalog if idx is not None else self.monitor.last_catalog
        if catalog is None:
            return
        self.prior.observe_executed(proposals, catalog)
        self.sensors.gauge("controller.prior-observations").set(
            self.prior.observations
        )

    # ---------------------------------------------------------------- state

    def state_json(self) -> dict:
        out = dict(self._stats)
        out["running"] = self.running
        out["warmStartEnabled"] = self.warm_start
        out["deltaEnabled"] = self.delta_enabled
        out["prior"] = self.prior.state_json()
        return out
