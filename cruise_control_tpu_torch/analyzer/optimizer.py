"""GoalOptimizer — compute optimization proposals for a cluster model.

Reference: analyzer/GoalOptimizer.java:416-487 (per-goal optimize + stats +
diff) and analyzer/OptimizerResult.java:31.  One proposal runs the whole
weighted goal chain at once through the annealing engine and reports the
per-goal violations before and after, cluster stats, the balancedness score
and the proposal diff.  Single device; engines are cached per (shape,
max_rf, config) and rebound to each new model generation: max_rf, the
width of the member table (`models/state.py member_width`), sizes an
engine's buffers beside the shape, as it sizes the JAX package's compiled
programs.

Callers may share one optimizer across threads.  A lock guards the engine
cache; a run pins its engine until its result is on the host, and an
eviction that finds the engine pinned leaves its release to the last
unpin.  An engine owns one fixed workspace and the graphs captured on it,
so runs on one engine take its run lock (`Engine.locked`) from the rebind
to the fetch, one at a time; runs on different engines overlap.  A
segmented run (the device scheduler's preemptible grant,
fleet/scheduler.py) that a checkpoint pauses lets go of the lock for the
pause, so an urgent request on the same bucket runs meanwhile on the same
engine: no deadlock, and no second engine, whose capture would sit on the
urgent request's path.

An engine captures its graphs once for its bucket and serves every later
model generation of it without a capture (analyzer/engine.py).
`prewarm` builds the engine of a bucket ahead of use and captures its
graphs on the warm pool, pinned until the capture is done;
`compile_attribution` bills each bucket its captures, their seconds and
the request-path runs that paid for one.  With a `PrewarmStore`, every
build and rebind records its bucket in the boot manifest
(analyzer/prewarm.py).

Supervision is opt-in, as in the JAX package: an optimizer built with a
`DeviceSupervisor` (common/device_watchdog.py) runs every device touch of
`optimize` (the input checks, the engine's build, rebind and run, the
fetch) inside one bounded, classified supervisor call
(`DeviceSupervisor.run`).  On the card a classified device failure
raises `DeviceDegradedError`, and an open breaker `BreakerOpenError`
without touching the card: work on the card is never moved to the CPU.
On the CPU, where the state already lies on the host, they are answered
as the JAX package answers them, by the CPU greedy oracle
(analyzer/greedy.py): a result whose `degraded` is True, with a
`degraded` history record saying why.  Without a supervisor (the
default) nothing of this runs: a device failure raises from `optimize`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np

from cruise_control_tpu_torch.analyzer.engine import Engine, OptimizerConfig
from cruise_control_tpu_torch.analyzer.greedy import greedy_optimize
from cruise_control_tpu_torch.analyzer.objective import (
    DEFAULT_CHAIN,
    GoalChain,
    balancedness_score,
)
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS, OptimizationOptions
from cruise_control_tpu_torch.analyzer.prewarm import bucket_key
from cruise_control_tpu_torch.analyzer.proposals import (
    ExecutionProposal,
    extract_proposals,
    fetch_before_host,
)
from cruise_control_tpu_torch.common.blackbox import RECORDER as _BLACKBOX
from cruise_control_tpu_torch.common.blackbox import blackbox_context
from cruise_control_tpu_torch.common.profiling import profiler_trace
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.models.aggregates import compute_aggregates
from cruise_control_tpu_torch.models.state import (
    DEVICE_CHECKS,
    ClusterState,
    member_width,
    validate,
    validate_on_device,
)
from cruise_control_tpu_torch.models.stats import ClusterStats, compute_stats


@dataclasses.dataclass(frozen=True)
class OptimizerResult:
    """What an optimization run produced (reference analyzer/OptimizerResult.java:31)."""

    proposals: list[ExecutionProposal]
    state_before: ClusterState
    state_after: ClusterState
    stats_before: ClusterStats
    stats_after: ClusterStats
    goal_names: list[str]
    violations_before: np.ndarray  # f32[G]
    violations_after: np.ndarray  # f32[G]
    balancedness_before: float
    balancedness_after: float
    objective_before: float
    objective_after: float
    wall_seconds: float
    history: list[dict]

    @property
    def num_inter_broker_moves(self) -> int:
        return self.proposals.num_inter_broker_moves

    @property
    def num_leadership_moves(self) -> int:
        return self.proposals.num_leadership_moves

    @property
    def data_to_move(self) -> float:
        return self.proposals.data_to_move

    @property
    def degraded(self) -> bool:
        """True when this result came from the CPU greedy route (a
        supervised optimizer on the CPU) because the device path was
        unavailable (the supervisor's breaker open) or failed with a
        classified device fault; the history carries a `degraded` record
        with the reason and failure class."""
        return any(h.get("degraded") for h in self.history)

    def violated_goals_after(self, tol: float = 1e-6) -> list[str]:
        """Default tol matches balancedness_score's goal-satisfied epsilon."""
        return [n for n, v in zip(self.goal_names, self.violations_after) if v > tol]

    def summary(self) -> dict:
        return {
            "numReplicaMovements": self.num_inter_broker_moves,
            "numLeaderMovements": self.num_leadership_moves,
            "dataToMoveMB": self.data_to_move,
            "balancednessBefore": self.balancedness_before,
            "balancednessAfter": self.balancedness_after,
            "objectiveBefore": self.objective_before,
            "objectiveAfter": self.objective_after,
            "violatedGoalsAfter": self.violated_goals_after(),
            "wallSeconds": self.wall_seconds,
            "degraded": self.degraded,
        }


def parse_parallel_mode(mode: str) -> tuple[int, int] | None:
    """Validate "single" / "sharded" / "grid:RxM"; returns (R, M) for grid
    modes, None otherwise.  The single source of truth for the mode syntax
    (the config validator delegates here).  This package runs "single"
    only; the other modes parse as in the JAX package."""
    import re

    if mode in ("single", "sharded"):
        return None
    m = re.fullmatch(r"grid:([1-9]\d*)x([1-9]\d*)", str(mode))
    if m:
        return int(m.group(1)), int(m.group(2))
    raise ValueError(
        f"tpu.parallel.mode must be single | sharded | grid:RxM, got {mode!r}"
    )


class GoalOptimizer:
    """Entry point of a proposal (reference GoalOptimizer.optimizations:416).

    `device` is where engines run and where input states must live; it
    defaults to the current CUDA device and raises when there is none.

    `supervisor` (a `DeviceSupervisor`, shared by a service's optimizers
    and evaluators) supervises every device invocation: a hang is bounded,
    and while its breaker is open, or when a call fails with a classified
    device failure, `optimize` raises `DeviceDegradedError` on the card
    and serves a CPU greedy result tagged degraded on the CPU.  None (the
    default) keeps the direct path with no change of behaviour.
    `degraded_budget_s` caps the greedy's wall clock.  `sensors` (a common/sensors.py `SensorRegistry`) receives the
    engine cache's hit/miss counters and size gauge and the
    `analyzer.degraded-proposals` counter; `tracer` is the flight
    recorder every `optimize` opens an `analyzer.optimize` span on
    (common/trace.py; the process-wide TRACER by default).
    `profiler_dir` (config tpu.profiler.*): when set, every engine run is
    traced with `torch.profiler` into that directory
    (common/profiling.py `profiler_trace`).
    """

    def __init__(
        self,
        chain: GoalChain = DEFAULT_CHAIN,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        config: OptimizerConfig = OptimizerConfig(),
        *,
        device=None,
        balancedness_weights: tuple[float, float] = (1.1, 1.5),
        engine_cache_size: int = 8,
        prewarm_store=None,
        supervisor=None,
        degraded_budget_s: float = 30.0,
        sensors=None,
        tracer=None,
        profiler_dir: str | None = None,
    ):
        if engine_cache_size < 1:
            raise ValueError(f"engine_cache_size must be >= 1, got {engine_cache_size}")
        self.chain = chain
        self.constraint = constraint
        self.config = config
        self.device = resolve_device(device)
        self.balancedness_weights = balancedness_weights
        #: engines per (ClusterShape, max_rf, config) in LRU order; a hit
        #: rebinds.  `_cache_lock` guards it, every engine's pin count and
        #: `_bound`
        self._engines: OrderedDict = OrderedDict()
        #: (ClusterShape, config) -> the max_rf of the engine a request
        #: last bound: the engine whose statics the streaming cycle runs on
        self._bound: dict = {}
        self._cache_capacity = engine_cache_size
        self._cache_lock = threading.Lock()
        self.engine_cache_hits = 0
        self.engine_cache_misses = 0
        #: the boot manifest (analyzer/prewarm.py PrewarmStore), or None
        self.prewarm_store = prewarm_store
        #: bucket key -> captures, their seconds, cold request-path walls
        #: and engine build seconds (`compile_attribution`)
        self._compile_attribution: dict[str, dict] = {}
        self.supervisor = supervisor
        self.degraded_budget_s = degraded_budget_s
        self.sensors = sensors
        from cruise_control_tpu_torch.common.trace import TRACER

        self.tracer = tracer if tracer is not None else TRACER
        self.profiler_dir = profiler_dir
        #: the breaker's open epoch last seen: the cache is purged once per
        #: open transition (`_maybe_purge_after_open`)
        self._breaker_epoch = supervisor.open_epoch if supervisor is not None else 0
        #: engines purged after the card's context was lost, kept unreleased
        #: for the process's life (`_maybe_purge_after_open`)
        self._abandoned_engines: list = []

    @property
    def cache_size(self) -> int:
        """Engines currently cached."""
        with self._cache_lock:
            return len(self._engines)

    def _sense_cache(self, hit: bool | None) -> None:
        """The engine cache's sensors: a hit or a miss (None: neither) and
        the size gauge."""
        if self.sensors is None:
            return
        if hit is not None:
            self.sensors.counter(f"analyzer.engine-cache-{'hits' if hit else 'misses'}").inc()
        self.sensors.gauge("analyzer.engine-cache-size").set(self.cache_size)

    def _pin(self, key) -> Engine | None:
        """The cached engine of `key`, pinned, or None (under the lock)."""
        engine = self._engines.get(key)
        if engine is not None:
            self._engines.move_to_end(key)
            engine._cc_pins += 1
        return engine

    def _unpin(self, engine: Engine) -> None:
        """Drop a run's pin; the last unpin of an evicted engine releases it."""
        with self._cache_lock:
            engine._cc_pins -= 1
            release = engine._cc_pins == 0 and engine._cc_evicted
        if release:
            engine.release()

    def _publish(self, key, engine: Engine, count: bool = True) -> Engine:
        """Cache a new engine pinned and evict the least recent beyond the
        capacity: at once where no run holds it, else at its last unpin.
        Where another thread cached one for `key` first, that one is
        pinned and returned, and `engine` (never run) is released.
        `count`: a miss or hit in the cache's counters (a prewarm's is
        neither)."""
        evicted = []
        with self._cache_lock:
            won = self._pin(key)
            if won is None:
                engine._cc_pins = 1
                self._engines[key] = engine
                while len(self._engines) > self._cache_capacity:
                    old = self._engines.popitem(last=False)[1]
                    old._cc_evicted = True
                    if old._cc_pins == 0:
                        evicted.append(old)
                self.engine_cache_misses += count
            else:
                self.engine_cache_hits += count
        for old in evicted:
            old.release()
        if count:
            self._sense_cache(won is not None)
        if won is not None:
            engine.release()
            return won
        return engine

    @contextlib.contextmanager
    def _engine_for(self, state: ClusterState, options: OptimizationOptions,
                    config: OptimizerConfig, prior=None):
        """The cached engine of (shape, max_rf, config) bound to `state`
        and `prior`, built on a miss, pinned and under its run lock for
        the body; yields (engine, hit)."""
        key = (state.shape, member_width(state), config)
        with self._cache_lock:
            engine = self._pin(key)
            if engine is not None:
                self.engine_cache_hits += 1
        hit = engine is not None
        if hit:
            self._sense_cache(True)
        else:
            t0 = time.monotonic()
            built = self._new_engine(state, options, config, prior)
            engine = self._publish(key, built)
            hit = engine is not built
            if not hit:
                self._attribute(state.shape, buildSeconds=time.monotonic() - t0)
        try:
            with engine.locked():
                # an engine is built bound to its builder's state: only a
                # run that found it cached, or came after another, rebinds
                if hit or not engine._cc_fresh:
                    engine.rebind(state, options, prior=prior)
                engine._cc_fresh = False
                with self._cache_lock:
                    self._bound[(state.shape, config)] = key[1]
                if self.prewarm_store is not None:
                    self.prewarm_store.note(state.shape, engine.max_rf, config)
                yield engine, hit
        finally:
            self._unpin(engine)

    def _new_engine(self, state: ClusterState, options: OptimizationOptions,
                    config: OptimizerConfig, prior=None) -> Engine:
        """An engine of the cache, unpinned, its captures billed to its
        bucket."""
        built = Engine(state, self.chain, constraint=self.constraint, options=options,
                       config=config, prior=prior)
        built._cc_pins, built._cc_evicted = 0, False
        built._cc_fresh = True
        shape = state.shape
        built.on_capture = lambda seconds, source: self._attribute(
            shape, compiles=1, captureSeconds=seconds)
        return built

    def prewarm(self, state: ClusterState, options: OptimizationOptions = DEFAULT_OPTIONS, *,
                config: OptimizerConfig | None = None, priority: int = 0) -> None:
        """Build the engine of `state`'s bucket and capture its graphs on
        the warm pool without running it (`Engine.precompile_async`), so
        the bucket's first request captures nothing on its path (the JAX
        package's `prewarm`).  Build only, never a rebind: where an engine
        of (shape, max_rf, config) is cached, including one a request
        cached while this one was built, it is left as it is.  The hit and
        miss counters are not touched.  The engine counts as pinned until
        its capture is done, so an eviction meanwhile releases it only
        then; the capture's error is raised to the first run that takes
        the engine.  `priority` orders the capture on the shared pool
        (lower first).

        Supervised like `optimize`: with the breaker open nothing is built
        (prewarming a failed card only queues more failures), and a
        classified failure of the build is counted and swallowed — a
        skipped prewarm means the bucket's first request captures."""
        sup = self.supervisor
        if sup is None:
            self._prewarm_on_device(state, options, config=config, priority=priority)
            return
        self._maybe_purge_after_open()
        try:
            sup.run(lambda: self._prewarm_on_device(state, options, config=config,
                                                    priority=priority),
                    op="prewarm", degraded=lambda reason, cause: None)
        finally:
            self._maybe_purge_after_open()

    def _prewarm_on_device(self, state: ClusterState, options: OptimizationOptions, *,
                           config: OptimizerConfig | None, priority: int) -> None:
        if state.device != self.device:
            raise ValueError(f"state is on {state.device}, the optimizer runs on {self.device}")
        cfg = config or self.config
        key = (state.shape, member_width(state), cfg)
        with self._cache_lock:
            if key in self._engines:
                return
        t0 = time.monotonic()
        built = self._new_engine(state, options, cfg)
        engine = self._publish(key, built, count=False)
        if engine is not built:
            self._unpin(engine)  # a request cached one first
            return
        self._attribute(state.shape, buildSeconds=time.monotonic() - t0)
        try:
            engine.precompile_async(priority=priority)
        except BaseException:
            self._unpin(engine)
            raise
        engine._warm.add_done_callback(lambda _fut: self._unpin(engine))

    def _attribute(self, shape, **add) -> None:
        """Add to the bucket's row of `compile_attribution`."""
        with self._cache_lock:
            row = self._compile_attribution.setdefault(bucket_key(shape), {
                "compiles": 0, "captureSeconds": 0.0, "coldWallSeconds": 0.0,
                "buildSeconds": 0.0})
            for k, v in add.items():
                row[k] = row[k] + v if k == "compiles" else round(row[k] + v, 6)

    def compile_attribution(self) -> dict[str, dict]:
        """Per shape bucket (`prewarm.bucket_key`): `compiles`, the
        captures of its engines' graphs (on a run's path or the warm
        pool's), `captureSeconds`, their warm-up, capture and instantiation
        seconds, `coldWallSeconds`, the walls of the runs that captured on
        their path (capture included), and `buildSeconds`, the host build
        of its engines."""
        with self._cache_lock:
            return {k: dict(v) for k, v in self._compile_attribution.items()}

    def compile_attribution_values(self) -> list[tuple[dict, float]]:
        """Collector callback: [({"bucket": key}, coldWallSeconds), ...]."""
        return [({"bucket": k}, v["coldWallSeconds"]) for k, v in self.compile_attribution().items()]

    def has_engine_for(self, shape, *, config: OptimizerConfig | None = None,
                       max_rf: int | None = None) -> bool:
        """True when an engine for (shape, max_rf, config) is cached,
        prewarmed ones included, of any max_rf when None: a caller skips
        the prewarm of a bucket that has one."""
        cfg = config or self.config
        with self._cache_lock:
            return any(k[0] == shape and k[2] == cfg and max_rf in (None, k[1])
                       for k in self._engines)

    def _result(self, state_before, state_after, out: dict, proposals, history, t0) -> OptimizerResult:
        """The OptimizerResult of a reported run's payload `out`."""
        pw, sw = self.balancedness_weights
        viol_b, viol_a = out["viol_before"], out["viol_after"]
        return OptimizerResult(
            proposals=proposals,
            state_before=state_before,
            state_after=state_after,
            stats_before=out["stats_before"],
            stats_after=out["stats_after"],
            goal_names=self.chain.names(),
            violations_before=viol_b,
            violations_after=viol_a,
            balancedness_before=balancedness_score(
                viol_b, self.chain, priority_weight=pw, strictness_weight=sw
            ),
            balancedness_after=balancedness_score(
                viol_a, self.chain, priority_weight=pw, strictness_weight=sw
            ),
            objective_before=float(out["obj_before"]),
            objective_after=float(out["obj_after"]),
            wall_seconds=time.monotonic() - t0,
            history=history,
        )

    def optimize(
        self,
        state: ClusterState,
        options: OptimizationOptions = DEFAULT_OPTIONS,
        *,
        verbose: bool = False,
        config: OptimizerConfig | None = None,
        initial_placement=None,
        prior=None,
    ) -> OptimizerResult:
        """Run the goal chain on `state` and diff the result into proposals.

        `initial_placement` (replica_broker, replica_is_leader,
        replica_disk) warm-starts the anneal from that placement; the
        proposals still diff against `state`'s own placement.  `prior`, the
        learned move-acceptance prior (a `PriorTable` of controller/prior.py,
        or anything with `.weights` f32[T, B] and `.mix`), steers the
        relocations' destination draws of a prior_enabled config.  With
        diagnostics, the timing record carries the run's `convergence`
        summary.  The before and after reports are f32 whatever the
        config's score_dtype; they ride the engine's reported run
        (`Engine.run_reported`), so the first call of an engine (a
        bucket) captures the graphs the streaming cycle replays.

        Unsupervised (the default) this is `_optimize_on_device`.
        Supervised, the whole device body runs inside one bounded,
        classified supervisor call, and a breaker already open skips the
        device entirely.  Classified failures (hang, OOM, a sticky CUDA
        error, a failed capture, transient errors past their retries) and
        an open breaker raise `DeviceDegradedError` on the card; on the
        CPU they are answered by the CPU greedy route
        (`_optimize_degraded`).  Application errors (bad states, bad
        option masks) and install faults (a kernel that does not build or
        cannot run on the card) propagate unchanged, so a malformed
        request can neither degrade the service nor be served a greedy
        answer.

        Traced: every call is an `analyzer.optimize` span carrying the
        run's timing record and its degradation verdict as attributes."""
        if state.device != self.device:
            raise ValueError(f"state is on {state.device}, the optimizer runs on {self.device}")
        cfg = config or self.config
        with self.tracer.span("analyzer.optimize", component="analyzer") as sp:
            if _BLACKBOX.enabled:
                # the dispatch context the black box's leaf records
                # (supervised, device-op, engine-slice) cannot know
                # themselves: which bucket and which search config
                ctx = blackbox_context(
                    bucket=bucket_key(state.shape),
                    config_fp=hashlib.sha1(repr(cfg).encode()).hexdigest()[:12],
                    parallel_mode="single",
                )
            else:
                ctx = contextlib.nullcontext()
            with ctx:
                result = self._optimize_routed(state, options, verbose, cfg,
                                               initial_placement=initial_placement, prior=prior)
            timing = next((h for h in result.history if h.get("timing")), {})
            sp.set(
                parallel_mode="single",
                degraded=result.degraded,
                wall_s=round(result.wall_seconds, 6),
                num_proposals=len(result.proposals),
                objective_after=round(result.objective_after, 6),
                balancedness_after=round(result.balancedness_after, 3),
                goal_violations_after={n: round(float(v), 6) for n, v in
                                       zip(result.goal_names, np.asarray(result.violations_after))},
                **{k: timing.get(k) for k in (
                    "device_s", "blocking_syncs", "host_extract_s", "engine_cache_hit",
                    "engine_build_s", "bucket", "segmented", "segments", "convergence",
                ) if timing.get(k) is not None},
            )
            return result

    def _optimize_routed(self, state: ClusterState, options: OptimizationOptions, verbose: bool,
                         cfg: OptimizerConfig, *, initial_placement=None,
                         prior=None) -> OptimizerResult:
        """The supervision routing: the device path under the supervisor;
        on an open breaker or a classified failure, the CPU greedy route
        where the state lies on the CPU, else the supervisor's error."""
        sup = self.supervisor
        if sup is None:
            return self._optimize_on_device(state, options, verbose=verbose, config=cfg,
                                            initial_placement=initial_placement, prior=prior)
        self._maybe_purge_after_open()
        degraded = None
        if self.device.type == "cpu":
            def degraded(reason, cause):
                return self._optimize_degraded(state, options, cfg, reason=reason, cause=cause)
        try:
            return sup.run(
                lambda: self._optimize_on_device(state, options, verbose=verbose, config=cfg,
                                                 initial_placement=initial_placement,
                                                 prior=prior),
                op="optimize", degraded=degraded,
            )
        finally:
            self._maybe_purge_after_open()

    def _optimize_on_device(self, state: ClusterState, options: OptimizationOptions, *,
                            verbose: bool = False, config: OptimizerConfig | None = None,
                            initial_placement=None, prior=None) -> OptimizerResult:
        """The device path."""
        t0 = time.monotonic()
        cfg = config or self.config
        input_checks = validate_on_device(state).cpu().numpy()
        if input_checks.any():
            validate(state)  # raises with per-invariant detail
            bad = [n for n, c in zip(DEVICE_CHECKS, input_checks) if c]
            raise ValueError(f"input state failed sanity checks: {bad}")
        t_build = time.monotonic()
        with self._engine_for(state, options, cfg, prior=prior) as (engine, hit):
            build_s = time.monotonic() - t_build
            before_host = fetch_before_host(state)
            with profiler_trace(self.profiler_dir):
                final, history, out = engine.run_reported(verbose=verbose,
                                                          initial_placement=initial_placement)
            max_rf = engine.max_rf
        t_extract = time.monotonic()
        proposals = extract_proposals(state, final, before_host=before_host, after_host=out)
        timing = next(h for h in history if h.get("timing"))
        timing["host_extract_s"] = round(time.monotonic() - t_extract, 6)
        timing["engine_cache_hit"] = hit
        timing["engine_build_s"] = round(build_s, 6)
        s = state.shape
        timing["bucket"] = dict(R=s.R, B=s.B, P=s.P, T=s.num_topics, max_rf=max_rf)
        if timing.get("captured"):
            self._attribute(s, coldWallSeconds=time.monotonic() - t0)
        if out["checks"].any():
            bad = [n for n, c in zip(DEVICE_CHECKS, out["checks"]) if c]
            validate(final)
            raise ValueError(f"optimized state failed sanity checks: {bad}")
        return self._result(state, final, out, proposals, history, t0)

    def _maybe_purge_after_open(self) -> None:
        """Drop the cached engines once per breaker-open transition: a card
        that just failed owns buffers of unknown integrity, and recovery
        rebuilds engines fresh rather than rebinding onto them.  An engine
        a run still pins (a hung run's abandoned worker holds one) is
        dropped from the cache and released at its last unpin; the others
        are released now.

        Where the card's context is lost (`DeviceSupervisor.context_lost`:
        a sticky CUDA error), the engines are dropped from the cache but
        never released nor freed: every CUDA call fails in that context,
        and the destructors of captured graphs and pinned buffers raise
        from C++, which aborts the process.  They are kept referenced for
        the process's life, which needs a restart to use the card again;
        until then its answers are degraded."""
        sup = self.supervisor
        if sup is None or sup.open_epoch == self._breaker_epoch:
            return
        free = []
        with self._cache_lock:
            if sup.open_epoch == self._breaker_epoch:
                return
            self._breaker_epoch = sup.open_epoch
            if sup.context_lost:
                self._abandoned_engines.extend(self._engines.values())
            else:
                for engine in self._engines.values():
                    engine._cc_evicted = True
                    if engine._cc_pins == 0:
                        free.append(engine)
            self._engines.clear()
            self._bound.clear()
        for engine in free:
            engine.release()
        self._sense_cache(None)

    def _report_host(self, st: ClusterState):
        """(objective, violations f32[G], ClusterStats) of a host state,
        the reports of the degraded route: the chain and the stats on the
        CPU, as the engine's report graphs compute them on the card."""
        agg = compute_aggregates(st, st.members)
        obj, viol, _ = self.chain.evaluate(st, agg=agg, constraint=self.constraint)
        return np.float32(obj), viol.numpy(), compute_stats(st, agg)

    def _optimize_degraded(self, state: ClusterState, options: OptimizationOptions,
                           cfg: OptimizerConfig, *, reason: str, cause=None) -> OptimizerResult:
        """The degraded answer of a state on the CPU: the CPU greedy oracle
        (analyzer/greedy.py, `device="cpu"`) under `degraded_budget_s` and
        with the options' exclusions, and the before and after reports on
        the CPU.  A state on the card is refused: its work is never moved
        to the CPU.

        The result is a real OptimizerResult tagged with a `degraded`
        history record (reason, failure, the greedy's info), so callers
        can tell a greedy answer from the device path's."""
        if state.device.type != "cpu":
            raise RuntimeError(
                f"no degraded answer for a state on {state.device}: work on the card is "
                "never moved to the CPU") from cause
        t0 = time.monotonic()
        # the device path's input contract: a rejected state raises with
        # per-invariant detail instead of being greedily "optimized"
        validate(state)
        final, info = greedy_optimize(state, self.chain, self.constraint, seed=cfg.seed,
                                      time_budget_s=self.degraded_budget_s, return_info=True,
                                      device="cpu", options=options)
        obj_b, viol_b, stats_b = self._report_host(state)
        obj_a, viol_a, stats_a = self._report_host(final)
        t_extract = time.monotonic()
        proposals = extract_proposals(state, final)
        s = state.shape
        history = [dict(
            timing=True, degraded=True, reason=reason,
            failure=(repr(cause) if cause is not None else None), greedy=info,
            host_extract_s=round(time.monotonic() - t_extract, 6),
            bucket=dict(R=s.R, B=s.B, P=s.P, T=s.num_topics),
        )]
        if self.sensors is not None:
            self.sensors.counter("analyzer.degraded-proposals").inc()
        out = dict(viol_before=viol_b, viol_after=viol_a, stats_before=stats_b,
                   stats_after=stats_a, obj_before=obj_b, obj_after=obj_a)
        return self._result(state, final, out, proposals, history, t0)

    def optimize_streaming_cycle(
        self,
        state: ClusterState,
        *,
        rows,
        leader_loads,
        follower_loads,
        initial_placement,
        options: OptimizationOptions = DEFAULT_OPTIONS,
        config: OptimizerConfig | None = None,
        prior=None,
        before_host: dict | None = None,
    ):
        """The steady-state streaming cycle as ONE run with ONE blocking
        sync (Engine.run_cycle): the window's scatter, the warm re-anneal,
        the before and after reports, the device checks and the proposal
        payload.

        `state` is the live state (models/whatif.py LiveState): the cycle
        runs on the engine that the last `optimize` of (state.shape,
        config) bound, which keeps that generation's statics (the live
        cluster's, unchanged between reflattens), and `options`
        is accepted for the staged path's signature only.  `rows`,
        `leader_loads` and `follower_loads` are the window (i32[n] replica
        rows, f32[n, 4] each); `initial_placement` the warm start, device
        tensors of the state's dtypes (a previous result's state_after
        placement); `prior` the learned prior, refreshed into the engine as
        data (`Engine.rebind_prior`), never a rebind.

        Returns `(OptimizerResult, (new_ll, new_fl))`: `state`'s own load
        tensors, scattered in place, which the caller adopts as the live
        pair (`LiveState.adopt_loads`); or None when that engine is not
        cached (none was bound, or it was evicted) — the caller then
        takes the staged path
        (`LiveState.set_partition_loads` + `optimize`), which builds and
        caches one, so the NEXT cycle goes fused.

        `before_host` is the caller's reflatten-time placement cache
        (fetch_before_host of the live state): placement columns do not
        change between reflattens, so only `replica_disk_bytes`, which the
        scatter just changed, is refreshed, from the cycle's payload.  The
        result's state_after placement columns are copies on the engine's
        device, ready as the next cycle's warm start.  Raises on failed
        final checks.

        Under a supervisor it returns None while the breaker is open (the
        staged path then meets the breaker: `BreakerOpenError` on the
        card, a degraded answer on the CPU); the cycle itself is not supervised, as
        in the JAX package: it needs an engine that a supervised `optimize`
        built, and a failure after the window's scatter into the live
        tensors can only be recovered by a reflatten, whose accounting is
        the caller's."""
        if state.device != self.device:
            raise ValueError(f"state is on {state.device}, the optimizer runs on {self.device}")
        sup = self.supervisor
        if sup is not None and not sup.available():
            return None
        cfg = config or self.config
        with self._cache_lock:
            rf = self._bound.get((state.shape, cfg))
            engine = None if rf is None else self._pin((state.shape, rf, cfg))
            if engine is None:
                return None
            self.engine_cache_hits += 1
        self._sense_cache(True)
        t0 = time.monotonic()
        try:
            with engine.locked():
                engine.rebind_prior(prior)
                ll, fl, out, history = engine.run_cycle(
                    state.replica_load_leader, state.replica_load_follower, rows, leader_loads,
                    follower_loads, initial_placement,
                )
                max_rf = engine.max_rf
        finally:
            self._unpin(engine)
        if out["checks"].any():
            bad = [n for n, c in zip(DEVICE_CHECKS, out["checks"]) if c]
            raise ValueError(f"optimized state failed sanity checks: {bad}")
        # the BEFORE state is the live state with the scattered loads; the
        # AFTER state adds the final placement (device copies)
        state_before = dataclasses.replace(state, replica_load_leader=ll, replica_load_follower=fl)
        rb, il, dk, off = out["placement"]
        state_after = dataclasses.replace(state_before, replica_broker=rb, replica_is_leader=il,
                                          replica_disk=dk, replica_offline=off)
        t_extract = time.monotonic()
        if before_host is not None:
            before_host = dict(before_host, replica_disk_bytes=out["replica_disk_bytes"])
        else:
            before_host = fetch_before_host(state_before)
        proposals = extract_proposals(state_before, state_after, before_host=before_host,
                                      after_host=out)
        timing = next(h for h in history if h.get("timing"))
        timing["host_extract_s"] = round(time.monotonic() - t_extract, 6)
        timing["engine_cache_hit"] = True
        timing["engine_build_s"] = 0.0
        s = state.shape
        timing["bucket"] = dict(R=s.R, B=s.B, P=s.P, T=s.num_topics, max_rf=max_rf)
        return self._result(state_before, state_after, out, proposals, history, t0), (ll, fl)
