"""Application configuration — domain-grouped, reference-compatible keys.

Reference: config/KafkaCruiseControlConfig.java:38 (chained define across
domain constant classes) with the domain groups AnalyzerConfig.java,
MonitorConfig.java, ExecutorConfig.java, AnomalyDetectorConfig.java,
WebServerConfig.java.  Key names match the reference's where the concept
carries over, so existing cruisecontrol.properties files remain readable;
TPU-specific knobs (candidate batch etc.) are new keys under the
`analyzer.tpu` group.

The same keys, defaults, validators and messages as the JAX package's
config/app_config.py, `tpu.*` names included, so one properties file loads
in both packages with the same values.  The accessors build this
package's objects.  `tpu.prewarm.aot.enabled` parses and has no effect.
"""

from __future__ import annotations

from typing import Any

# NOTE: analyzer modules import config.balancing; importing analyzer at
# module scope here would close an import cycle through the package
# __init__s, so goal/optimizer symbols are imported lazily inside functions.
from cruise_control_tpu_torch.config.balancing import BalancingConstraint
from cruise_control_tpu_torch.config.config_def import (
    AbstractConfig,
    ConfigDef,
    ConfigException,
    ConfigType as T,
    Importance as I,
    in_range,
    in_values,
)

_HARD_GOALS_DEFAULT = (
    "RackAwareGoal,ReplicaCapacityGoal,DiskCapacityGoal,NetworkInboundCapacityGoal,"
    "NetworkOutboundCapacityGoal,CpuCapacityGoal"
)


def _analyzer_defs() -> ConfigDef:
    """Reference config/constants/AnalyzerConfig.java."""
    from cruise_control_tpu_torch.analyzer.goals import DEFAULT_GOAL_ORDER

    d = ConfigDef()
    g = "analyzer"
    d.define("default.goals", T.LIST, ",".join(DEFAULT_GOAL_ORDER), I.HIGH,
             "goal names in priority order", group=g)
    d.define("hard.goals", T.LIST, _HARD_GOALS_DEFAULT, I.HIGH, "hard goal subset", group=g)
    for res in ("cpu", "disk", "network.inbound", "network.outbound"):
        d.define(f"{res}.balance.threshold", T.DOUBLE, 1.10, I.MEDIUM,
                 f"balance band multiplier for {res}", in_range(lo=1.0), group=g)
        d.define(f"{res}.capacity.threshold", T.DOUBLE, 0.8, I.MEDIUM,
                 f"usable capacity fraction for {res}", in_range(lo=0.0, hi=1.0), group=g)
        d.define(f"{res}.low.utilization.threshold", T.DOUBLE, 0.0, I.LOW,
                 f"below this the {res} balance is ignored", group=g)
    d.define("replica.count.balance.threshold", T.DOUBLE, 1.10, I.MEDIUM,
             "replica count band multiplier", in_range(lo=1.0), group=g)
    d.define("leader.replica.count.balance.threshold", T.DOUBLE, 1.10, I.MEDIUM,
             "leader count band multiplier", in_range(lo=1.0), group=g)
    d.define("topic.replica.count.balance.threshold", T.DOUBLE, 3.0, I.LOW,
             "per-topic replica band multiplier", in_range(lo=1.0), group=g)
    d.define("max.replicas.per.broker", T.LONG, 10_000, I.MEDIUM,
             "replica capacity per broker", in_range(lo=1), group=g)
    d.define("proposal.expiration.ms", T.LONG, 900_000, I.MEDIUM,
             "cached proposal validity", in_range(lo=0), group=g)
    d.define("goal.violation.distribution.threshold.multiplier", T.DOUBLE, 1.0, I.LOW,
             "slack multiplier for violation detection", in_range(lo=1.0), group=g)
    d.define("num.proposal.precompute.threads", T.INT, 1, I.LOW,
             "proposal precompute workers", in_range(lo=0), group=g)
    d.define("goal.balancedness.priority.weight", T.DOUBLE, 1.1, I.LOW,
             "weight multiplier between adjacent goal priorities in the "
             "balancedness score (reference "
             "KafkaCruiseControlUtils.balancednessCostByGoal:511-537)",
             in_range(lo=1.0), group=g)
    d.define("goal.balancedness.strictness.weight", T.DOUBLE, 1.5, I.LOW,
             "extra weight of hard goals in the balancedness score",
             in_range(lo=1.0), group=g)
    d.define("topics.excluded.from.partition.movement", T.STRING, "", I.MEDIUM,
             "regex of topics whose replicas never move in ANY optimization "
             "(merged with per-request excluded_topics; reference "
             "AnalyzerConfig topics.excluded.from.partition.movement)", group=g)
    d.define("allow.capacity.estimation.on.proposal.precompute", T.BOOLEAN, True,
             I.LOW, "precompute models may estimate missing broker capacities",
             group=g)
    from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER

    d.define("intra.broker.goals", T.LIST,
             ",".join(DEFAULT_INTRA_BROKER_GOAL_ORDER), I.MEDIUM,
             "goal chain for rebalance_disk (JBOD) operations "
             "(reference AnalyzerConfig.java:236)", group=g)
    # --- mixed-precision goal scoring (new in this framework) ---
    def _valid_score_dtype(name, value):
        if str(value) not in ("float32", "bfloat16"):
            raise ConfigException(
                f"{name} must be 'float32' or 'bfloat16', got {value!r}"
            )

    d.define("analyzer.precision.score.dtype", T.STRING, "float32", I.MEDIUM,
             "accumulation dtype of the goal-score inner loops (per-broker "
             "term sums and the weighted objective reduction); 'bfloat16' "
             "halves accumulator bandwidth on the annealer's hot path, "
             "'float32' (default) pins today's graphs bit-for-bit — "
             "reports, violations and proposal scoring stay float32 "
             "either way", _valid_score_dtype, group=g)
    d.define("analyzer.precision.tolerance", T.DOUBLE, 0.02, I.LOW,
             "relative objective-quality tolerance the bfloat16 scoring "
             "path must hold against the float32 reference (the parity "
             "gate tests/benches assert before the low-precision path is "
             "trusted)", in_range(lo=0.0), group=g)
    # --- TPU optimizer knobs (new in this framework) ---
    g = "analyzer.tpu"
    d.define("tpu.num.candidates", T.INT, 2048, I.MEDIUM,
             "candidate moves evaluated per optimization step", in_range(lo=16), group=g)
    d.define("tpu.leadership.candidates", T.INT, 512, I.MEDIUM,
             "of which leadership transfers", in_range(lo=0), group=g)
    d.define("tpu.swap.candidates", T.INT, 512, I.MEDIUM,
             "of which replica swaps (clamped to half the non-leadership budget)",
             in_range(lo=0), group=g)
    d.define("tpu.steps.per.round", T.INT, 64, I.MEDIUM, "scan length per round",
             in_range(lo=1), group=g)
    d.define("tpu.num.rounds", T.INT, 10, I.MEDIUM, "annealing rounds", in_range(lo=1), group=g)
    d.define("tpu.init.temperature.scale", T.DOUBLE, 1e-2, I.LOW,
             "T0 as fraction of initial objective", group=g)
    d.define("tpu.temperature.decay", T.DOUBLE, 0.5, I.LOW, "per-round decay", group=g)
    d.define("tpu.replica.move.cost", T.DOUBLE, 0.5, I.MEDIUM,
             "objective price per replica moved off its original broker",
             in_range(lo=0.0), group=g)
    d.define("tpu.leadership.move.cost", T.DOUBLE, 1.0, I.MEDIUM,
             "objective price per partition leadership moved off its original leader",
             in_range(lo=0.0), group=g)
    d.define("tpu.importance.fraction", T.DOUBLE, 0.5, I.LOW,
             "fraction of candidates importance-sampled toward violating brokers",
             in_range(lo=0.0, hi=1.0), group=g)
    def _valid_parallel_mode(name, value):
        from cruise_control_tpu_torch.analyzer.optimizer import parse_parallel_mode

        try:
            parse_parallel_mode(str(value))
        except ValueError as e:
            raise ConfigException(f"{name}: {e}") from e

    d.define("tpu.parallel.mode", T.STRING, "single", I.MEDIUM,
             "multi-device strategy: single / sharded (candidate axis "
             "sharded over the mesh, parallel/mesh.py) / grid:RxM "
             "(restart portfolio over model shards)",
             _valid_parallel_mode, group=g)
    d.define("tpu.mesh.max.devices", T.INT, 0, I.MEDIUM,
             "cap on the devices the mesh engine layer builds its mesh "
             "from for sharded/grid parallel modes (0 = every visible "
             "device) — lets operators keep chips free for other tenants "
             "or pin a power-of-two shard count", in_range(lo=0), group=g)
    d.define("tpu.mesh.model.shard.min.partitions", T.INT, 500_000, I.MEDIUM,
             "partition count at which the mesh engine layer shards the "
             "flattened model itself over the model axis (contiguous "
             "replica/partition row blocks per chip, broker aggregates "
             "psum-assembled) instead of replicating it — per-chip model "
             "memory and per-step row FLOPs drop ~1/n while placements "
             "stay byte-identical; below the threshold the replicated "
             "model wins on collective volume (0 = never shard the model)",
             in_range(lo=0), group=g)
    d.define("tpu.mesh.ft.enabled", T.BOOLEAN, True, I.MEDIUM,
             "mesh fault tolerance (parallel/ft.py): on a classified mesh "
             "failure (device lost / collective stall) the optimizer "
             "rebuilds the mesh over the surviving devices at the next "
             "lower power-of-two width and resumes from the last carry "
             "checkpoint, under per-width breakers that never open the "
             "single-device breaker; false restores the pre-FT behavior "
             "(any mesh failure degrades straight to the CPU greedy "
             "fallback)", group=g)
    d.define("tpu.mesh.ft.checkpoint.every.slices", T.INT, 0, I.MEDIUM,
             "capture a host-side carry checkpoint every N slice "
             "boundaries of a segmented mesh anneal (one in-flight "
             "snapshot, capture wall excluded from the supervisor's hang "
             "budget) so a degrade-and-resume continues the round "
             "schedule instead of restarting it; 0 (default) disables "
             "checkpointing — byte-for-byte the uncheckpointed dispatch "
             "stream", in_range(lo=0), group=g)
    d.define("tpu.shape.bucket.enabled", T.BOOLEAN, True, I.MEDIUM,
             "round cluster-model shapes (replicas/brokers/partitions/"
             "topics/racks/hosts) up to geometric buckets so compiled "
             "engines survive topology churn — partition creates and "
             "broker adds within a bucket rebind the cached engine with "
             "zero recompilation", group=g)
    d.define("tpu.shape.bucket.growth", T.DOUBLE, 1.25, I.MEDIUM,
             "bucket growth factor between adjacent shape buckets; larger "
             "values recompile less often but pad (and compute over) more",
             in_range(lo=1.01), group=g)
    d.define("tpu.shape.bucket.floor", T.INT, 8, I.LOW,
             "smallest shape bucket (series base)", in_range(lo=1), group=g)
    d.define("tpu.engine.cache.size", T.INT, 8, I.MEDIUM,
             "max compiled engines kept per optimizer (LRU; evicted "
             "engines' device buffers are released) — bounds HBM growth "
             "across shape-bucket transitions", in_range(lo=1), group=g)
    d.define("tpu.compilation.cache.dir", T.STRING,
             "~/.cache/cruise_control_tpu/xla", I.LOW,
             "persistent XLA compilation cache directory; empty disables "
             "(compiled programs survive service restarts)", group=g)
    d.define("tpu.compile.cache.dir", T.STRING, None, I.LOW,
             "preferred spelling of tpu.compilation.cache.dir (takes "
             "precedence when both are set): the on-disk XLA executable "
             "cache a restarted service/controller reloads instead of "
             "re-tracing unchanged shape buckets; boot logs the cache's "
             "entry count and the first proposal pass logs how many "
             "executables were compiled fresh (misses) vs available warm",
             group=g)
    # --- supervised optimizer runtime (common/device_watchdog.py) ---
    g = "analyzer.tpu.supervisor"
    d.define("tpu.supervisor.enabled", T.BOOLEAN, True, I.MEDIUM,
             "run every service-path engine invocation under the device "
             "supervisor: bounded budget, failure classification "
             "(hang/compile/OOM/transient), retry, circuit breaker with "
             "CPU-greedy degraded mode while the breaker is open", group=g)
    d.define("tpu.supervisor.op.timeout.s", T.DOUBLE, 300.0, I.MEDIUM,
             "hard wall-clock budget per supervised engine invocation; a "
             "call not finished by then is classified as a device HANG "
             "(observed MULTICHIP_r05: a wedged runtime hangs every op)",
             in_range(lo=0.001), group=g)
    d.define("tpu.supervisor.max.retries", T.INT, 2, I.LOW,
             "retries (with jittered backoff) for TRANSIENT-classified "
             "failures before one operation-level failure is counted "
             "toward the breaker", in_range(lo=0), group=g)
    d.define("tpu.supervisor.retry.backoff.ms", T.LONG, 250, I.LOW,
             "base of the full-jitter exponential retry backoff",
             in_range(lo=1), group=g)
    d.define("tpu.supervisor.retry.backoff.max.ms", T.LONG, 5_000, I.LOW,
             "cap of the retry backoff", in_range(lo=1), group=g)
    d.define("tpu.supervisor.breaker.failure.threshold", T.INT, 3, I.MEDIUM,
             "consecutive classified operation failures that open the "
             "circuit breaker (degraded CPU-greedy serving starts)",
             in_range(lo=1), group=g)
    d.define("tpu.supervisor.probe.interval.s", T.DOUBLE, 30.0, I.MEDIUM,
             "while the breaker is open, one half-open recovery probe "
             "(the trivial-op watchdog) runs at most this often",
             in_range(lo=0.0), group=g)
    d.define("tpu.supervisor.probe.timeout.s", T.DOUBLE, 20.0, I.LOW,
             "budget for the half-open recovery probe",
             in_range(lo=0.001), group=g)
    d.define("tpu.supervisor.degraded.greedy.budget.s", T.DOUBLE, 30.0, I.MEDIUM,
             "wall-clock budget for the CPU greedy fallback that serves "
             "proposals while the breaker is open", in_range(lo=0.001),
             group=g)
    # --- opt-in device profiling (common/profiling.py) ---
    g = "analyzer.tpu.profiler"
    d.define("tpu.profiler.enabled", T.BOOLEAN, False, I.LOW,
             "wrap every engine run in a torch.profiler trace dumped to "
             "tpu.profiler.dump.dir — the kernel-level timeline for "
             "slow-run forensics (a Chrome trace).  Costs "
             "real time and disk per run; keep off outside an "
             "investigation", group=g)
    d.define("tpu.profiler.dump.dir", T.STRING,
             "/tmp/cruise-control-tpu-profiler", I.LOW,
             "directory torch.profiler trace dumps land in when "
             "tpu.profiler.enabled is on", group=g)
    # --- boot prewarm manifest + AOT programs (analyzer/prewarm.py) ---
    g = "analyzer.tpu.prewarm"
    d.define("tpu.prewarm.enabled", T.BOOLEAN, True, I.MEDIUM,
             "persist the active engine working set (bucketed shape + "
             "search config) to a durable manifest on every engine "
             "build, and replay it on start_up so a restarted service's "
             "active buckets are compiling BEFORE the first proposal is "
             "needed — the cold-start-to-first-proposal SLO "
             "(bench.py --coldstart)", group=g)
    d.define("tpu.prewarm.manifest.dir", T.STRING, None, I.LOW,
             "directory of the boot-prewarm manifest and AOT-serialized "
             "engine programs; unset derives the 'prewarm' subdirectory "
             "inside the persistent XLA compile cache "
             "(tpu.compile.cache.dir — same mount, one durability "
             "story; the cache's boot inventory prunes it), empty "
             "disables prewarm even when tpu.prewarm.enabled is on",
             group=g)
    d.define("tpu.prewarm.aot.enabled", T.BOOLEAN, True, I.MEDIUM,
             "no effect in this package, kept so a properties file of "
             "the JAX package loads unchanged: a captured CUDA graph "
             "holds one process's device addresses and cannot be "
             "serialized, so there is no ahead-of-time artifact; the "
             "on-disk artifact is the kernel build cache", group=g)
    d.define("tpu.prewarm.max.entries", T.INT, 6, I.LOW,
             "manifest entries kept (most-recently-used buckets win) — "
             "bounds how many engines a boot prewarm compiles",
             in_range(lo=1), group=g)
    # --- convergence diagnostics + decision ledger + calibration ---
    g = "analyzer.diagnostics"
    d.define("analyzer.diagnostics.enabled", T.BOOLEAN, True, I.MEDIUM,
             "compile convergence diagnostics into the fused anneal: "
             "per-round objective trajectory, per-goal violation vector "
             "at round boundaries, acceptance counts by move kind and "
             "prior-draw usage ride the run's existing single host "
             "extraction (zero extra blocking syncs) into "
             "OptimizerResult.history, the analyzer.optimize span, and "
             "the decision ledger.  Placements are byte-identical either "
             "way (pinned); false restores today's outputs bit-for-bit",
             group=g)
    g = "analyzer.ledger"
    d.define("analyzer.ledger.enabled", T.BOOLEAN, True, I.MEDIUM,
             "durably record one `decision` record per published "
             "proposal (trace id, generation, bucket + config "
             "fingerprint, per-goal pre/post scores, predicted load, "
             "per-move features, convergence summary) into an "
             "append-only crash-tolerant JSONL ledger, joined by an "
             "`outcome` record at execution completion and a "
             "`calibration` record once the next complete metric window "
             "measures what the moves actually did — the training "
             "corpus for learned optimization and the GET /explain "
             "surface.  Needs a durable directory (analyzer.ledger.dir, "
             "or derived from executor.journal.dir); without one the "
             "ledger stays off and writes zero bytes", group=g)
    d.define("analyzer.ledger.dir", T.STRING, None, I.LOW,
             "directory of the decision ledger (decision-ledger.jsonl; "
             "fleet deployments namespace one subdirectory per "
             "cluster).  Unset derives '_ledger' inside "
             "executor.journal.dir — decisions must survive exactly the "
             "crashes the journal survives; explicitly empty disables",
             group=g)
    d.define("analyzer.ledger.retention.count", T.INT, 32, I.LOW,
             "rotated ledger archives kept (newest first); archives "
             "holding a decision whose outcome is still pending are "
             "never pruned", in_range(lo=1), group=g)
    d.define("analyzer.ledger.retention.hours", T.DOUBLE, 336.0, I.LOW,
             "age bound on rotated ledger archives (hours); the live "
             "file and pending-outcome episodes are never pruned",
             in_range(lo=0.1), group=g)
    g = "analyzer.calibration"
    d.define("analyzer.calibration.enabled", T.BOOLEAN, True, I.MEDIUM,
             "after an executed proposal's moves land and the next "
             "complete metric window rolls, score the MEASURED cluster "
             "state through the same goal chain (one batched "
             "ScenarioEvaluator dispatch) and append a calibration "
             "record — predicted vs realized per-goal scores and "
             "per-broker load prediction error — to the decision "
             "ledger, the analyzer.calibration.* sensors and the /fleet "
             "per-cluster rollup.  No-op while the ledger is off",
             group=g)
    d.define("analyzer.calibration.drift.threshold", T.DOUBLE, 0.05, I.MEDIUM,
             "mean absolute per-goal prediction error (worst goal, over "
             "the last drift.min.samples calibrated executions) past "
             "which one alert-only MODEL_DRIFT anomaly fires per "
             "episode through the detector/notifier; the episode "
             "re-arms when the mean falls back under the threshold",
             in_range(lo=0.0), group=g)
    d.define("analyzer.calibration.drift.min.samples", T.INT, 3, I.LOW,
             "calibrated executions required before MODEL_DRIFT may "
             "fire (one bad sample is noise, not drift)",
             in_range(lo=1), group=g)
    return d


def _controller_defs() -> ConfigDef:
    """Streaming-controller keys (controller/streaming.py — no reference
    analog: the reference recomputes proposals from scratch on a timer)."""
    d = ConfigDef()
    g = "controller"
    d.define("controller.enabled", T.BOOLEAN, False, I.MEDIUM,
             "run the always-on streaming controller: the flattened "
             "cluster model stays device-resident, metric-window deltas "
             "apply in place (no re-flatten while the shape bucket holds) "
             "and every window roll re-anneals incrementally — warm-"
             "started from the previous accepted placement and the "
             "learned move-acceptance prior — publishing into the "
             "proposal cache.  Replaces the legacy proposal-precompute "
             "loop while on", group=g)
    d.define("controller.poll.interval.ms", T.LONG, 1_000, I.MEDIUM,
             "how often the controller checks the partition aggregator "
             "for a rolled metric window (cheap generation reads; the "
             "expensive work only runs on an actual roll)",
             in_range(lo=10), group=g)
    d.define("controller.warm.start.enabled", T.BOOLEAN, True, I.MEDIUM,
             "seed each incremental anneal's carry from the previous "
             "accepted placement instead of the current cluster placement "
             "(movement pricing still charges strays against the real "
             "cluster); off = every anneal is cold", group=g)
    d.define("controller.delta.enabled", T.BOOLEAN, True, I.MEDIUM,
             "apply metric-window deltas to the device-resident model in "
             "place; off forces a full model re-flatten every window roll "
             "(the parity/diagnosis mode the streaming bench gates "
             "against)", group=g)
    d.define("controller.fusion.enabled", T.BOOLEAN, True, I.MEDIUM,
             "fuse delta-scatter + warm re-anneal + proposal extraction "
             "into ONE donated device program per steady-state window "
             "roll (one dispatch, one host extraction); off pins the "
             "staged scatter-then-anneal path bit-for-bit — the fusion "
             "parity/diagnosis mode", group=g)
    d.define("controller.plan.sizing.enabled", T.BOOLEAN, True, I.MEDIUM,
             "size each steady-state cycle's candidate plan from the "
             "delta's changed-partition count (quantized to 1/2, 1/4 or "
             "1/8 of the configured width — bounded compile count, "
             "brownout-style); reflatten cycles always run full-K; off "
             "pins full-K every cycle", group=g)
    d.define("controller.plan.candidates.per.partition", T.INT, 16, I.LOW,
             "candidate-plan width budgeted per changed partition when "
             "delta-sized plans are on; the needed width is "
             "max(plan.min.candidates, changed x this) before "
             "quantization", in_range(lo=1), group=g)
    d.define("controller.plan.min.candidates", T.INT, 256, I.LOW,
             "floor on the delta-sized candidate need, so tiny deltas "
             "still explore a meaningful neighborhood",
             in_range(lo=1), group=g)
    d.define("controller.prior.mix", T.DOUBLE, 0.5, I.MEDIUM,
             "fraction of the annealer's replica-move DESTINATION draws "
             "taken from the learned per-topic-pair move-acceptance "
             "prior once it is ready; 0 disables prior sampling entirely "
             "(the engine program stays byte-identical to the request "
             "path's)", in_range(lo=0.0, hi=1.0), group=g)
    d.define("controller.prior.decay", T.DOUBLE, 0.9, I.LOW,
             "exponential decay applied to the prior's acceptance counts "
             "per observation batch, so stale traffic patterns fade",
             in_range(lo=0.01, hi=1.0), group=g)
    d.define("controller.prior.min.observations", T.INT, 64, I.LOW,
             "decayed (topic, destination) observations required before "
             "the prior's mix turns on; below it the prior is COLD and "
             "destination draws reproduce the uniform stream byte-for-"
             "byte", in_range(lo=0), group=g)
    return d


def _observability_defs() -> ConfigDef:
    """Flight recorder + Prometheus exposition keys (common/trace.py,
    common/exposition.py — no reference analog: the reference's
    observability is JMX sensors only)."""
    d = ConfigDef()
    g = "observability.trace"
    d.define("trace.enabled", T.BOOLEAN, True, I.MEDIUM,
             "record flight-recorder spans for every pipeline stage "
             "(model build, optimize, device ops, execution, planner, "
             "detector) — served by GET /trace; async responses carry "
             "_traceId.  Overhead is gated <2% of a smoke proposal run "
             "(scripts/check.sh)", group=g)
    d.define("trace.retention.spans.per.component", T.INT, 512, I.LOW,
             "bounded ring-buffer size PER COMPONENT (service/monitor/"
             "analyzer/device/executor/planner/detector) — a chatty "
             "component evicts its own history, never another's; a trace "
             "expires when its spans age out of every ring",
             in_range(lo=16), group=g)
    d.define("trace.max.events.per.span", T.INT, 512, I.LOW,
             "events kept per span (task transitions, retries, breaker "
             "flips); beyond it events are counted as dropped, not kept — "
             "a 100k-task execution must not hold 100k dicts",
             in_range(lo=8), group=g)
    g = "observability.metrics"
    d.define("metrics.prometheus.namespace", T.STRING, "cruisecontrol",
             I.LOW,
             "metric-name prefix of the GET /metrics Prometheus "
             "exposition (sensor catalog names are sanitized beneath it)",
             lambda n, v: None if __import__("re").fullmatch(
                 r"[a-zA-Z_][a-zA-Z0-9_]*", str(v)
             ) else (_ for _ in ()).throw(ConfigException(
                 f"{n}={v!r} is not a valid Prometheus name prefix")),
             group=g)
    # --- black-box dispatch spool (common/blackbox.py) ---
    g = "observability.blackbox"
    d.define("blackbox.enabled", T.BOOLEAN, True, I.MEDIUM,
             "record every device dispatch (supervised calls, engine "
             "runs, segmented-anneal slices, scheduler grants, "
             "controller cycles) to a crash/hang-durable on-disk JSONL "
             "ring spool — a hung or killed process leaves a readable "
             "'last dispatch in flight' trail instead of a bare return "
             "code.  Needs a durable directory (blackbox.dir, or derived "
             "from executor.journal.dir / tpu.compile.cache.dir); "
             "without one the recorder stays off.  Overhead is gated "
             "<2% of a smoke proposal run (bench.py "
             "--blackbox-overhead)", group=g)
    d.define("blackbox.dir", T.STRING, None, I.LOW,
             "directory of the black-box spool files "
             "(spool-<pid>.jsonl).  Unset derives '_blackbox' inside "
             "executor.journal.dir (the service's durable mount), "
             "falling back to a 'blackbox' subdirectory of the "
             "persistent compile cache; explicitly empty disables",
             group=g)
    d.define("blackbox.spool.max.records", T.INT, 2048, I.LOW,
             "ring size: the active spool file rotates past this many "
             "records, keeping one previous generation — bounded disk "
             "forever", in_range(lo=64), group=g)
    d.define("blackbox.fsync.batch.records", T.INT, 32, I.LOW,
             "records between fsyncs.  Every record is flushed to the "
             "kernel synchronously (process death of any flavor cannot "
             "lose it); fsync batching only bounds what machine power "
             "loss could cost, exactly like the executor journal's "
             "batch knob", in_range(lo=1), group=g)
    # --- SLO registry + burn-rate alerting (common/slo.py) ---
    g = "observability.slo"
    d.define("slo.enabled", T.BOOLEAN, True, I.MEDIUM,
             "continuously evaluate the service-level objectives "
             "(per-cluster proposal freshness against "
             "fleet.scheduler.freshness.slo.s, cold-start-to-first-"
             "proposal, streaming publish latency, urgent queue wait) "
             "with fast/slow multi-window error-budget burn rates; a "
             "sustained breach raises one alert-only SLO_BURN anomaly "
             "per episode through the detector/notifier and is served "
             "by GET /slo + Prometheus slo.* gauges", group=g)
    d.define("slo.tick.interval.s", T.DOUBLE, 5.0, I.LOW,
             "cadence of the background SLO evaluation loop (probes "
             "sampled, burn rates re-evaluated, episodes fired/cleared); "
             "GET /slo additionally evaluates on every scrape",
             in_range(lo=0.1), group=g)
    d.define("slo.burn.fast.window.s", T.DOUBLE, 300.0, I.MEDIUM,
             "fast burn-rate window: catches a new fire quickly; an "
             "episode fires only when BOTH windows burn past "
             "slo.burn.threshold", in_range(lo=1.0), group=g)
    d.define("slo.burn.slow.window.s", T.DOUBLE, 3600.0, I.MEDIUM,
             "slow burn-rate window: keeps one noisy sample from paging "
             "— must be >= the fast window",
             in_range(lo=1.0), group=g)
    d.define("slo.burn.threshold", T.DOUBLE, 10.0, I.MEDIUM,
             "error-budget burn multiple (1.0 = consuming the budget "
             "exactly at the sustainable rate) both windows must reach "
             "to open a breach episode", in_range(lo=1.0), group=g)
    d.define("slo.streaming.publish.target.s", T.DOUBLE, 1.0, I.MEDIUM,
             "good/bad threshold of the streaming-publish SLO: a window "
             "roll whose superseding proposal publishes within this wall "
             "is a good sample (ROADMAP item 4's sub-second control-loop "
             "target, measured by "
             "controller.window-roll-to-publish-seconds)",
             in_range(lo=0.001), group=g)
    d.define("slo.coldstart.target.s", T.DOUBLE, 60.0, I.MEDIUM,
             "good/bad threshold of the cold-start SLO: start_up to the "
             "first served/published proposal (PR 10's restart SLO, "
             "bench.py --coldstart), one sample per process",
             in_range(lo=0.1), group=g)
    return d


def _planner_defs() -> ConfigDef:
    """Scenario planner keys (no reference analog — the reference's
    provision analysis is a fixed single-hypothetical check)."""
    d = ConfigDef()
    g = "planner"
    d.define("planner.max.scenarios", T.INT, 32, I.MEDIUM,
             "cap on scenarios per /simulate batch (every scenario is a "
             "full padded cluster model on device)", in_range(lo=1), group=g)
    d.define("planner.simulate.optimize.default", T.BOOLEAN, False, I.LOW,
             "run the full anneal per scenario when /simulate omits the "
             "optimize parameter (projected post-fix view; slower)", group=g)
    d.define("planner.forecast.method", T.STRING, "linear", I.MEDIUM,
             "per-topic load trend fitter: linear (OLS over the windowed "
             "history) or holt (double exponential smoothing)",
             in_values("linear", "holt"), group=g)
    d.define("planner.forecast.horizons.ms", T.LIST, "3600000,21600000",
             I.MEDIUM, "horizons of the trend outlook every /rightsize "
             "response carries (fitted per-topic scale factors, no extra "
             "anneals; the full forecast VERDICT needs an explicit "
             "horizon_ms)", group=g)
    d.define("planner.forecast.min.windows", T.INT, 3, I.LOW,
             "completed windows a topic must have before its trend is "
             "trusted (fewer: the topic is left unforecast at factor 1.0)",
             in_range(lo=2), group=g)
    d.define("planner.forecast.max.factor", T.DOUBLE, 10.0, I.LOW,
             "clamp on projected per-topic load multipliers — a trend fit "
             "over a handful of noisy windows must not 1000x a topic",
             in_range(lo=1.0), group=g)
    d.define("planner.rightsize.min.brokers", T.INT, 1, I.MEDIUM,
             "floor of the rightsizing search (the replication-factor "
             "floor is always applied on top)", in_range(lo=1), group=g)
    d.define("planner.rightsize.max.broker.factor", T.DOUBLE, 2.0, I.MEDIUM,
             "ceiling of the rightsizing search as a multiple of the "
             "current broker count", in_range(lo=1.0), group=g)
    d.define("planner.rightsize.max.anneals", T.INT, 16, I.LOW,
             "full-anneal budget of one rightsize search; the binary "
             "search reports UNDECIDED when it runs out mid-bracket",
             in_range(lo=1), group=g)
    return d


#: cluster ids become journal subdirectories, sensor label values and
#: Prometheus label data — keep them filesystem- and exposition-safe
_CLUSTER_ID_RE = r"[A-Za-z0-9][A-Za-z0-9._-]*"


def _fleet_defs() -> ConfigDef:
    """Fleet controller keys (fleet/manager.py — no reference analog: one
    reference deployment watches exactly one Kafka cluster)."""
    import re

    def _valid_cluster_ids(name, value):
        for cid in value:
            if not re.fullmatch(_CLUSTER_ID_RE, cid):
                raise ConfigException(
                    f"{name}: cluster id {cid!r} must match {_CLUSTER_ID_RE} "
                    "(ids become journal subdirectories and metric labels)"
                )
            if cid == "ha":
                # fleet.ha.* are the HA keys themselves — a cluster named
                # "ha" would make its fleet.ha.<key> overrides ambiguous
                raise ConfigException(
                    f"{name}: cluster id 'ha' is reserved (fleet.ha.* are "
                    "the lease-ownership keys)"
                )
        if len(set(value)) != len(value):
            raise ConfigException(f"{name}: duplicate cluster ids in {value}")

    d = ConfigDef()
    g = "fleet"
    d.define("fleet.clusters", T.LIST, "", I.HIGH,
             "cluster ids this instance manages as a fleet; empty (the "
             "default) keeps the classic single-cluster deployment "
             "byte-for-byte unchanged.  Each id gets its own monitor, "
             "executor (journal under <executor.journal.dir>/<id>/), "
             "detector and sample stream behind ONE shared optimizer + "
             "device supervisor + compiled-engine cache; per-cluster "
             "overrides ride fleet.<id>.<key> keys (e.g. "
             "fleet.east.bootstrap.servers) over the base config — "
             "cluster-scoped keys only: overriding a shared-core or "
             "webserver key (tpu.*, default.goals, balance/capacity "
             "thresholds, planner.*, trace.*, webserver.*, ...) is "
             "rejected because the fleet builds those once from the base",
             _valid_cluster_ids, group=g)
    d.define("fleet.tenant.max.pending.tasks", T.INT, 8, I.MEDIUM,
             "per-cluster cap on concurrently Active async user tasks in "
             "fleet mode — admission control on the async purgatory so one "
             "noisy cluster's request storm cannot starve the other "
             "clusters' proposal refreshes (breach: 429 + "
             "fleet.tenant-rejections sensor); 0 disables",
             in_range(lo=0), group=g)
    d.define("fleet.tenant.retry.after.s", T.DOUBLE, 5.0, I.LOW,
             "fallback Retry-After (seconds) on admission-control and "
             "scheduler-shed 429 responses when no queue drain rate has "
             "been observed yet; with history, Retry-After is computed "
             "from the tenant queue's actual drain rate",
             in_range(lo=1.0), group=g)
    # --- fleet device scheduler: QoS-aware dispatch (fleet/scheduler.py) ---
    g = "fleet.scheduler"
    d.define("fleet.scheduler.enabled", T.BOOLEAN, False, I.HIGH,
             "QoS-aware device scheduler: every engine dispatch (detector "
             "fix pipelines = URGENT, REST proposals/simulate/rightsize = "
             "INTERACTIVE, streaming drift cycles / fleet scoring / "
             "speculative prewarm = BACKGROUND) runs under one arbitrated "
             "device slot with per-class deadlines, aging, bounded-wall "
             "preemption of segmented anneals, and a shed/brownout "
             "overload ladder.  Off (the default): dispatch order is "
             "byte-for-byte unscheduled", group=g)
    d.define("fleet.scheduler.slice.budget.s", T.DOUBLE, 1.0, I.MEDIUM,
             "wall-clock bound per segmented-anneal slice: a granted "
             "non-urgent anneal dispatches the fused round schedule in "
             "slices no longer than this, with a preemption check between "
             "slices — an URGENT request waits at most one slice",
             in_range(lo=0.01), group=g)
    d.define("fleet.scheduler.freshness.slo.s", T.DOUBLE, 60.0, I.MEDIUM,
             "per-cluster proposal-freshness SLO the scheduler derives "
             "request deadlines from: BACKGROUND cycles must dispatch "
             "within the SLO, INTERACTIVE within a quarter of it, URGENT "
             "within one slice budget.  Per-cluster overridable "
             "(fleet.<id>.fleet.scheduler.freshness.slo.s); the published "
             "proposal age it protects is observable as "
             "analyzer.proposal-age-seconds", in_range(lo=0.1), group=g)
    d.define("fleet.scheduler.fast.path.enabled", T.BOOLEAN, True, I.LOW,
             "grant INTERACTIVE work an unsegmented slot when no other "
             "tenant is waiting at grant time: an idle device gets the "
             "whole anneal as one dispatch (no between-slice preemption "
             "checks, no segmentation overhead) — the streaming "
             "controller's fused sub-second cycles ride this; off "
             "segments every non-urgent grant as before",
             group=g)
    d.define("fleet.scheduler.aging.s", T.DOUBLE, 30.0, I.LOW,
             "wait after which a BACKGROUND ticket is ranked with the "
             "INTERACTIVE class (its older deadline then wins the "
             "earliest-deadline tiebreak) — background can be delayed by "
             "load, never starved", in_range(lo=0.0), group=g)
    d.define("fleet.scheduler.shed.queue.depth", T.INT, 8, I.MEDIUM,
             "queued-dispatch depth at which overload protection engages: "
             "BACKGROUND submissions shed (counted in "
             "fleet.scheduler.shed-total.background) at this depth, "
             "INTERACTIVE admissions 429 with Retry-After at twice it; "
             "URGENT is never shed.  A >=50% deadline-miss ratio over "
             "recent grants also counts as overload",
             in_range(lo=1), group=g)
    d.define("fleet.scheduler.brownout.after.s", T.DOUBLE, 20.0, I.LOW,
             "overload sustained this long switches BACKGROUND handling "
             "from shed to BROWNOUT: re-anneals run with the reduced "
             "candidate width below instead of being skipped, so proposal "
             "freshness degrades gracefully instead of going dark",
             in_range(lo=0.0), group=g)
    d.define("fleet.scheduler.brownout.candidate.factor", T.DOUBLE, 0.5, I.LOW,
             "candidate/restart width multiplier for browned-out "
             "background anneals (one quantized step per base config, so "
             "brownout costs at most one extra compiled program per "
             "bucket)", in_range(lo=0.05, hi=1.0), group=g)
    # --- fleet HA: lease-sharded ownership (fleet/leases.py) ---
    g = "fleet.ha"
    d.define("fleet.ha.enabled", T.BOOLEAN, False, I.HIGH,
             "lease-sharded cluster ownership: M instances jointly serve "
             "one fleet.clusters set, each cluster owned (executed "
             "against) by exactly the instance holding its lease — "
             "per-cluster leases with monotonically increasing fencing "
             "epochs live in <executor.journal.dir>/_leases, every "
             "journal append and cluster mutation is fenced on the "
             "epoch, and a lost lease steps the cluster down to "
             "read-only degraded mode.  Requires executor.journal.dir "
             "(the lease store shares the journal's durability).  Off "
             "(the default): single-instance and classic fleet "
             "deployments run byte-for-byte unchanged with no lease "
             "store on disk", group=g)
    d.define("fleet.ha.lease.ttl.s", T.DOUBLE, 30.0, I.MEDIUM,
             "lease lifetime granted per acquisition/renewal; a peer may "
             "take a cluster over once its lease has been expired for "
             "fleet.ha.skew.slack.s", in_range(lo=0.1), group=g)
    d.define("fleet.ha.renew.s", T.DOUBLE, 10.0, I.MEDIUM,
             "renewal-heartbeat cadence; must be well below the ttl so "
             "transient store hiccups don't cost the lease",
             in_range(lo=0.01), group=g)
    d.define("fleet.ha.skew.slack.s", T.DOUBLE, 2.0, I.MEDIUM,
             "tolerated per-instance clock error: a holder's fence "
             "self-revokes at deadline - slack (on ITS clock) while "
             "takeover is only granted after deadline + slack (on the "
             "acquirer's) — skew within the slack cannot create two "
             "writers", in_range(lo=0.0), group=g)
    d.define("fleet.ha.instance.id", T.STRING, None, I.MEDIUM,
             "this instance's lease holder id; unset derives "
             "<hostname>-<pid>.  Must be unique across the instances "
             "sharing one lease store", group=g)
    return d


def _monitor_defs() -> ConfigDef:
    """Reference config/constants/MonitorConfig.java."""
    d = ConfigDef()
    g = "monitor"
    d.define("num.partition.metrics.windows", T.INT, 5, I.HIGH,
             "windows kept for partition metrics", in_range(lo=1), group=g)
    d.define("partition.metrics.window.ms", T.LONG, 3_600_000, I.HIGH,
             "partition metric window span", in_range(lo=1), group=g)
    d.define("min.samples.per.partition.metrics.window", T.INT, 3, I.MEDIUM,
             "samples for a window to avoid extrapolation", in_range(lo=1), group=g)
    d.define("num.broker.metrics.windows", T.INT, 20, I.MEDIUM, "broker windows",
             in_range(lo=1), group=g)
    d.define("broker.metrics.window.ms", T.LONG, 300_000, I.MEDIUM, "broker window span",
             in_range(lo=1), group=g)
    d.define("min.samples.per.broker.metrics.window", T.INT, 1, I.LOW, "",
             in_range(lo=1), group=g)
    d.define("metric.sampling.interval.ms", T.LONG, 120_000, I.MEDIUM, "sampler cadence",
             in_range(lo=1), group=g)
    from cruise_control_tpu_torch.monitor.reporter_sampler import (
        CruiseControlMetricsReporterSampler as _sampler,
    )

    d.define("monitor.excluded.topics.pattern", T.STRING,
             _sampler.DEFAULT_EXCLUDED,  # ONE source of truth with the sampler
             I.MEDIUM,
             "regex of topics invisible to the cluster model — the service's "
             "own metrics/sample-store topics must not be modeled as workload",
             group=g)
    d.define("num.metric.fetchers", T.INT, 1, I.MEDIUM,
             "parallel metric fetcher threads; each samples a disjoint "
             "partition set per round (reference num.metric.fetchers)",
             in_range(lo=1), group=g)
    d.define("min.valid.partition.ratio", T.DOUBLE, 0.95, I.MEDIUM,
             "monitored partition ratio gate", in_range(lo=0.0, hi=1.0), group=g)
    d.define("metric.sampler.class", T.CLASS,
             "cruise_control_tpu_torch.testing.synthetic.SyntheticWorkloadSampler", I.HIGH,
             "MetricSampler plugin", group=g)
    d.define("cruise.control.metrics.topic", T.STRING, "__CruiseControlMetrics",
             I.MEDIUM,
             "metrics-reporter topic the sampler consumes (reference "
             "CruiseControlMetricsReporterConfig cruise.control.metrics.topic)",
             group=g)
    d.define("cruise.control.metrics.serde.format", T.STRING, "native", I.MEDIUM,
             "wire format of the metrics topic: 'native' (this framework's "
             "reporter) or 'reference' (records produced by the reference's "
             "in-broker CruiseControlMetricsReporter plugin — drop-in "
             "ingestion of broker-internal metrics)",
             lambda n, v: None if v in ("native", "reference") else
             (_ for _ in ()).throw(ConfigException(
                 f"{n}: {v!r} not in ('native', 'reference')")),
             group=g)
    d.define("sample.store.class", T.CLASS,
             "cruise_control_tpu_torch.monitor.sampling.NoopSampleStore", I.MEDIUM,
             "SampleStore plugin", group=g)
    d.define("capacity.config.file", T.STRING, None, I.MEDIUM,
             "broker capacity JSON (reference config/capacity.json schema)", group=g)
    d.define("max.allowed.extrapolations.per.partition", T.INT, 5, I.LOW,
             "partitions extrapolating more windows than this are invalid "
             "(reference MonitorConfig:135)", in_range(lo=0), group=g)
    d.define("max.allowed.extrapolations.per.broker", T.INT, 5, I.LOW,
             "broker-window analog (reference MonitorConfig:179)",
             in_range(lo=0), group=g)
    d.define("skip.loading.samples", T.BOOLEAN, False, I.LOW,
             "do not replay the sample store on startup "
             "(reference MonitorConfig skip.loading.samples)", group=g)
    d.define("sampling.allow.cpu.capacity.estimation", T.BOOLEAN, True, I.LOW,
             "sampling may attribute CPU for brokers that reported no CPU "
             "metric (reference MonitorConfig:293-295)", group=g)
    d.define("use.linear.regression.model", T.BOOLEAN, False, I.LOW,
             "train the CPU regression continuously from broker samples and "
             "use it once bucket coverage suffices (reference "
             "MonitorConfig:302)", group=g)
    d.define("linear.regression.model.cpu.util.bucket.size", T.INT, 5, I.LOW,
             "CPU-util bucket width in percent points "
             "(reference MonitorConfig:268)", in_range(lo=1, hi=100), group=g)
    d.define("linear.regression.model.required.samples.per.bucket", T.INT, 100,
             I.LOW, "samples per bucket before it counts as covered "
             "(reference MonitorConfig:277)", in_range(lo=1), group=g)
    d.define("linear.regression.model.min.num.cpu.util.buckets", T.INT, 5,
             I.LOW, "distinct covered buckets required to train "
             "(reference MonitorConfig:286)", in_range(lo=1), group=g)
    d.define("leader.network.inbound.weight.for.cpu.util", T.DOUBLE, 0.7, I.LOW,
             "static follower-CPU model coefficient "
             "(reference MonitorConfig:241)", in_range(lo=0.0), group=g)
    d.define("leader.network.outbound.weight.for.cpu.util", T.DOUBLE, 0.15,
             I.LOW, "(reference MonitorConfig:250)", in_range(lo=0.0), group=g)
    d.define("follower.network.inbound.weight.for.cpu.util", T.DOUBLE, 0.15,
             I.LOW, "(reference MonitorConfig:259)", in_range(lo=0.0), group=g)
    d.define("broker.capacity.config.resolver.class", T.CLASS, None, I.MEDIUM,
             "custom BrokerCapacityConfigResolver; called with the "
             "CruiseControlConfig (reference "
             "config/BrokerCapacityConfigResolver.java); unset uses "
             "capacity.config.file / fixed defaults", group=g)
    d.define("metric.sampler.partition.assignor.class", T.CLASS, None, I.LOW,
             "custom MetricSamplerPartitionAssignor; called with no args "
             "(reference monitor/sampling/MetricSamplerPartitionAssignor.java)",
             group=g)
    d.define("topic.config.provider.class", T.CLASS, None, I.LOW,
             "custom TopicConfigProvider; called with (config, admin) "
             "(reference config/TopicConfigProvider.java) — "
             "KafkaTopicConfigProvider pulls the wire client off the admin",
             group=g)
    return d


def _executor_defs() -> ConfigDef:
    """Reference config/constants/ExecutorConfig.java."""
    d = ConfigDef()
    g = "executor"
    d.define("num.concurrent.partition.movements.per.broker", T.INT, 5, I.HIGH,
             "inter-broker move cap per broker", in_range(lo=1), group=g)
    d.define("num.concurrent.intra.broker.partition.movements", T.INT, 2, I.MEDIUM,
             "intra-broker move cap per broker", in_range(lo=1), group=g)
    d.define("num.concurrent.leader.movements", T.INT, 1000, I.MEDIUM,
             "cluster-wide leadership batch", in_range(lo=1), group=g)
    d.define("default.replication.throttle", T.LONG, None, I.MEDIUM,
             "bytes/s replication throttle during execution", group=g)
    d.define("execution.progress.check.interval.ms", T.LONG, 10_000, I.MEDIUM,
             "progress poll cadence", in_range(lo=1), group=g)
    d.define("task.execution.alerting.threshold.ms", T.LONG, 90_000, I.LOW,
             "slow-task alert threshold", in_range(lo=1), group=g)
    d.define("default.replica.movement.strategies", T.LIST,
             "BaseReplicaMovementStrategy", I.LOW,
             "ordered strategy chain applied to every execution unless the "
             "request overrides it", group=g)
    d.define("replica.movement.strategies", T.LIST,
             "PostponeUrpReplicaMovementStrategy,"
             "PrioritizeLargeReplicaMovementStrategy,"
             "PrioritizeSmallReplicaMovementStrategy,"
             "BaseReplicaMovementStrategy", I.LOW,
             "the pool of strategies requests may reference (reference "
             "ExecutorConfig replica.movement.strategies); dotted paths "
             "register custom classes", group=g)
    d.define("inter.broker.replica.movement.rate.alerting.threshold", T.DOUBLE,
             0.1, I.LOW, "MB/s floor; slower long-running inter-broker moves "
             "alert (reference ExecutorConfig:142)", in_range(lo=0.0), group=g)
    d.define("intra.broker.replica.movement.rate.alerting.threshold", T.DOUBLE,
             0.2, I.LOW, "MB/s floor for intra-broker (logdir) copies "
             "(reference ExecutorConfig:153)", in_range(lo=0.0), group=g)
    d.define("executor.notifier.class", T.CLASS, None, I.LOW,
             "object notified after every execution finishes; called with "
             "no args, must expose on_execution_finished(result, uuid) "
             "(reference ExecutorConfig executor.notifier.class)", group=g)
    d.define("max.num.cluster.movements", T.INT, 1250, I.MEDIUM,
             "global cap on concurrently ongoing movements (replica + "
             "leadership) cluster-wide, regardless of the per-broker caps "
             "(reference ExecutorConfig max.num.cluster.movements)",
             in_range(lo=1), group=g)
    d.define("leader.movement.timeout.ms", T.LONG, 180_000, I.LOW,
             "a leadership move not confirmed by the topology within this "
             "window is declared DEAD (reference ExecutorConfig "
             "leader.movement.timeout.ms)", in_range(lo=1), group=g)
    d.define("removal.history.retention.time.ms", T.LONG, 1_209_600_000, I.LOW,
             "how long removed brokers stay in the recently-removed set "
             "(default 14 days, reference ExecutorConfig "
             "removal.history.retention.time.ms)", in_range(lo=1), group=g)
    d.define("demotion.history.retention.time.ms", T.LONG, 1_209_600_000, I.LOW,
             "how long demoted brokers stay in the recently-demoted set",
             in_range(lo=1), group=g)
    # --- crash-safe execution (executor/journal.py) ---
    g = "executor.journal"
    d.define("executor.journal.dir", T.STRING, None, I.MEDIUM,
             "directory of the durable execution journal (append-only "
             "JSONL); a restarted executor replays it, reconciles any "
             "in-flight execution against the live cluster and resumes it "
             "(RECOVERING state).  Unset disables journaling — a crash "
             "mid-rebalance then strands in-flight reassignments and leaks "
             "throttles, exactly what the reference's persisted executor "
             "state prevents", group=g)
    d.define("executor.journal.fsync.batch.size", T.INT, 1, I.LOW,
             "journal records buffered before flush+fsync; 1 makes every "
             "record durable before the next cluster mutation (execution "
             "start, throttle and reaper records always fsync regardless)",
             in_range(lo=1), group=g)
    d.define("executor.journal.retention.count", T.INT, 64, I.LOW,
             "terminal (cleanly finished) journal archives kept per "
             "cluster; older ones are pruned during start-up "
             "reconciliation.  Unfinished journals awaiting recovery are "
             "NEVER pruned", in_range(lo=0), group=g)
    d.define("executor.journal.retention.hours", T.DOUBLE, 168.0, I.LOW,
             "terminal journal archives older than this are pruned during "
             "start-up reconciliation regardless of count (default 7 "
             "days)", in_range(lo=0.0), group=g)
    # --- stuck-move reaper ---
    g = "executor.reaper"
    d.define("executor.reaper.enabled", T.BOOLEAN, True, I.MEDIUM,
             "enforce the slow-task signal: a replica move whose progress "
             "watermark stalls past the timeout is cancelled (rolled back "
             "to the original replica set where the controller supports "
             "per-partition cancellation, else declared DEAD) and an "
             "EXECUTION_STUCK anomaly is raised — the rest of the batch "
             "keeps flowing", group=g)
    d.define("executor.reaper.stuck.timeout.s", T.DOUBLE, 900.0, I.MEDIUM,
             "seconds without observable progress (remaining-bytes "
             "decrease, or completion for admins that cannot report "
             "per-move bytes) before an in-flight move is reaped",
             in_range(lo=1.0), group=g)
    # --- load-aware adaptive concurrency (reference ConcurrencyAdjuster) ---
    g = "executor.adaptive"
    d.define("executor.adaptive.enabled", T.BOOLEAN, True, I.MEDIUM,
             "AIMD the per-broker and cluster-wide movement caps each "
             "progress tick: multiplicative backoff while the cluster "
             "shows stress (under-replicated partitions above the "
             "execution-start baseline, or task throughput collapse), "
             "additive recovery toward the configured caps once it clears",
             group=g)
    d.define("executor.adaptive.min", T.INT, 1, I.MEDIUM,
             "floor of the adaptive per-broker movement cap",
             in_range(lo=1), group=g)
    d.define("executor.adaptive.max", T.INT, 64, I.MEDIUM,
             "ceiling of the adaptive per-broker movement cap",
             in_range(lo=1), group=g)
    d.define("executor.adaptive.backoff.factor", T.DOUBLE, 0.5, I.LOW,
             "multiplicative decrease applied to the caps on a stressed "
             "tick", in_range(lo=0.05, hi=0.95), group=g)
    d.define("executor.adaptive.recover.step", T.INT, 1, I.LOW,
             "additive per-tick cap recovery once stress clears",
             in_range(lo=1), group=g)
    d.define("executor.adaptive.urp.slack", T.INT, 0, I.LOW,
             "under-replicated partitions above the execution-start "
             "baseline tolerated before backoff", in_range(lo=0), group=g)
    d.define("executor.adaptive.stall.ticks", T.INT, 16, I.LOW,
             "consecutive progress ticks without a single task completion "
             "(while moves are in flight) that count as cluster stress; "
             "0 disables the throughput signal", in_range(lo=0), group=g)
    return d


def _anomaly_defs() -> ConfigDef:
    """Reference config/constants/AnomalyDetectorConfig.java."""
    d = ConfigDef()
    g = "anomaly.detector"
    d.define("anomaly.detection.interval.ms", T.LONG, 300_000, I.MEDIUM,
             "detector cadence", in_range(lo=1), group=g)
    # per-detector cadence overrides; unset falls back to
    # anomaly.detection.interval.ms (reference AnomalyDetectorConfig:161-204)
    for det in ("goal.violation", "metric.anomaly", "disk.failure", "topic.anomaly"):
        d.define(f"{det}.detection.interval.ms", T.LONG, None, I.LOW,
                 f"{det} detector cadence override", group=g)
    d.define("broker.failure.detection.backoff.ms", T.LONG, 300_000, I.MEDIUM,
             "broker-failure detector polling backoff "
             "(reference AnomalyDetectorConfig:188)", in_range(lo=1), group=g)
    d.define("anomaly.detection.goals", T.LIST,
             "RackAwareGoal,ReplicaCapacityGoal,DiskCapacityGoal", I.MEDIUM,
             "goals the violation detector watches "
             "(reference AnomalyDetectorConfig:103-107)", group=g)
    d.define("anomaly.detection.allow.capacity.estimation", T.BOOLEAN, True, I.LOW,
             "detector models may estimate missing broker capacities", group=g)
    d.define("self.healing.goals", T.LIST, "", I.MEDIUM,
             "goal chain used by self-healing fixes; empty means the default "
             "goals (reference AnomalyDetectorConfig:88)", group=g)
    d.define("self.healing.exclude.recently.demoted.brokers", T.BOOLEAN, True,
             I.MEDIUM, "self-healing never gives leadership to recently "
             "demoted brokers", group=g)
    d.define("self.healing.exclude.recently.removed.brokers", T.BOOLEAN, True,
             I.MEDIUM, "self-healing never moves replicas onto recently "
             "removed brokers", group=g)
    d.define("num.cached.recent.anomaly.states", T.INT, 10, I.LOW,
             "per-type anomaly history depth "
             "(reference AnomalyDetectorConfig:48)", in_range(lo=1, hi=100), group=g)
    d.define("fixable.failed.broker.count.threshold", T.INT, 10, I.MEDIUM,
             "self-healing refuses to remove more than this many failed "
             "brokers at once (reference AnomalyDetectorConfig:138)",
             in_range(lo=1), group=g)
    d.define("fixable.failed.broker.percentage.threshold", T.DOUBLE, 0.4, I.MEDIUM,
             "self-healing refuses to remove more than this fraction of the "
             "cluster (reference AnomalyDetectorConfig:147)",
             in_range(lo=0.0, hi=1.0), group=g)
    d.define("anomaly.notifier.class", T.CLASS,
             "cruise_control_tpu_torch.detector.notifier.SelfHealingNotifier", I.MEDIUM,
             "AnomalyNotifier plugin", group=g)
    for t in ("broker.failure", "goal.violation", "disk.failure", "metric.anomaly",
              "topic.anomaly"):
        d.define(f"self.healing.{t}.enabled", T.BOOLEAN, False, I.MEDIUM,
                 f"auto-fix {t} anomalies", group=g)
    d.define("broker.failure.alert.threshold.ms", T.LONG, 900_000, I.MEDIUM, "", group=g)
    d.define("broker.failure.self.healing.threshold.ms", T.LONG, 1_800_000, I.MEDIUM,
             "", group=g)
    d.define("slow.broker.removal.enabled", T.BOOLEAN, False, I.LOW, "", group=g)
    d.define("slow.broker.history.percentile", T.DOUBLE, 90.0, I.LOW,
             "own-history percentile a slow broker must exceed",
             in_range(lo=0.0, hi=100.0), group=g)
    d.define("slow.broker.peer.comparison.ratio", T.DOUBLE, 3.0, I.LOW,
             "multiple of the peer median flagged as slow", in_range(lo=1.0), group=g)
    d.define("slow.broker.strike.removal.threshold", T.INT, 3, I.LOW,
             "consecutive detections before removal is proposed",
             in_range(lo=1), group=g)
    d.define("broker.failure.persisted.path", T.STRING, None, I.LOW,
             "file persisting broker-failure times across restarts "
             "(reference persists to a ZK node)", group=g)
    d.define("topic.anomaly.target.replication.factor", T.INT, 2, I.LOW, "", group=g)
    d.define("metric.anomaly.finder.class", T.CLASS, None, I.LOW,
             "custom metric-anomaly finder (reference AnomalyDetectorConfig "
             "metric.anomaly.finder.class); called with the "
             "CruiseControlConfig, must expose detect(evidence) -> "
             "Anomaly | None; unset uses the built-in SlowBrokerFinder",
             group=g)
    d.define("topic.anomaly.finder.class", T.CLASS, None, I.LOW,
             "custom topic-anomaly finder; called with (topology_provider, "
             "config), must expose detect() -> Anomaly | None; unset uses "
             "the built-in TopicReplicationFactorAnomalyFinder", group=g)
    d.define("partition.size.detection.enabled", T.BOOLEAN, False, I.LOW,
             "also run the PartitionSizeAnomalyFinder each topic-anomaly "
             "round (reference detector/PartitionSizeAnomalyFinder.java)",
             group=g)
    d.define("self.healing.partition.size.threshold.byte", T.LONG,
             500 * 1024 * 1024, I.LOW,
             "partitions larger than this are anomalous "
             "(reference PartitionSizeAnomalyFinder:49-50)",
             in_range(lo=1), group=g)
    d.define("topic.excluded.from.partition.size.check", T.STRING, "", I.LOW,
             "regex of topics the size check ignores "
             "(reference PartitionSizeAnomalyFinder:51)", group=g)
    # Slack alerting (reference detector/notifier/SlackSelfHealingNotifier.java)
    d.define("slack.self.healing.notifier.webhook", T.STRING, None, I.LOW,
             "Slack incoming-webhook URL; enables the Slack notifier", group=g)
    d.define("slack.self.healing.notifier.channel", T.STRING, None, I.LOW,
             "override channel for alerts", group=g)
    d.define("slack.self.healing.notifier.user", T.STRING, "cruise-control-tpu",
             I.LOW, "sender username", group=g)
    return d


def _webserver_defs() -> ConfigDef:
    """Reference config/constants/WebServerConfig.java + UserTaskManagerConfig."""
    d = ConfigDef()
    g = "webserver"
    d.define("webserver.http.port", T.INT, 9090, I.HIGH, "REST port",
             in_range(lo=0, hi=65535), group=g)
    d.define("webserver.http.address", T.STRING, "127.0.0.1", I.MEDIUM, "bind address", group=g)
    d.define("webserver.api.urlprefix", T.STRING, "/kafkacruisecontrol", I.LOW, "", group=g)
    d.define("webserver.session.maxExpiryPeriodMs", T.LONG, 3_600_000, I.LOW, "", group=g)
    d.define("webserver.session.path", T.STRING, "/", I.LOW,
             "session cookie Path attribute (reference webserver.session.path)",
             group=g)
    d.define("max.cached.completed.user.tasks", T.INT, 100, I.LOW, "", group=g)
    d.define("completed.user.task.retention.time.ms", T.LONG, 86_400_000, I.LOW, "", group=g)
    d.define("max.active.user.tasks", T.INT, 25, I.LOW,
             "cap on concurrently Active async user tasks; beyond it new "
             "operations are rejected (reference WebServerConfig "
             "max.active.user.tasks)", in_range(lo=1), group=g)
    # per-category completed-task caches (reference UserTaskManagerConfig:
    # unset falls back to the general cap/retention above)
    for cat in ("kafka.monitor", "cruise.control.monitor",
                "kafka.admin", "cruise.control.admin"):
        d.define(f"max.cached.completed.{cat}.user.tasks", T.INT, None, I.LOW,
                 f"completed-task cache size for {cat} endpoints", group=g)
        d.define(f"completed.{cat}.user.task.retention.time.ms", T.LONG, None,
                 I.LOW, f"completed-task retention for {cat} endpoints", group=g)
    d.define("request.reason.required", T.BOOLEAN, False, I.LOW,
             "POST requests must carry a reason parameter "
             "(reference WebServerConfig request.reason.required)", group=g)
    d.define("two.step.purgatory.max.requests", T.INT, 25, I.LOW,
             "cap on requests parked for review "
             "(reference WebServerConfig:149)", in_range(lo=1), group=g)
    d.define("two.step.purgatory.retention.time.ms", T.LONG, 1_209_600_000,
             I.LOW, "how long parked requests stay reviewable "
             "(reference WebServerConfig:141, default 336h)",
             in_range(lo=1), group=g)
    # CORS (reference WebServerConfig:42-70)
    d.define("webserver.http.cors.enabled", T.BOOLEAN, False, I.LOW,
             "emit CORS headers + answer OPTIONS preflight", group=g)
    d.define("webserver.http.cors.origin", T.STRING, "*", I.LOW,
             "Access-Control-Allow-Origin value", group=g)
    d.define("webserver.http.cors.allowmethods", T.STRING, "OPTIONS, GET, POST",
             I.LOW, "Access-Control-Allow-Methods value", group=g)
    d.define("webserver.http.cors.exposeheaders", T.STRING, "User-Task-ID",
             I.LOW, "Access-Control-Expose-Headers value", group=g)
    # NCSA access log (reference WebServerConfig:119-134; Jetty NCSARequestLog)
    d.define("webserver.accesslog.enabled", T.BOOLEAN, False, I.LOW,
             "write an NCSA-format access log (reference defaults true; off "
             "here so embedded instances stay hermetic)", group=g)
    d.define("webserver.accesslog.path", T.STRING, "access.log", I.LOW,
             "access log file; rolled daily", group=g)
    d.define("webserver.accesslog.retention.days", T.INT, 7, I.LOW,
             "rolled access logs older than this are deleted",
             in_range(lo=1), group=g)
    d.define("webserver.security.enable", T.BOOLEAN, False, I.MEDIUM, "", group=g)
    d.define("webserver.security.provider", T.CLASS, None, I.MEDIUM,
             "custom SecurityProvider (reference WebServerConfig:164); "
             "called with the CruiseControlConfig, must expose "
             "authenticate(headers) and authorize(role, method, endpoint); "
             "unset selects JWT/basic from the other keys", group=g)
    # static UI serving (reference WebServerConfig:84-91 serves
    # cruise-control-ui from disk)
    d.define("webserver.ui.diskpath", T.STRING, None, I.LOW,
             "directory of UI static files; unset disables UI serving",
             group=g)
    d.define("webserver.ui.urlprefix", T.STRING, "/ui", I.LOW,
             "URL prefix the UI is served under", group=g)
    d.define("basic.auth.credentials.file", T.STRING, None, I.MEDIUM,
             "htpasswd-style user:password[:role] lines", group=g)
    d.define("webserver.auth.credentials.file", T.STRING, None, I.MEDIUM,
             "reference name for basic.auth.credentials.file; takes "
             "precedence when both are set (WebServerConfig:179)", group=g)
    d.define("jwt.secret.key", T.STRING, None, I.MEDIUM,
             "enables HS256 bearer-token auth when set", group=g)
    d.define("jwt.authentication.certificate.location", T.STRING, None, I.MEDIUM,
             "PEM public key or X.509 certificate enabling RS256 bearer-token "
             "auth (reference servlet/security/jwt/JwtAuthenticator)", group=g)
    d.define("jwt.auth.certificate.location", T.STRING, None, I.MEDIUM,
             "reference name for jwt.authentication.certificate.location; "
             "takes precedence when both are set", group=g)
    d.define("jwt.cookie.name", T.STRING, None, I.LOW,
             "also accept the JWT from this cookie (reference "
             "WebServerConfig:243; Authorization header still wins)", group=g)
    d.define("jwt.expected.audiences", T.LIST, "", I.LOW,
             "token aud claim must intersect this list when set "
             "(reference JwtAuthenticator audience check)", group=g)
    d.define("jwt.authentication.provider.url", T.STRING, None, I.LOW,
             "unauthenticated browser requests are redirected (302) here; "
             "{redirect} in the URL is replaced with the original request "
             "(reference WebServerConfig:233)", group=g)
    d.define("two.step.verification.enabled", T.BOOLEAN, False, I.MEDIUM,
             "POSTs park in the review purgatory first", group=g)
    # TLS for the REST listener (reference KafkaCruiseControlApp.java:100-120
    # SSL connector; PEM files instead of JKS keystores)
    d.define("webserver.ssl.enable", T.BOOLEAN, False, I.MEDIUM,
             "serve the REST API over TLS", group=g)
    d.define("webserver.ssl.certificate.location", T.STRING, None, I.MEDIUM,
             "PEM certificate chain file", group=g)
    d.define("webserver.ssl.key.location", T.STRING, None, I.MEDIUM,
             "PEM private-key file (defaults to the certificate file)", group=g)
    d.define("webserver.ssl.key.password", T.STRING, None, I.LOW,
             "private-key passphrase", group=g)
    d.define("webserver.ssl.protocol", T.STRING, "TLS", I.LOW,
             "minimum TLS version for the listener: TLS (library default), "
             "TLSv1.2 or TLSv1.3 (reference WebServerConfig:226)", group=g)
    # SASL toward the Kafka cluster (reference rides JAAS,
    # config/cruise_control_jaas.conf_template; the wire client speaks
    # SaslHandshake + SCRAM itself)
    d.define("sasl.mechanism", T.STRING, None, I.MEDIUM,
             "PLAIN | SCRAM-SHA-256 | SCRAM-SHA-512; unset disables SASL",
             group=g)
    d.define("sasl.username", T.STRING, None, I.MEDIUM,
             "SASL username toward the Kafka cluster", group=g)
    d.define("sasl.password", T.STRING, None, I.MEDIUM,
             "SASL password (prefer sasl.password.file in production)", group=g)
    d.define("sasl.password.file", T.STRING, None, I.MEDIUM,
             "file holding the SASL password (overrides sasl.password)",
             group=g)
    # per-endpoint parameter/request class override maps (reference
    # config/constants/CruiseControlParametersConfig.java:1 +
    # CruiseControlRequestConfig.java:1): every endpoint's parameter
    # declaration and request execution are pluggable
    from cruise_control_tpu_torch.config.endpoints import ALL_ENDPOINTS, reference_key_name

    for ep in sorted(ALL_ENDPOINTS):
        d.define(f"{ep}.parameters.class", T.CLASS, None, I.LOW,
                 f"dotted path of a custom parameters class for /{ep}; "
                 "called with (endpoint, builtin_parameters), must expose "
                 ".parse(raw_query_dict)", group=g)
        d.define(f"{ep}.request.class", T.CLASS, None, I.LOW,
                 f"dotted path of a custom request handler for /{ep}; "
                 "called with (app, endpoint, params) -> (status, payload)",
                 group=g)
        ref = reference_key_name(ep)
        if ref != ep:
            # accept the reference's dotted spelling too, so an existing
            # cruisecontrol.properties keeps working unmodified
            d.define(f"{ref}.parameters.class", T.CLASS, None, I.LOW,
                     f"reference spelling of {ep}.parameters.class", group=g)
            d.define(f"{ref}.request.class", T.CLASS, None, I.LOW,
                     f"reference spelling of {ep}.request.class", group=g)
    return d


def cruise_control_config_def() -> ConfigDef:
    return (
        _analyzer_defs()
        .merge(_controller_defs())
        .merge(_observability_defs())
        .merge(_fleet_defs())
        .merge(_planner_defs())
        .merge(_monitor_defs())
        .merge(_executor_defs())
        .merge(_anomaly_defs())
        .merge(_webserver_defs())
    )


class CruiseControlConfig(AbstractConfig):
    """Reference config/KafkaCruiseControlConfig.java:38 + goal-name sanity
    checks (:106-120)."""

    def __init__(self, props: dict[str, Any] | None = None):
        #: raw operator props, kept for fleet per-cluster derivation
        #: (cluster_config overlays fleet.<id>.* keys over this base)
        self._raw_props = dict(props or {})
        super().__init__(cruise_control_config_def(), props or {})
        self._sanity_check_goals()
        self._sanity_check_fleet_keys()

    # ------------------------------------------------------------------
    # fleet (fleet/manager.py)
    # ------------------------------------------------------------------

    def fleet_cluster_ids(self) -> list[str]:
        return self.get("fleet.clusters")

    def _sanity_check_fleet_keys(self):
        """Every non-builtin `fleet.*` key must be a `fleet.<id>.<key>`
        override whose <id> is in fleet.clusters — unknown keys are
        tolerated config-wide, but a typo'd cluster prefix
        (fleet.eastt.bootstrap.servers) would otherwise silently fold
        nothing and the fleet would run against the base settings."""
        ids = set(self.get("fleet.clusters"))
        defined = self.definition.keys()
        for k in self._raw_props:
            if not k.startswith("fleet.") or k in defined:
                continue
            cid, _, rest = k[len("fleet."):].partition(".")
            if cid not in ids or not rest:
                raise ConfigException(
                    f"{k!r} is not a per-cluster override: "
                    f"{cid!r} is not in fleet.clusters ({sorted(ids)})"
                )

    #: keys the SHARED half of a fleet deployment consumes — the one
    #: AnalyzerCore (goal chain, balancing constraint, optimizer/engine
    #: cache, device supervisor, planner, tracer) and the one webserver /
    #: user-task purgatory, all built from the BASE config.  A
    #: fleet.<id>.<key> override of these would validate, fold into the
    #: cluster's facade config, and then be silently ignored — reject it
    #: at config time instead of misleading the operator.
    _FLEET_SHARED_KEY_PREFIXES = (
        "default.goals", "goal.balancedness.", "planner.", "tpu.", "trace.",
        "webserver.", "jwt.", "basic.auth.", "max.active.user.tasks",
        "max.cached.completed", "completed.", "two.step.",
        "request.reason.required", "metrics.prometheus.",
        "max.replicas.per.broker", "goal.violation.distribution.threshold",
    )
    _FLEET_SHARED_KEY_SUFFIXES = (  # BalancingConstraint inputs
        ".balance.threshold", ".capacity.threshold",
        ".low.utilization.threshold",
    )
    #: shared-prefixed keys that ARE legitimately per-cluster: the device
    #: scheduler is one shared object, but each cluster's freshness SLO
    #: is a per-request deadline input its facade/controller reads
    _FLEET_SHARED_KEY_EXEMPT = ("fleet.scheduler.freshness.slo.s",)

    def cluster_config(self, cluster_id: str) -> "CruiseControlConfig":
        """Per-cluster config: the base props with every `fleet.<id>.<key>`
        override folded onto its bare `<key>`.  All `fleet.*` keys are
        stripped from the derived config — a cluster-scoped config must
        never look like a fleet of its own — EXCEPT the builtin
        fleet.scheduler.*/fleet.tenant.* knobs, which carry no
        fleet-shaped meaning and which per-cluster facades read (the
        freshness SLO).  Overrides of shared-core / webserver keys are
        rejected (see _FLEET_SHARED_KEY_PREFIXES); of the scheduler/
        tenant knobs only the per-cluster freshness SLO
        (_FLEET_SHARED_KEY_EXEMPT) is overridable — the rest configure
        the ONE instance-level scheduler/purgatory built from the base."""
        if cluster_id not in self.get("fleet.clusters"):
            raise ConfigException(
                f"unknown fleet cluster {cluster_id!r}; "
                f"fleet.clusters={self.get('fleet.clusters')}"
            )
        prefix = f"fleet.{cluster_id}."
        base = {
            k: v for k, v in self._raw_props.items()
            if not k.startswith("fleet.")
            or k.startswith(("fleet.scheduler.", "fleet.tenant."))
        }
        overrides = {
            k[len(prefix):]: v
            for k, v in self._raw_props.items()
            if k.startswith(prefix)
        }
        shared = sorted(
            k for k in overrides
            if (
                k.startswith(self._FLEET_SHARED_KEY_PREFIXES)
                or k.endswith(self._FLEET_SHARED_KEY_SUFFIXES)
                # the scheduler and the admission/Retry-After knobs are
                # instance-level objects read from the BASE config — a
                # per-cluster override would fold and then be silently
                # ignored, except the explicitly per-cluster SLO
                or (
                    k.startswith(("fleet.scheduler.", "fleet.tenant."))
                    and k not in self._FLEET_SHARED_KEY_EXEMPT
                )
            )
        )
        if shared:
            raise ConfigException(
                f"fleet.{cluster_id}.* cannot override shared keys {shared}: "
                "the fleet builds ONE goal chain / constraint / optimizer / "
                "supervisor / planner / tracer / webserver from the base "
                "config, so a per-cluster value would be silently ignored — "
                "set these on the base config instead"
            )
        return CruiseControlConfig({**base, **overrides})

    def _sanity_check_goals(self):
        """Reference KafkaCruiseControlConfig.java:106-120 validates every
        configured goal-name list against the registry."""
        from cruise_control_tpu_torch.analyzer.goals import GOALS_BY_NAME

        for key in ("default.goals", "hard.goals", "anomaly.detection.goals",
                    "self.healing.goals", "intra.broker.goals"):
            names = self.get(key)
            unknown = [g for g in names if g not in GOALS_BY_NAME]
            if unknown:
                raise ConfigException(f"unknown goals in {key}: {unknown}")
        if not self.get("default.goals"):
            raise ConfigException("default.goals must not be empty")

    def balancing_constraint(self) -> BalancingConstraint:
        g = self.get
        return BalancingConstraint(
            balance_threshold=(
                g("cpu.balance.threshold"),
                g("network.inbound.balance.threshold"),
                g("network.outbound.balance.threshold"),
                g("disk.balance.threshold"),
            ),
            capacity_threshold=(
                g("cpu.capacity.threshold"),
                g("network.inbound.capacity.threshold"),
                g("network.outbound.capacity.threshold"),
                g("disk.capacity.threshold"),
            ),
            low_utilization_threshold=(
                g("cpu.low.utilization.threshold"),
                g("network.inbound.low.utilization.threshold"),
                g("network.outbound.low.utilization.threshold"),
                g("disk.low.utilization.threshold"),
            ),
            replica_count_balance_threshold=g("replica.count.balance.threshold"),
            leader_replica_count_balance_threshold=g("leader.replica.count.balance.threshold"),
            topic_replica_count_balance_threshold=g("topic.replica.count.balance.threshold"),
            max_replicas_per_broker=g("max.replicas.per.broker"),
            goal_violation_distribution_threshold_multiplier=g(
                "goal.violation.distribution.threshold.multiplier"
            ),
        )

    def optimizer_config(self):
        from cruise_control_tpu_torch.analyzer.engine import OptimizerConfig

        g = self.get
        return OptimizerConfig(
            num_candidates=g("tpu.num.candidates"),
            leadership_candidates=g("tpu.leadership.candidates"),
            swap_candidates=g("tpu.swap.candidates"),
            steps_per_round=g("tpu.steps.per.round"),
            num_rounds=g("tpu.num.rounds"),
            init_temperature_scale=g("tpu.init.temperature.scale"),
            temperature_decay=g("tpu.temperature.decay"),
            replica_move_cost=g("tpu.replica.move.cost"),
            leadership_move_cost=g("tpu.leadership.move.cost"),
            importance_fraction=g("tpu.importance.fraction"),
            diagnostics=g("analyzer.diagnostics.enabled"),
            score_dtype=g("analyzer.precision.score.dtype"),
        )

    def compile_cache_dir(self) -> str | None:
        """The persistent cache directory: the preferred
        tpu.compile.cache.dir when SET (an explicitly empty value
        disables the cache — it must not fall through to the legacy
        key's non-empty default), else the legacy
        tpu.compilation.cache.dir (empty/None disables).  It roots the
        derived prewarm-manifest and black-box directories; when it is
        set the service takes the boot inventory of the kernel build
        cache (common/compilation_cache.py `enable_persistent_cache`),
        which is this package's only compiled artifact on disk."""
        v = self.get("tpu.compile.cache.dir")
        if v is not None:
            return v or None
        return self.get("tpu.compilation.cache.dir") or None

    def prewarm_manifest_dir(self) -> str | None:
        """Directory of the boot-prewarm manifest + AOT artifacts, or
        None when prewarm is off.  Unset derives the 'prewarm'
        subdirectory INSIDE the persistent compile cache — the same
        mount, so they share one durability story (a sibling of the
        cache dir could land outside the operator's volume when the
        volume is mounted exactly at the cache path); the cache's boot
        inventory scan prunes the subdirectory so manifest/artifact
        writes never count as XLA cache entries.  An explicitly empty
        value disables, like compile_cache_dir."""
        import os

        if not self.get("tpu.prewarm.enabled"):
            return None
        v = self.get("tpu.prewarm.manifest.dir")
        if v is not None:
            return v or None
        cache = self.compile_cache_dir()
        if not cache:
            return None
        return os.path.join(os.path.expanduser(cache), "prewarm")

    def blackbox_dir(self) -> str | None:
        """Directory of the black-box dispatch spool (common/blackbox.py),
        or None when disabled / no durable directory exists.  Unset
        derives '_blackbox' inside executor.journal.dir — the spool must
        survive exactly the crashes the journal survives, so they share
        one mount — falling back to a 'blackbox' subdirectory of the
        persistent compile cache.  An explicitly empty value disables,
        like compile_cache_dir."""
        import os

        if not self.get("blackbox.enabled"):
            return None
        v = self.get("blackbox.dir")
        if v is not None:
            return v or None
        journal = self.get("executor.journal.dir")
        if journal:
            return os.path.join(os.path.expanduser(journal), "_blackbox")
        cache = self.compile_cache_dir()
        if not cache:
            return None
        return os.path.join(os.path.expanduser(cache), "blackbox")

    def ledger_dir(self) -> str | None:
        """Directory of the decision ledger (analyzer/ledger.py), or None
        when disabled / no durable directory exists.  Unset derives
        '_ledger' inside executor.journal.dir — decision records must
        survive exactly the crashes the execution journal survives, so
        they share one mount.  An explicitly empty value disables, like
        blackbox_dir."""
        import os

        if not self.get("analyzer.ledger.enabled"):
            return None
        v = self.get("analyzer.ledger.dir")
        if v is not None:
            return v or None
        journal = self.get("executor.journal.dir")
        if journal:
            return os.path.join(os.path.expanduser(journal), "_ledger")
        return None

    def parallel_mode(self) -> str:
        return self.get("tpu.parallel.mode")

    def mesh_max_devices(self) -> int:
        return self.get("tpu.mesh.max.devices")

    def mesh_model_shard_min_partitions(self) -> int:
        return self.get("tpu.mesh.model.shard.min.partitions")

    def mesh_ft_controller(self, *, sensors=None):
        """MeshFtController from the tpu.mesh.ft.* keys (parallel/ft.py);
        None in single-device mode — there is no mesh to degrade.  The
        per-width breakers re-probe on the supervisor's probe cadence."""
        if self.parallel_mode() == "single":
            return None
        from cruise_control_tpu_torch.parallel.ft import MeshFtController

        return MeshFtController(
            enabled=self.get("tpu.mesh.ft.enabled"),
            checkpoint_every_slices=self.get(
                "tpu.mesh.ft.checkpoint.every.slices"
            ),
            probe_interval_s=self.get("tpu.supervisor.probe.interval.s"),
            sensors=sensors,
        )

    def device_supervisor(self, *, sensors=None, probe=None, tracer=None, device=None):
        """DeviceSupervisor from the tpu.supervisor.* keys; None when
        supervision is disabled (offline tools, parity benchmarks).
        `device` is the supervised device its recovery probe runs on (the
        current CUDA device when None)."""
        if not self.get("tpu.supervisor.enabled"):
            return None
        from cruise_control_tpu_torch.common.device_watchdog import DeviceSupervisor

        return DeviceSupervisor(
            op_timeout_s=self.get("tpu.supervisor.op.timeout.s"),
            max_retries=self.get("tpu.supervisor.max.retries"),
            retry_backoff_s=self.get("tpu.supervisor.retry.backoff.ms") / 1000.0,
            retry_backoff_cap_s=self.get("tpu.supervisor.retry.backoff.max.ms")
            / 1000.0,
            breaker_failure_threshold=self.get(
                "tpu.supervisor.breaker.failure.threshold"
            ),
            probe_interval_s=self.get("tpu.supervisor.probe.interval.s"),
            probe_timeout_s=self.get("tpu.supervisor.probe.timeout.s"),
            sensors=sensors,
            probe=probe,
            tracer=tracer,
            device=device,
        )

    def tracer(self):
        """Flight-recorder Tracer from the trace.* keys (one per service;
        the facade shares it across every subsystem)."""
        from cruise_control_tpu_torch.common.trace import Tracer

        return Tracer(
            enabled=self.get("trace.enabled"),
            retention_per_component=self.get(
                "trace.retention.spans.per.component"
            ),
            max_events_per_span=self.get("trace.max.events.per.span"),
        )

    def shape_bucket_policy(self):
        from cruise_control_tpu_torch.models.state import ShapeBucketPolicy

        return ShapeBucketPolicy(
            enabled=self.get("tpu.shape.bucket.enabled"),
            growth=self.get("tpu.shape.bucket.growth"),
            floor=self.get("tpu.shape.bucket.floor"),
        )


def load_properties(path: str) -> dict[str, str]:
    """Java-style .properties loader (reference reads cruisecontrol.properties)."""
    props: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            if "=" in line:
                k, _, v = line.partition("=")
                props[k.strip()] = v.strip()
    return props
