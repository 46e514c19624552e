#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cruise_control_tpu_torch) on one GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA device, nvcc and nvidia-smi, and exits nonzero without a
result line when any phase fails or no CUDA device is present.

Phases:
  1. The card: its name and power limit, then the build of the eleven CUDA
     kernel libraries from cruise_control_tpu_torch/kernels/csrc, and the
     CUDA runtime and driver versions (the loop graph needs 12.4+); then
     the monitor's native serde (g++, phase 23's).
  2. Each kernel against its plain PyTorch version on the card, on the
     inputs of one north-star anneal step, with the kernel's and the plain
     version's times and the least time the card could take: the step's
     four kernels (step_globals within rtol 1e-6 and the same bits over
     100 calls; candidates; select_survivors' survivors, relocation mask
     and count exact, fresh and over successive epochs of one buffer, also
     on synthetic cases; apply_moves bit for bit, one device operation a
     call, every slot back at -1, three times, also on a case of survivors
     meeting on shared hosts), the round prep's two, each one
     cooperative launch (group_by_broker exact through the engine's
     broker/valid entry and the seg entry, and refresh_aggregates bit for
     bit against the plain version on the CPU, three calls each; the
     refresh also without its host pass, the host pass alone, and on the
     same rows dealt round-robin, which shows the hottest broker's tail),
     the schedule kernel (round_schedule, exact over a table of gate
     inputs, EXIT included, every third row at a segmented run's slice
     end), and the two standalone kernels the candidates kernel fused
     (threefry_uniform, move_delta) on the same step's draws and deltas.
  3. A small cluster optimized on the card agrees with the same run on the
     CPU (whose parity with the JAX package the test suite holds).
  4. The main path: GoalOptimizer.optimize on the north-star cluster
     (2,600 brokers, 200k partitions, ~500k replicas) with the north-star
     search config, twice with the same seed, through the fused route
     (one launch of one CUDA graph, a WHILE node over the rounds with
     conditional nodes inside, no masked round, one blocking sync):
     identical placements, rounds and proposals.  Launch counts are zeroed
     just before the first call and read just after; graph launches count
     per replay, round_schedule three a loop iteration plus INIT and EXIT
     (a capture's eager warm-up counts apart, into its thread's record).
  5. A third request on the same optimizer: decommission 1% of the
     brokers; it must reuse the cached engine and its captured graphs (a
     model generation is data: no capture), evacuate every replica and
     give byte for byte the placements of a fresh optimizer's run on the
     same state; its wall is printed beside phase 4's first and repeated
     calls.
  6. The graph route against the legacy host loop at T=0 on the north
     star and on the decommission: identical placements, rounds and
     accepted counts.
  7. Where the time goes: a whole fused run under torch.profiler (device
     busy, idle share, each kernel's device time; the package's kernel
     events inside the run's window and outside it, beside the run's
     launches; one loop-graph launch, no masked round), the captured
     graphs' nodes, one loop iteration on a finished run, a full check and
     a round body replayed alone;
     and an eager north-star step
     (the legacy route's): host clock, launches and device time per step,
     one select launch and no other device operation between candidates
     and apply_moves.
  8. The JBOD path, inter-broker: BASELINE.md configuration 3 exactly as
     bench.py's config_3 builds it (500 brokers, 50,000 partitions, 4
     logdirs a broker; RackAware, DiskCapacity and the two intra-broker
     disk goals, so every delta carries the disk terms; SEARCH): the
     candidates kernel against its plain version on one real step
     (acceptance identical on every candidate), apply_moves bit for bit
     against the plain version on the CPU, the proposal twice with one
     seed (identical), and the graph route against the legacy route at T=0.
  9. rebalance_disk on the same cluster (the intra-broker goals,
     intra_broker=True): the intra kind against its plain version on one
     step, apply_moves bit for bit on rows whose src is their dst, and the
     proposal: no replica changes broker or leadership, disk moves present,
     the objective falls, one sync.
 10. The north star padded by DEFAULT_BUCKET_POLICY through optimize,
     against phase 4's exact run: the same violated goals, every hard goal
     satisfied, the objective within 1e-6 of the starting objective of the
     exact run's; whether the two came out bit-identical is printed.
 11. Warm start on the north star: from the statics' own placement, the
     cold run's trajectory exactly; from phase 4's result, one graph
     launch and one sync, the caller's tensors unchanged.
 12. Convergence diagnostics on the north star (diagnostics=True): phase
     4's placements, rounds and proposals, one graph launch and one sync,
     every round's diagnostics with accepted == sum(accepted_by_kind), the
     convergence summary's last objective the after-report's; warmed runs
     with and without diagnostics timed in turns; select_survivors'
     diagnostics instantiation against its plain version (exact).
 13. The learned prior on the north star: a cold prior is phase 4's run
     bit for bit; the candidates prior variant against its plain version on
     one warm-prior step (a MoveAcceptancePrior fitted on phase 4's
     proposals at mix 0.5), acceptance and the took-the-prior mask
     identical on every candidate; the warm-prior proposal; a second table
     through optimize(prior=) and a third through rebind_prior: no capture,
     one graph launch.
 14. bf16 scoring on the north star: the candidates bf16 variant against
     the bf16 plain version on one step (acceptance identical on every
     candidate, deltas bit for bit), timed against the f32 call in turns;
     the proposal meets
     the JAX package's tolerance gate against phase 4's f32 objective.
 15. The streaming replay on the north star with the prior (phase 13's
     fitted table at mix 0.5, refreshed every window from the previous
     window's proposals): a fused path (LiveState +
     optimize_streaming_cycle) and a staged path
     (LiveState.set_partition_loads + optimize(initial_placement=,
     prior=)), side by side from the same state, over a reflatten and five
     windows (every partition x1.03, 2,000 partitions x1.2, an empty
     window, 20,000 x0.9, every partition x1.03): identical placements,
     proposal columns, reports and live loads every window; one blocking
     sync, no capture, one scatter_loads launch and the dispatches
     {engine.cycle: 1, engine.extract: 1} on every fused cycle; no capture
     on the staged path after the reflatten; every hard goal met.  Then
     scatter_loads against its plain version, bit for bit, on the window-2
     and window-3 inputs (with sentinel, past-the-end and negative rows)
     and an empty window, timed beside the plain version and an
     `index_copy_` pair.  Then a second reflatten on the fused path (the
     live state with its loads, and a broker dead): no capture, the
     placements of a fresh optimizer's run; the captures of each reflatten
     printed, at most one per (bucket, max_rf).
 16. The scenario batch on the north star: 32 what-ifs as bench.py's
     scenarios bench builds them (kill a rack, add 1-3 brokers, remove a
     broker, scale a topic) in one planned shape, scored by
     ScenarioEvaluator.evaluate_states: one graph launch (a WHILE node
     over the captured goal chain and the scenario_step kernel) and one
     sync (dispatch_meter), the loop's counter read back from the device
     equal to the batch size and the launches exactly the capture's
     warm-up plus one body a scenario, every objective and violation bit
     for bit the sequential `_single_eval`'s; warmed batched and sequential walls
     (batched <= sequential asserted), device ms per scenario, the
     capture's seconds and the body's nodes; a second batch of 12 other
     what-ifs with the same varying fields captures nothing.  Then a
     batch whose replica rows vary: the base and the placements of
     phases 4, 5 and 13, the last with its replicas' positions reversed
     in 1,000 partitions (a member table of its own), one launch and one
     sync, each score bit for bit its sequential one.  Then scenario_step
     against its plain version (exact) and timed.
 17. The planner end to end: evaluate(optimize=True) on a lose-rack /
     add-3 / double-a-topic batch of the north star (one engine built and
     rebound twice; every fix meets the hard goals; the captures of each
     anneal printed, at most one per (bucket, max_rf) key, so the later two
     capture nothing, and each of those two fixes is, number for number,
     the fix of a fresh optimizer on that scenario alone), then
     Rightsizer.rightsize with max_anneals=16 on bench.py's
     scenarios cluster (500 brokers, 50,000 partitions, 20 racks, 100
     topics, skew 0.5, seed 7) and on the north star: the verdict, anneals,
     wall and each anneal's captures (at most one per (bucket, max_rf));
     feasibility monotone in the broker count; the north star not
     under-provisioned.
 18. The greedy oracle on the card against its CPU run on small_cluster,
     rack_violated_cluster and dead_broker_cluster: the same violated
     goals, the objective within rtol 1e-5; ms per candidate evaluation;
     the engine captures the phase made, per bucket (the oracle builds no
     engine: none).
 19. One GoalOptimizer shared by two threads on the card: FAST on a
     20-broker cluster, three runs each on one shape and two shapes
     alternating through a one-engine cache, every run the single-thread
     run's placements, proposals and rounds, no engine released while a
     run holds it; then the north star once from each thread, both phase
     4's placements, rounds and proposals.
 20. Prewarm: GoalOptimizer.prewarm of the north star's bucket-padded
     state (phase 10's) captures its engine's graphs on the warm pool
     while a request runs the north star on the same optimizer (phase 4's
     launch counts hold for it); the padded request then captures nothing
     on its path and gives phase 10's unprewarmed placements byte for
     byte.  Both walls, the boot report's captures and
     compile_attribution() are printed.
 21. Segmented execution under the device scheduler (fleet/scheduler.py):
     a north-star optimize granted BACKGROUND with a 0.01 s slice budget
     runs as at least four launches of the engine's one slice graph (the
     loop graph without init; the slice's last round read from device
     memory), one sync each: phase 4's exact run bit for bit, no capture
     added to the bucket, one slice-graph instantiation, every main-path
     kernel launched (round_schedule: INIT, three a loop iteration and one
     EXIT a slice).  Warmed walls of the one-launch, segmented and
     one-round-slice runs in turns, and the extra seconds a slice.  Then
     the same BACKGROUND run preempted by an URGENT decommission of the
     same bucket (phase 5's state) from a second thread on the same
     optimizer and engine: the urgent request waits at most one slice
     wall plus 0.05 s, the paused run lets go of the engine and restores
     itself, and the two results are phases 4's and 5's bit for bit.
     Then the floor of a one-thread kernel node inside a WHILE body (the
     bound of round_schedule's and scenario_step's launches).
     Every optimize result, streaming cycle, scenario batch and outcome of
     phases 4-21 is checked to come from the card: `degraded` False, and
     `summary()["degraded"]` False.
 22. Supervision on the card (common/device_watchdog.py DeviceSupervisor,
     analyzer/optimizer.py's supervised route), on the north star.  On
     the card a classified failure or an open breaker raises
     `DeviceDegradedError`: the card's work is never answered from the
     CPU.  (a) a real OOM, the allocator's own, raised on "engine.run"
     under a supervisor with no retry, a breaker that opens at one
     failure and a probe at once: `DeviceDegradedError` of class OOM
     with the allocator's error as its cause, the breaker open, the
     engine purged, the allocator's bytes back at the phase's start;
     then the probe closes the breaker and the next optimize runs on the
     card, phase 4's run bit for bit, re-capturing the purged engine once
     (its seconds printed).  (b) a real hang: "engine.run" spins the card
     5 s with `torch.cuda._sleep` under a 2 s budget: HANG in about 2 s
     (the wall printed); while the abandoned worker still waits for the
     spin the probe fails and the breaker stays open; the worker then
     runs its real run to its end; the probe closes the breaker and the
     next run, under the same 2 s budget (a recovery with its re-capture
     took 0.61 s on an H100), is phase 4's bit for bit (it
     starts after the spin has ended, so no device sync of it waits for
     the spin: the output says so).  (c) a real sticky error, in a child
     process (`chip_smoke.py --sticky-child`) so that this process's
     context survives: one supervised optimize on a small fixture on the
     card, then a device-side assert (an out-of-range index) inside
     "engine.run": DEVICE_LOST with no retry (two allowed), and a second
     optimize refused with `BreakerOpenError` and no engine invocation
     (its probe fails in the dead context); the child prints one JSON
     line and exits 0.  (d) phase 16's 32 what-ifs under a supervisor
     with no fault: one launch, one sync, every score bit for bit phase
     16's, not degraded; then with a real OOM on "scenario.batch-eval":
     `DeviceDegradedError` of class OOM; then, the probe passed, phase
     16's scores bit for bit again.
 23. The monitor on the card (cruise_control_tpu_torch/monitor), no new
     kernel: (a) the north-star fixture's topology (2,600 brokers on 52
     racks, 200 topics, 200,000 partitions, its replicas in position
     order) and leader loads as a monitored cluster, capacities its broker
     capacity, an aggregator of 5 one-hour windows; (b) one window over
     the wire at full width: every broker's records (CPU, bytes in and out
     of each topic it leads, each led partition's size) serialized by
     MetricSerde, framed and decoded by the native C++ serde (built with
     g++ into the package's _build/; it must be the path that ran),
     turned into partition samples by CruiseControlMetricsReporterSampler
     and added to the aggregator, with seconds and records per second;
     (c) the other windows with those samples through
     add_samples_columnar, the one in progress at x1.1 on every 7th
     partition; (d) LoadMonitor.cluster_model() on the card (the monitor
     names no device, so it builds on the current CUDA device), split into
     the aggregation, the join and the build with its copy to the card:
     every tensor on CUDA, every field byte for byte the same monitor's
     build with device="cpu", validate passing; (e) GoalOptimizer.optimize
     on that model with the north-star search config, every hard goal met;
     (f) the window roll: the next window's samples complete the x1.1
     window; history_snapshot, extract_window_delta, the partitions'
     replica rows (partition_replica_table and the catalog lookup, as the
     JAX package's streaming controller builds them at a reflatten, then
     the window's rows), follower_loads, each timed; the delta's changed
     set exactly the x1.1 partitions; then optimize_streaming_cycle on a
     LiveState of (d)'s model: one blocking sync, no capture, the two
     counted dispatches, the window's loads scattered, every hard goal
     met.
 24. The self-healing loop on phase 23's monitored cluster, no new
     kernel: brokers 2,574-2,599 die; AnomalyDetector.run_once with a
     BrokerFailureDetector and a GoalViolationDetector on the monitor's
     model on the card (one sync a detection, its lists and violations
     the CPU's), the broker failure's fix started by a SelfHealingNotifier;
     the fix builds the model on the card, optimizes it with SEARCH and
     executes every proposal through the Executor on a
     SimulatedClusterAdmin (link 1e12 B/s) with a journal at fsync batch
     1: no dead task, no replica on a dead broker, each partition its
     proposal's, the generation grown by one a landed reassignment and an
     election, no hard goal violated on the executed topology; then the
     same execution crashed halfway and recovered by a fresh Executor over
     the journal: no reassignment submitted twice, no throttle left, the
     same topology.  The walls of each part are printed.
 25. The real-cluster loop over the Kafka wire protocol, no new kernel,
     against the port's in-process fake cluster (testing/fake_kafka.py:
     one selector thread serves every broker's listener, each on its
     host's loopback address, and every connection): the north
     star's data plane (the fake built from phase 23's topology, Metadata,
     the metadata provider's refresh and the admin's topology timed and
     the topology phase 23's); phase 23's wire window produced into
     __CruiseControlMetrics and fetched back through the native decoder,
     bit for bit phase 23's window, and cluster_model over the wire byte
     for byte phase 23's model; a warm restart through KafkaSampleStore;
     then at configuration 3's width: 1% of the brokers killed, detected
     over the wire, the fix optimized on the card and executed through
     KafkaClusterAdmin with the journal at fsync batch 1 (no dead task, no
     replica on a dead broker, no throttle left, no hard goal violated on
     a model rebuilt from the wire), crashed halfway and recovered with no
     reassignment submitted twice, and the decision ledger around it (the
     record from the card's result in one transfer, its outcome and a
     calibration).
 26. BASELINE configuration 2 on the card against the committed converged
     greedy baseline (BASELINE_GREEDY.json config2, fingerprint checked;
     the greedy oracle runs on the card only if it is stale): the wall,
     both objectives and tpu_beats_greedy as bench.py decides it.
 27. The REST service on the card (service/*, no new kernel), from phase
     23's topology and windows at the north star's width, nothing cut:
     build_service(device="cuda") with a SimulatedClusterAdmin and the
     config keys of phase 4's SEARCH, served over loopback HTTP.  GET
     /proposals cold, cached and with ignore_proposal_cache=true, every
     main-path kernel launched, the served result bit for bit
     GoalOptimizer.optimize on the same monitor's model, every hard goal
     met; /state, /load, /partition_load and /kafka_cluster_state with
     their walls and sizes; a 1% /remove_broker dry run bit for bit the
     same decommission built as phase 5 builds it; /simulate with four
     what-ifs; a real OOM under a request: 503 with its failure class,
     the breaker open on /state, one OPTIMIZER_DEGRADED, a 503 with
     Retry-After while open, then 200 with the same proposals; cccli
     proposals and state; an executed /demote_broker polled on
     /user_tasks to its end, no leader left on the broker (check_service).
 28. The streaming controller on the card through the service (no new
     kernel), from phase 23's topology and windows at the north star's
     width, nothing cut: build_service(device="cuda") with phase 27's
     SEARCH keys, controller.enabled=true and the prior at its defaults,
     cycles driven by run_once().  The windows: (a) the initial reflatten,
     (b) phase 23's x1.1 window, (c) an empty window, (d) and (e) 200
     partitions x1.2 each, (f) every partition x1.03, (g) a broker death
     through the metadata; every hard goal met after every cycle, 2
     reflattens and 5 delta applies over (a)-(g), every cycle fused that
     can be (at most 2 dispatches, one sync, no capture, one scatter_loads
     launch), the live loads a fresh model's after each delta window;
     GET /proposals serving the last publish with no kernel launched; (h)
     a real OOM in a fused cycle on the loop thread, counted, the previous
     publish served; (i) the reflatten after it; (j) start_up's loop
     thread publishing on its own, joined by shutdown; a cold-mode service
     byte for byte a direct optimize.  Prints each stage's walls and
     histograms, history_snapshot's walls, the cold cycles, each cycle's
     rounds, the streaming-publish SLO and a cProfile of one steady
     window's host stages (check_controller).
 29. The replicated mesh (parallel/mesh.py): (a) the candidates kernel's
     lane slices at n = 2, 4 and 8, concatenated, bit for bit the full-K
     launch on one real step of the default, prior and bf16 kinds (the
     north star) and the intra kind (configuration 3's JBOD cluster), each
     slice against its plain version's, the slice launches timed at K/2
     and K/4 (check_mesh_slices); (b) a 1x1 rank group over NCCL at the
     north star: placements, objective and history bit for bit the
     single-device engine's, no collective, the group's start-up and a
     repeated run's wall against the plain engine's (check_mesh_one_card).
Then one JSON line of per-kernel results (each row's `ms_source` says how
its `ms` was taken: "profiler", or "cuda graph" where torch.profiler saw
no device activity in PROFILER_ATTEMPTS sessions), the nvidia-smi line,
and the final JSON line naming the device.

`python3 chip_smoke.py --monitor` runs phase 1, the fixture and phase 23
alone, and ends with a short JSON line instead of the results;
`python3 chip_smoke.py --executor` runs phase 1, the fixture and phases 23
and 24 so, `python3 chip_smoke.py --kafka` phases 1, 23 and 25,
`python3 chip_smoke.py --service` phases 1, 23 and 27,
`python3 chip_smoke.py --controller` phases 1, 23 and 28, and
`python3 chip_smoke.py --mesh` phases 1 and 29; with four cards or more it
adds (c): 1x4, 2x2 and 4x1 at the north star over NCCL, 1x4 bit for bit the
single-device engine, every portfolio and grid chain bit for bit a
one-card run from its key, the carries of each model row bitwise equal,
and the collective bytes and count a step, walls and syncs
(check_mesh_cards).

`python3 chip_smoke.py --sticky-child` is phase 22's child alone; it
needs the kernels built (phase 1) and leaves its process's CUDA context
unusable, so it exits without CUDA teardown.
"""

import contextlib
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# north-star cluster and search config (the JAX package's bench.py:51-84)
NORTH_STAR_SPEC = dict(
    num_brokers=2600,
    num_racks=52,
    num_topics=200,
    num_partitions=200_000,
    min_replication=2,
    max_replication=3,
    skew=0.5,
    broker_capacity=(100.0, 500_000.0, 500_000.0, 5_000_000.0),
    mean_cpu=0.15,
    mean_nw_in=400.0,
    mean_nw_out=500.0,
    mean_disk=4000.0,
)
# the sharded-model mode's own deployment (the JAX package's
# parallel/mesh.py docstring: 25k brokers and 2M partitions): the north
# star's spec ten times over, its racks, replication and loads kept
TARGET_SPEC = dict(NORTH_STAR_SPEC, num_brokers=25_000, num_topics=2_000, num_partitions=2_000_000)
SEARCH = dict(num_candidates=16384, leadership_candidates=4096, steps_per_round=64, num_rounds=8, seed=0)
# BASELINE.md configuration 3: bench.py's MID_SPEC (bench.py:65) with 4
# logdirs a broker, and config_3's chain (bench.py:230)
MID_SPEC = dict(num_brokers=500, num_racks=20, num_topics=100, num_partitions=50_000, skew=0.5,
                broker_capacity=(100.0, 300_000.0, 300_000.0, 3_000_000.0), mean_cpu=0.2,
                mean_nw_in=500.0, mean_nw_out=600.0, mean_disk=5000.0)
CONFIG3_CHAIN = ("RackAwareGoal", "DiskCapacityGoal", "IntraBrokerDiskCapacityGoal",
                 "IntraBrokerDiskUsageDistributionGoal")
# BASELINE.md configuration 2: bench.py's SMALL_SPEC (bench.py:77), SEARCH_SMALL
# (:86) and config_2's chain (:200)
SMALL_SPEC = dict(num_brokers=50, num_partitions=5000, num_racks=5, num_topics=20, skew=0.8)
SEARCH_SMALL = dict(num_candidates=2048, leadership_candidates=512, steps_per_round=64, num_rounds=8, seed=0)
CONFIG2_CHAIN = ("ReplicaCapacityGoal", "DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
                 "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal")
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the f32 rate outside
# the tensor cores, used as the rate of these kernels' scalar ALU work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

#: the package's own CUDA kernels, by the names the profiler reports
OWN_KERNELS = ("threefry_uniform_kernel", "move_delta_kernel", "candidates_kernel", "select_survivors_kernel", "apply_moves_kernel",
               "group_by_broker_kernel", "refresh_aggregates_kernel", "step_globals_kernel",
               "round_schedule_kernel", "scatter_loads_kernel", "scenario_step_kernel",
               "shard_sources_kernel", "own_rows_kernel", "own_parts_kernel", "shard_prc_kernel")


def kernel_name(name: str) -> str:
    """A device event's name without its parameters, at most 60
    characters; one of OWN_KERNELS also without its return type and
    template arguments ("void candidates_kernel<true, false>(Ctx)" ->
    "candidates_kernel")."""
    head = name.split("(")[0]
    base = head.split("<")[0].removeprefix("void ")
    return base if base in OWN_KERNELS else head[:60]


SOURCES = {
    "threefry_uniform": ("threefry.cu", "cruise_control_tpu/analyzer/engine.py:958"),
    "move_delta": ("move_delta.cu", "cruise_control_tpu/analyzer/engine.py:2439"),
    "candidates": ("candidates.cu", "cruise_control_tpu/analyzer/engine.py:2569"),
    "select_survivors": ("select.cu", "cruise_control_tpu/analyzer/engine.py:2643"),
    "apply_moves": ("apply.cu", "cruise_control_tpu/analyzer/engine.py:2715"),
    "group_by_broker": ("group.cu", "cruise_control_tpu/analyzer/engine.py:1597"),
    "refresh_aggregates": ("refresh.cu", "cruise_control_tpu/analyzer/engine.py:1433"),
    "step_globals": ("step_globals.cu", "cruise_control_tpu/analyzer/engine.py:1623"),
    "round_schedule": ("schedule.cu", "cruise_control_tpu/analyzer/engine.py:2941"),
}
#: the candidates kernel's cases on the JBOD path (phases 8 and 9), as rows
#: of their own in the kernels line
JBOD_CASES = {
    "candidates_disk_terms": ("candidates.cu", "cruise_control_tpu/analyzer/engine.py:1767"),
    "candidates_intra": ("candidates.cu", "cruise_control_tpu/analyzer/engine.py:2078"),
}
#: the variants of phases 12-14, as rows of their own in the kernels line
VARIANT_CASES = {
    "select_survivors_diag": ("select.cu", "cruise_control_tpu/analyzer/engine.py:2699"),
    "candidates_prior": ("candidates.cu", "cruise_control_tpu/analyzer/engine.py:1832"),
    "candidates_bf16": ("candidates.cu", "cruise_control_tpu/analyzer/engine.py:1656"),
}
#: the kernels the main path launches (scatter_loads in the reported run's
#: head, with an empty window on a proposal); the other two are standalone
#: since the candidates kernel fused them, and the main path must launch
#: them 0 times
PATH_KERNELS = ("candidates", "select_survivors", "apply_moves", "group_by_broker",
                "refresh_aggregates", "step_globals", "round_schedule", "scatter_loads")
#: phase 15's kernel, a row of its own in the kernels line
STREAM_CASES = {"scatter_loads": ("scatter.cu", "cruise_control_tpu/models/whatif.py:393")}
#: phase 16's kernel, a row of its own in the kernels line
SCENARIO_CASES = {"scenario_step": ("scenario.cu", "cruise_control_tpu/analyzer/scenario_eval.py:205")}
#: phase 15's windows after the reflatten: (partitions, load factor); None
#: is every partition
STREAM_WINDOWS = ((None, 1.03), (2_000, 1.2), (0, 1.0), (20_000, 0.9), (None, 1.03))
#: placements of earlier phases ("4", "5", "13": replica_broker,
#: replica_is_leader, replica_disk), for phase 16's batch that varies them
PLACEMENTS: dict = {}
#: phase 10's unprewarmed run of the bucket-padded north star (its
#: placements and wall), which phase 20's prewarmed run must match
PADDED_RUN: dict = {}
#: phase 16's 32 scores (objectives, violations), which phase 22's
#: supervised batch must match
SCENARIO_SCORES: dict = {}
#: the results phases 4-21 checked for `degraded` False, by kind
AUDIT: dict = {}
#: phase 23's aggregator: windows kept and a window's span (the JAX
#: package's num.partition.metrics.windows and partition.metrics.window.ms
#: defaults)
MONITOR_WINDOWS = 5
MONITOR_WINDOW_MS = 3_600_000


def check(ok, message: str) -> None:
    """Fail the smoke test (explicitly: `python -O` strips asserts)."""
    if not ok:
        raise RuntimeError(message)


def log(*a):
    print(*a, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nb: int, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nb / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps=50) -> float:
    """Mean device time of fn() over reps back-to-back calls: CUDA events
    before and after the run, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=5) -> float:
    """Device time per call of fn() without the profiler: reps calls
    captured into one CUDA graph (the package's `capture`, so the launches
    count nowhere), CUDA events around `replays` replays after a warm one.
    The graph's nodes run back to back with no host between them, so this
    is the device time plus the gap from one node to the next."""
    import torch

    from cruise_control_tpu_torch.kernels import capture, graph_lock, recording

    with recording():
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with capture(g, torch.cuda.Stream()):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    with graph_lock():
        del g
    return start.elapsed_time(end) / (replays * reps)


def device_ms(fn, reps=20) -> tuple[float, float, dict] | None:
    """(device time per call of everything fn() launches, of which the
    package's own kernels, {device operation: [ms per event, events per
    call]}), from torch.profiler's CUDA activity over reps calls after one
    warm-up call; None when the profiler saw no device activity.  The
    profiler may drop a few events of a window (18 of 20 in some runs), so
    an operation's time per call is its mean time per event times its
    events per call rounded to a whole number (at least one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(kernel_name(e.name), [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    if not by_name:
        return None
    total = own = 0.0
    for name, rec in by_name.items():
        per_call = rec[0] / rec[1] * max(1, round(rec[1] / reps))
        by_name[name] = [rec[0] / rec[1], rec[1] / reps]
        total += per_call
        if name in OWN_KERNELS:
            own += per_call
    return total, own, by_name


#: Sessions of torch.profiler a measurement tries: from a few minutes into
#: the script on, about half of the sessions show no device activity, at
#: random (PERF.md §6).
PROFILER_ATTEMPTS = 3


def measure(fn, reps=20, graph=True) -> dict:
    """A function's time on the card two ways: `ms`, device time per call
    (profiler, up to PROFILER_ATTEMPTS sessions: `profiler_attempts`);
    `call_ms`, the wall between CUDA events around reps back-to-back calls,
    which the host's issue rate bounds when kernels are short.  Without
    profiler device activity `ms` is `graph_ms`'s device time (`ms_source`
    "cuda graph"), or, for a function a graph cannot capture (`graph=False`:
    the plain versions and library calls), `call_ms` (`ms_source` "cuda
    events")."""
    call = time_ms(fn, reps)
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        dev = device_ms(fn, reps)
        if dev is not None:
            return dict(ms=dev[0], own_kernel_ms=dev[1], call_ms=call, ms_source="profiler",
                        profiler_attempts=attempt, by_kernel=dev[2])
    if graph:
        return dict(ms=graph_ms(fn, reps), own_kernel_ms=None, call_ms=call, ms_source="cuda graph",
                    by_kernel=None)
    return dict(ms=call, own_kernel_ms=None, call_ms=call, ms_source="cuda events", by_kernel=None)


class Capture:
    """Records the arguments of every call of each kernel wrapper while one
    anneal step runs, in call order (tensors cloned, so in-place kernels
    leave them)."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = {}

    @staticmethod
    def _clone(x):
        import torch

        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return {k: Capture._clone(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type) and hasattr(x, "clone"):
            return x.clone()
        return x

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
        for m, n, fn in self.saved:
            def rec(*args, _n=n, _fn=fn, **kw):
                self.calls.setdefault(_n, []).append((
                    tuple(self._clone(a) for a in args),
                    {k: self._clone(v) for k, v in kw.items()},
                ))
                return _fn(*args, **kw)

            setattr(m, n, rec)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def one_launch(rec: dict, kernel: str) -> None:
    """The measured call ran one device operation, `kernel` (no copy, no
    clear, no PyTorch op around it), where the profiler saw the device."""
    if rec["by_kernel"] is not None:
        check(set(rec["by_kernel"]) == {kernel},
              f"{kernel}: the call ran other device operations: {sorted(rec['by_kernel'])}")


def timings(kernel: dict, plain: dict) -> dict:
    return dict(ms=kernel["ms"], own_kernel_ms=kernel["own_kernel_ms"], call_ms=kernel["call_ms"],
                plain_ms=plain["ms"], plain_call_ms=plain["call_ms"],
                ms_source=kernel["ms_source"], plain_ms_source=plain["ms_source"],
                by_kernel=kernel.get("by_kernel"))


def delta_bar(plain):
    """move_delta's bar: the kernel divides where PyTorch's CUDA ops
    multiply by reciprocals of scalars, and each delta is a difference of
    lane sums, so rounding shows relative to the batch's largest delta."""
    return 1e-4 * (plain.abs() + 1e-2 * float(plain.abs().max())) + 1e-12


def candidates_bound_bytes(eng, carry, prop) -> int:
    """Bytes one step's candidates need, each read or written once: the
    sampled replicas' rows (59 B: placement, partition, topic, flags,
    position, both load rows), the members' brokers and leader flags (5 B),
    the member rows, the rack cells, the rows of the brokers (64 B) and
    hosts (33 B) the candidates touch with those brokers' disk rows, the
    plan's CDF, the globals, the draws' destination ids and the outputs:
    22 B of bundle a candidate, 53 B a relocation row, 64 B a leadership row."""
    import torch

    sx, st = eng.statics, eng.statics.state
    s = st.shape
    payr, payl = prop["payr"], prop["payl"]
    sampled = torch.unique(torch.cat([payr["r"], payl["rf"], payl["rt"]]).long())
    parts = torch.unique(torch.cat([prop["part1"], prop["part2"]]).long())
    members = sx.part_replicas[parts].flatten()
    members = torch.unique(members[members < s.R].long())
    member_only = int(members.numel()) - int(torch.isin(members, sampled).sum())
    brokers = torch.unique(torch.cat([prop["src"], prop["dst"]]).long())
    hosts = torch.unique(st.broker_host[brokers])
    cells = torch.unique(torch.cat([
        prop["part1"].long() * s.num_racks + st.broker_rack[prop["src"].long()],
        prop["part1"].long() * s.num_racks + st.broker_rack[prop["dst"].long()],
        prop["part2"].long() * s.num_racks + st.broker_rack[prop["src"].long()],
        prop["part2"].long() * s.num_racks + st.broker_rack[prop["dst"].long()],
    ]))
    D, K = s.max_disks_per_broker, int(prop["delta"].shape[0])
    return (59 * int(sampled.numel()) + 5 * member_only
            + 4 * int(parts.numel()) * int(sx.part_replicas.shape[1]) + 4 * int(cells.numel())
            + (64 + 9 * D) * int(brokers.numel()) + 33 * int(hosts.numel())
            + 4 * s.B + 4 * eng.K_r + 4 * (22 + s.num_topics)
            + 22 * K + 53 * int(payr["r"].shape[0]) + 64 * int(payl["rf"].shape[0]))


def candidates_intra_bound_bytes(eng, cp, plan, prop) -> int:
    """Bytes one intra-broker step's candidates need, each read or
    written once: the sampled replicas' rows (broker, partition, logdir,
    topic, valid and leader flags: 18 B; the leader load row, and the
    follower row of a follower: 16 B each; the original logdir when moves
    are priced: 4 B), the touched topics' movable flags, the touched
    brokers' health (1 B, 2 B with the disk terms) and logdir rows (load,
    capacity, health: 9 B a logdir), the plan's CDF when it draws by
    importance, the total disk load, the move cost and the temperature,
    and the outputs: 22 B of bundle a candidate, 53 B a relocation row."""
    import torch

    st = eng.statics.state
    s, payr = st.shape, prop["payr"]
    sampled = torch.unique(payr["r"].long())
    followers = int((~st.replica_is_leader[sampled]).sum())
    topics = torch.unique(st.replica_topic[sampled])
    brokers = torch.unique(payr["src"].long())
    priced = plan is not None and bool(cp.replica_move_cost)
    disk = cp.tp.has_disk_terms
    K = int(prop["delta"].shape[0])
    return ((34 + 4 * priced) * int(sampled.numel()) + 16 * followers + int(topics.numel())
            + (1 + disk + 9 * s.max_disks_per_broker) * int(brokers.numel())
            + 4 * s.B * (cp.n_imp(K, plan) > 0) + 4 * disk + 4 * priced + 4
            + 22 * K + 53 * int(payr["r"].shape[0]))


def check_kernels(state, cfg) -> dict:
    """Phase 2: every kernel against its plain version on one real step's inputs."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import apply as apply_k
    from cruise_control_tpu_torch.kernels import candidates as cand_k
    from cruise_control_tpu_torch.kernels import move_delta as md
    from cruise_control_tpu_torch.kernels import select as select_k
    from cruise_control_tpu_torch.kernels import threefry

    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    targets = [(cand_k, "candidates"), (select_k, "select_survivors"), (apply_k, "apply_moves")]
    with Capture(targets) as cap:
        eng.step(carry, 0.0, plan)
    torch.cuda.synchronize()
    out = {}
    dev = state.device

    # candidates: ids, masks and payload rows exact, deltas within the bar,
    # acceptance identical except within the bar of the threshold; the
    # plain version's move_delta inputs are recorded for the check below
    (c_args, c_kw), = cap.calls["candidates"]
    cp, sx, c0, keys, g, plan_c, temp = c_args
    ck = cand_k.candidates(*c_args, **c_kw)
    with Capture([(md, "move_delta_plain")]) as md_cap:
        cpl = cand_k.candidates_plain(*c_args, **c_kw)
    K = int(cpl["delta"].shape[0])
    for f in ("feas", "src", "dst", "part1", "part2"):
        check(torch.equal(ck[f], cpl[f]), f"candidates: {f} differs from the plain version")
    for name in ("payr", "payl"):
        for f, want in cpl[name].items():
            check(torch.equal(ck[name][f], want), f"candidates: payload {name}.{f} differs")
    err = float((ck["delta"] - cpl["delta"]).abs().max())
    bar = delta_bar(cpl["delta"])
    bad = int(((ck["delta"] - cpl["delta"]).abs() > bar).sum())
    check(bool(torch.isfinite(ck["delta"]).all()) and bad == 0,
          f"candidates: {bad} deltas outside tolerance (max err {err})")
    u = threefry.uniform_plain(keys.u.words, K, cand_k.U_MIN, 1.0, dev)
    thresh = -temp * torch.log(u) - 1e-12
    near = (cpl["delta"] - thresh).abs() <= bar
    differ = ck["accept"] != cpl["accept"]
    check(not bool((differ & ~near).any()), "candidates: acceptance differs away from the threshold")
    kt = measure(lambda: cand_k.candidates(*c_args, **c_kw))
    pt = measure(lambda: cand_k.candidates_plain(*c_args, **c_kw), graph=False)
    if kt["by_kernel"] is not None:
        own = {k: v[1] for k, v in kt["by_kernel"].items() if k in OWN_KERNELS}
        check(list(own) == ["candidates_kernel"] and round(own["candidates_kernel"]) == 1,
              f"candidates: a call ran other kernels of the package than one candidates_kernel: {own}")
    nb = candidates_bound_bytes(eng, c0, ck)
    # ~600 operations a candidate: 3-6 threefry hashes of ~80, two broker
    # lanes of ~75, host terms, the tiebreak and the extra terms; ~90 a
    # broker or host for the old-state terms, the least work counting
    # them once each (the kernel repeats them on spare lanes)
    b_ms, b_by = bound(nb, 600.0 * K + 90.0 * (state.shape.B + state.shape.num_hosts))
    out["candidates"] = dict(
        max_abs_err=err, **timings(kt, pt), bound_ms=b_ms, bound_by=b_by, bound_bytes=nb,
        tolerance="ids, masks, payload exact; |d| <= 1e-4 (|plain| + 1e-2 max|plain|); "
                  "accept exact outside that bar of the threshold",
        accept_differs=int(differ.sum()), accepted=int(ck["accept"].sum()), n=K,
    )

    # threefry_uniform (standalone since the candidates kernel draws
    # inline): the Metropolis draw over all K candidates and a source-index
    # draw over the replica prefix, under the step's keys; bit-exact
    n_src = eng.statics.gen.values()["n_source"]
    uk = threefry.uniform(keys.u.words, K, minval=cand_k.U_MIN, maxval=1.0, device=dev)
    ik = threefry.uniform_idx(keys.lead.words, K, n_src, device=dev)
    ip = threefry.uniform_idx_plain(keys.lead.words, K, n_src, dev)
    same = bool((uk.view(torch.int32) == u.view(torch.int32)).all()) and bool((ik == ip).all())
    err = max(float((uk - u).abs().max()), float((ik - ip).abs().max()))
    check(same, f"threefry_uniform differs from its plain version (max err {err})")
    kt = measure(lambda: threefry.uniform(keys.u.words, K, minval=cand_k.U_MIN, maxval=1.0, device=dev))
    pt = measure(lambda: threefry.uniform_plain(keys.u.words, K, cand_k.U_MIN, 1.0, dev), graph=False)
    # 4 bytes written per draw; ~80 integer operations per draw (20 rounds of
    # add/rotate/xor, key injections, the float tail)
    b_ms, b_by = bound(4 * K, 80.0 * K)
    out["threefry_uniform"] = dict(max_abs_err=err, **timings(kt, pt), bound_ms=b_ms,
                                   bound_by=b_by, tolerance="bit-exact", n=K)

    # move_delta (standalone since the candidates kernel fused it): the
    # plain candidates' three evaluations (relocations, swaps, leadership
    # transfers), each at its own shape; `ms`, `plain_ms` and `bound_ms`
    # are the mean per launch over the three
    calls = md_cap.calls["move_delta_plain"]
    check(len(calls) == 3, f"move_delta: {len(calls)} evaluations in one step, expected 3")
    per_call = []
    for kind, K_kind, (args, kw) in zip(("relocation", "swap", "leadership"),
                                        (eng.K_r, eng.K_s, eng.K_l), calls):
        tp, sx, c, g = args
        n = int(kw["src"].shape[0])
        check(n == K_kind, f"move_delta: the {kind} call has {n} candidates, expected {K_kind}")
        dk = md.move_delta(tp, sx, c, g, **kw)
        dp = md.move_delta_plain(tp, sx, c, g, **kw)
        err = float((dk - dp).abs().max())
        bad = int(((dk - dp).abs() > delta_bar(dp)).sum())
        check(torch.isfinite(dk).all() and bad == 0,
              f"move_delta ({kind}): {bad} deltas outside tolerance (max err {err})")
        flips = int(((dk < 0) != (dp < 0)).sum())
        kt = measure(lambda a=args, kw=kw: md.move_delta(*a, **kw))
        pt = measure(lambda a=args, kw=kw: md.move_delta_plain(*a, **kw), graph=False)
        st = sx.state
        # bytes the function needs: each candidate's inputs and output once,
        # the broker rows of the brokers this call touches (aggregates,
        # capacity, alive, host: 53 B), every touched host's multi-broker
        # flag, and the load and capacity rows (32 B) of hosts that a
        # cross-host candidate touches
        src, dst = kw["src"].long(), kw["dst"].long()
        brokers = torch.unique(torch.cat([src, dst]))
        h_s, h_d = st.broker_host[src].long(), st.broker_host[dst].long()
        cross = h_s != h_d
        hosts = torch.unique(st.broker_host[brokers])
        hosts_cross = torch.unique(torch.cat([h_s[cross], h_d[cross]]))
        nb = (nbytes(kw["src"], kw["dst"], kw["dload_src"], kw["dload_dst"], kw["dcount"],
                     kw["dlcount"], kw["dpot"], kw["dlbin"], kw["dlbin_src"]) + 4 * n
              + 53 * brokers.numel() + hosts.numel() + 32 * hosts_cross.numel() + 88)
        # ~4 lanes x 75 flops, host terms 4 x 14, tiebreak ~70
        b_ms, b_by = bound(nb, 430.0 * n)
        per_call.append(dict(kind=kind, n=n, max_abs_err=err, **timings(kt, pt), bound_ms=b_ms,
                             bound_by=b_by, bound_bytes=nb, sign_flips=flips))
    # both replicas of a partition carry the partition's leader load, so the
    # real leadership call has dlbin_src == dlbin; shift the src side by 1-2x
    # the mean leader bytes-in once, so that a kernel mixing up or ignoring
    # the two lanes shows
    args, kw = calls[2]
    g = args[3]
    u2 = torch.linspace(1.0, 2.0, eng.K_l, device=dev)
    kw = dict(kw, dlbin_src=kw["dlbin"] + g["avg_lbin"] * u2)
    dk, dp = md.move_delta(*args, **kw), md.move_delta_plain(*args, **kw)
    check(bool(((dk - dp).abs() <= delta_bar(dp)).all()), "move_delta: distinct dlbin_src outside tolerance")
    per_call[2]["max_abs_err_distinct_dlbin_src"] = float((dk - dp).abs().max())
    mean = {k: sum(r[k] for r in per_call) / 3 for k in ("ms", "call_ms", "plain_ms", "plain_call_ms",
                                                          "bound_ms")}
    by_bytes = sum(r["bound_bytes"] for r in per_call) / HBM_BYTES_PER_S
    by_ops = 430.0 * sum(r["n"] for r in per_call) / ALU_OPS_PER_S
    out["move_delta"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in per_call), **mean,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        ms_source=per_call[0]["ms_source"], tolerance="|d| <= 1e-4 (|plain| + 1e-2 max|plain|)",
        calls=per_call, n=sum(r["n"] for r in per_call),
    )

    # select_survivors: exact survivors, relocation mask and count, on the
    # captured step and the synthetic cases, fresh and over epochs of one
    # buffer
    (args, kw), = cap.calls["select_survivors"]
    sizes = dict(B=kw["num_brokers"], P=kw["num_parts"], n_r=kw["n_r"], n_s=kw["n_s"])
    diff = check_select(select_k, [args, perturbed_select_args(args, 1), args,
                                   perturbed_select_args(args, 2), args], **sizes)
    cases = check_select_cases(select_k, dev)
    survive, sv_r, acc = select_k.select_survivors(*args, **kw)
    check(int(acc) > 0, "select_survivors: no survivor in the captured step")
    Ks = int(args[0].shape[0])
    bufs = select_k.select_buffers(Ks, sizes["n_r"], sizes["n_s"], sizes["B"], sizes["P"], dev)
    kt = measure(lambda: select_k.select_survivors(*args, **{**kw, "acc": acc, "bufs": bufs}))
    pt = measure(lambda: select_k.select_plain(*args, *sizes.values()), graph=False)
    b_ms, b_by = bound(nbytes(*args, survive, sv_r, acc), 12.0 * Ks)
    out["select_survivors"] = dict(max_abs_err=float(diff), **timings(kt, pt), bound_ms=b_ms,
                                   bound_by=b_by,
                                   tolerance="exact survivors, relocation mask and count; fresh and "
                                             "over 5 epochs of one buffer up to the last",
                                   synthetic_cases=cases, survivors=int(survive.sum()), n=Ks)

    # apply_moves: in place, from a clone of the captured carry each time,
    # three times; bit for bit (one broker per host here, so the plain
    # version's CUDA index_add_ never repeats an index inside one call, and
    # adds in the reference's order too); every slot back at -1
    ((sx_a, c0, sv_r, payr, sv_l, payl), _), = cap.calls["apply_moves"]
    err = 0.0
    for _ in range(3):
        ck, cp = c0.clone(), c0.clone()
        apply_k.apply_moves(sx_a, ck, sv_r, payr, sv_l, payl)
        apply_k.apply_plain(sx_a, cp, sv_r, payr, sv_l, payl)
        torch.cuda.synchronize()
        for f in ("replica_broker", "replica_disk", "replica_is_leader", "broker_replica_count",
                  "broker_leader_count", "broker_topic_count", "part_rack_count", "broker_load",
                  "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load", "host_load"):
            a, b = getattr(ck, f), getattr(cp, f)
            if a.dtype == torch.float32:
                err = max(err, float((a - b).abs().max()))
            check(torch.equal(a, b), f"apply_moves: {f} differs from the plain version")
        check(bool((sx_a.apply_slots == -1).all()), "apply_moves left a slot set")
    moved = ck.clone()
    collisions = check_apply_collisions(cfg, dev)
    # timed on a scratch carry: repeated application moves the same rows
    # again, which is the same work (the values drift, the indices do not)
    kt = measure(lambda: apply_k.apply_moves(sx_a, ck, sv_r, payr, sv_l, payl))
    one_launch(kt, "apply_moves_kernel")
    pt = measure(lambda: apply_k.apply_plain(sx_a, cp, sv_r, payr, sv_l, payl), graph=False)
    n_rel, n_lead = int(sv_r.sum()), int(sv_l.sum())
    # every row's survivor flag is read; only a survivor reads its payload
    # row, and it reads and writes its placement and aggregate words: 264 B
    # for a relocation row, 186 B for a leadership row
    row_r = sum(payr[f].element_size() * payr[f][:1].numel() for f in apply_k.REL_FIELDS)
    row_l = sum(payl[f].element_size() * payl[f][:1].numel() for f in apply_k.LEAD_FIELDS)
    nb = nbytes(sv_r, sv_l) + (row_r + 264) * n_rel + (row_l + 186) * n_lead
    b_ms, b_by = bound(nb, 60.0 * (n_rel + n_lead))
    out["apply_moves"] = dict(max_abs_err=err, **timings(kt, pt), bound_ms=b_ms, bound_by=b_by,
                              tolerance="bit for bit", collision_case=collisions,
                              survivor_rows=n_rel + n_lead, bound_bytes=nb,
                              payload_row_bytes=[row_r, row_l], n=int(sv_r.shape[0] + sv_l.shape[0]))
    out.update(check_round_kernels(eng, moved))
    for name, rec in out.items():
        log(json.dumps({"phase": "kernel", "name": name, **rec}))
    del eng, carry, plan, cap, moved
    return out


def perturbed_select_args(args, seed: int) -> list:
    """The step's select inputs with its deltas shuffled and its acceptance
    redrawn (same sizes, other winners)."""
    import torch

    g = torch.Generator(device=args[1].device).manual_seed(seed)
    accept, delta, *rest = args
    perm = torch.randperm(delta.shape[0], generator=g, device=delta.device)
    redrawn = torch.rand(accept.shape, generator=g, device=accept.device) < 0.5
    return [redrawn, delta[perm].contiguous(), *rest]


def check_select(select_k, runs, B, P, n_r, n_s) -> int:
    """select_survivors on runs[0] in fresh buffers, then on each run in
    turn in one buffer at epochs 1, 2, 3, then the last two the keys can
    tag: survivors, relocation mask and count exactly the plain version's
    each time (a minimum left by an earlier epoch must lose).  Returns the
    number of differing outputs (0)."""
    import torch

    K = int(runs[0][1].shape[0])
    top = select_k.max_epoch(K)
    bufs = select_k.select_buffers(K, n_r, n_s, B, P, runs[0][1].device, n_epochs=top)
    acc = torch.full((1,), 3, dtype=torch.int64, device=runs[0][1].device)
    calls = [(runs[0], None, None, 1)] + list(zip(runs, [bufs] * len(runs), [acc] * len(runs),
                                                  (1, 2, 3, top - 1, top)))
    kept = 0
    for args, b, a, epoch in calls:
        before = 0 if a is None else int(a)
        got = select_k.select_survivors(*args, num_brokers=B, num_parts=P, n_r=n_r, n_s=n_s, acc=a,
                                        bufs=b, epoch=select_k.Epoch(epoch - 1))
        want = select_k.select_plain(*args, B, P, n_r, n_s)
        diff = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        check(diff == 0, f"select_survivors: {diff} mask entries differ from the plain version "
                         f"at epoch {epoch}")
        check(int(got[2]) - before == int(want[2]),
              f"select_survivors: count {int(got[2]) - before} != {int(want[2])} at epoch {epoch}")
        kept += int(want[2])
    check(kept > 0, "select_survivors: no survivor in any call")
    return 0


def check_select_cases(select_k, dev) -> list:
    """check_select on each synthetic case, new draws each epoch."""
    import torch

    from cruise_control_tpu_torch.testing.fixtures import SELECT_CASES, SELECT_INPUTS, select_case

    done = []
    for name in SELECT_CASES:
        cs = [select_case(name, seed) for seed in (0, 1, 2, 3, 0)]
        runs = [[torch.from_numpy(c[f]).to(dev) for f in SELECT_INPUTS] for c in cs]
        if name == "none_accepted":
            # no survivor anywhere: the count and masks stay zero
            got = select_k.select_survivors(*runs[0], num_brokers=cs[0]["B"], num_parts=cs[0]["P"],
                                            n_r=cs[0]["n_r"], n_s=cs[0]["n_s"])
            check(not bool(got[0].any()) and not bool(got[1].any()) and int(got[2]) == 0,
                  "select_survivors: a survivor with none accepted")
        else:
            check_select(select_k, runs, cs[0]["B"], cs[0]["P"], cs[0]["n_r"], cs[0]["n_s"])
        done.append(name)
    return done


def cpu_copy(x):
    """A dataclass of tensors (a cluster state, a grouping) on the CPU."""
    import torch

    return dataclasses.replace(x, **{
        f.name: v.cpu() if isinstance(v, torch.Tensor) else v
        for f in dataclasses.fields(x) for v in (getattr(x, f.name),)
    })


def host_time_ms(fn, reps=20) -> float:
    """Mean host wall of fn() (a CPU function) over reps calls."""
    fn()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    return (time.monotonic() - t0) / reps * 1e3


def check_round_kernels(eng, carry) -> dict:
    """Phase 2, the round's kernels on the north-star carry one step in:
    group_by_broker exact (the engine's broker/valid entry, three times,
    and the seg entry); refresh_aggregates bit for bit against the plain
    version on the CPU (row order, the reference's), three times;
    step_globals within rtol 1e-6 of the plain version and the same run
    after run; round_schedule exact against the plain version on the CPU
    over a table of gate inputs."""
    import itertools

    import numpy as np
    import torch

    from cruise_control_tpu_torch.kernels import schedule as sk
    from cruise_control_tpu_torch.kernels import step_globals as gk
    from cruise_control_tpu_torch.kernels.group import (
        Grouping,
        group_by_broker,
        group_placement,
        group_plain,
        placement_segments,
    )
    from cruise_control_tpu_torch.kernels.refresh import (
        AGG_FIELDS,
        HostGroups,
        refresh_aggregates,
        refresh_plain,
    )

    sx, st = eng.statics, eng.statics.state
    s = st.shape
    R, B, T, P, D, H = s.R, s.B, s.num_topics, s.P, s.max_disks_per_broker, s.num_hosts
    dev = st.device
    out = {}

    # group_by_broker: the engine's call (the broker/valid entry) on the
    # carry's placement, three times into one grouping, and the seg entry
    seg = placement_segments(carry.replica_broker, st.replica_valid, B)
    want = group_plain(seg, B, Grouping.empty(R, B, dev))
    got = Grouping.empty(R, B, dev)
    for _ in range(3):
        for f in ("count", "start", "order"):
            getattr(got, f).fill_(-1)
        group_placement(carry.replica_broker, st.replica_valid, B, out=got)
        for f in ("count", "start", "order"):
            check(torch.equal(getattr(got, f), getattr(want, f)), f"group_by_broker: {f} differs")
    by_seg = group_by_broker(seg, B)
    for f in ("count", "start", "order"):
        check(torch.equal(getattr(by_seg, f), getattr(want, f)), f"group_by_broker (seg entry): {f} differs")
    kt = measure(lambda: group_placement(carry.replica_broker, st.replica_valid, B, out=got))
    one_launch(kt, "group_by_broker_kernel")
    pt = measure(lambda: group_plain(placement_segments(carry.replica_broker, st.replica_valid, B), B, want), graph=False)
    lib = measure(lambda: (torch.argsort(seg, stable=True), torch.bincount(seg, minlength=B + 1)), graph=False)
    # each row's broker id and valid flag read once, its id written once
    # into the order, and the per-broker count and start written once;
    # ~10 integer operations a row
    b_ms, b_by = bound(9 * R + 8 * B, 10.0 * R)
    out["group_by_broker"] = dict(max_abs_err=0.0, **timings(kt, pt), library_ms=lib["ms"],
                                  library_call_ms=lib["call_ms"], bound_ms=b_ms, bound_by=b_by,
                                  bound_bytes=9 * R + 8 * B,
                                  tolerance="exact (order, count, start), 3 calls and the seg entry",
                                  n=R, segments=B)

    # refresh_aggregates: the engine's call on the card against the plain
    # version on the CPU, three times
    place = (carry.replica_broker, carry.replica_is_leader, carry.replica_disk)
    st_cpu = cpu_copy(st)
    hosts_cpu = HostGroups(sx.host_groups.seg.cpu(), cpu_copy(sx.host_groups.group))
    want = {f: torch.empty_like(t, device="cpu") for f, t in carry.aggregates().items()}
    refresh_plain(st_cpu, *[t.cpu() for t in place], want, hosts_cpu)
    kw = dict(hosts=sx.host_groups, group=got, members=sx.part_replicas)
    for _ in range(3):
        res = {f: torch.full_like(t, -1) for f, t in carry.aggregates().items()}
        refresh_aggregates(st, *place, res, **kw)
        for f in (*AGG_FIELDS, "host_load"):
            a, b = res[f].cpu(), want[f]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b), f"refresh_aggregates: {f} differs from the plain version on the CPU")
    kt = measure(lambda: refresh_aggregates(st, *place, res, **kw))
    one_launch(kt, "refresh_aggregates_kernel")
    plain_out = {f: torch.empty_like(t) for f, t in res.items()}
    pt = measure(lambda: refresh_plain(st, *place, plain_out, sx.host_groups), graph=False)
    # the passes: without the host pass (and its barrier), the host pass alone
    no_hosts = measure(lambda: refresh_aggregates(st, *place, res, **dict(kw, hosts=None)))
    hosts_only = measure(lambda: refresh_aggregates(st, *place, res, hosts=sx.host_groups, brokers=False))
    # the hottest broker's tail: the same rows dealt round-robin over the
    # brokers (every broker within one row of the mean), same bytes
    rows = torch.nonzero(st.replica_valid).flatten()
    even = carry.replica_broker.clone()
    even[rows] = (torch.arange(rows.numel(), device=dev) % B).to(torch.int32)
    g_even = group_placement(even, st.replica_valid, B)
    res_even = {f: torch.empty_like(t) for f, t in res.items()}
    even_t = measure(lambda: refresh_aggregates(st, even, carry.replica_is_leader, carry.replica_disk,
                                                res_even, **dict(kw, group=g_even)))
    leaders = int(carry.replica_is_leader[st.replica_valid].sum())
    valid = int(st.replica_valid.sum())
    M = int(sx.part_replicas.shape[1])
    # what the function needs, each byte once: every row's valid flag; a
    # valid row's broker, partition, topic, leader flag and disk (17 B) and
    # its leader load row (16 B), a follower's also its follower row; a
    # broker's rack and host (8 B) and its outputs (32 B + 4 B a disk); the
    # topic x broker and partition x rack tables written once; a host's
    # load row (16 B); ~12 operations a row
    nb = (R + 33 * valid + 16 * (valid - leaders) + (40 + 4 * D) * B + 4 * T * B
          + 4 * P * s.num_racks + 16 * H)
    b_ms, b_by = bound(nb, 12.0 * valid)
    counts = got.count.float()
    out["refresh_aggregates"] = dict(
        max_abs_err=0.0, **timings(kt, pt), library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bound_bytes=nb, tolerance="bit for bit against the plain version on the CPU, 3 runs", n=valid,
        no_hosts_ms=no_hosts["ms"], hosts_only_ms=hosts_only["ms"], round_robin_ms=even_t["ms"],
        broker_rows_max=int(got.count.max()), broker_rows_mean=float(counts.mean()),
        members_per_partition=M)
    del g_even, res_even, even

    # step_globals
    buf = torch.empty(gk.size(T), device=dev)
    want = gk.globals_plain(sx, carry, torch.empty(gk.size(T), device=dev))
    g = gk.step_globals(sx, carry, buf)
    err, rel = 0.0, 0.0
    for k, v in want.items():
        check(bool(torch.allclose(g[k], v, rtol=1e-6, atol=0.0)), f"step_globals: {k} outside rtol 1e-6")
        err = max(err, float((g[k] - v).abs().max()))
        rel = max(rel, float(((g[k] - v).abs() / v.abs().clamp(min=1e-30)).max()))
    first = buf.clone()
    for _ in range(100):
        buf.fill_(float("nan"))
        gk.step_globals(sx, carry, buf)
        check(torch.equal(buf.view(torch.int32), first.view(torch.int32)), "step_globals differs run to run")
    kt = measure(lambda: gk.step_globals(sx, carry, buf))
    pbuf = torch.empty_like(buf)
    pt = measure(lambda: gk.globals_plain(sx, carry, pbuf), graph=False)
    nb = B * (1 + 16 + 16 + 12 + 5 * D) + 4 * T * B + 16 + 4 * gk.size(T)
    b_ms, b_by = bound(nb, 40.0 * B + T * B)
    out["step_globals"] = dict(max_abs_err=err, max_rel_err=rel, **timings(kt, pt), library_ms=None,
                               bound_ms=b_ms,
                               bound_by=b_by, tolerance="rtol 1e-6, the same bits over 100 calls", n=B)

    # round_schedule: every phase over a table of gate inputs (3 main and 2
    # polish rounds; EXIT after the round fills the rounds after it once
    # the run is over), every third row at a slice end right after its
    # round (a segmented run's launch: CLOSE ends it, EXIT writes nothing
    # unless the run is done), the card's state against the plain version's
    tol = float(np.float32(1e-6))
    dims = sk.ScheduleDims(n_main=3, total=5, tol_on=True, checks=2, verbose=True, tol=tol,
                           scale=float(np.float32(1e-2)))
    rows = 0
    for i, row in enumerate(itertools.product([0, 1, 2, 3, 4], [0, 1], [0, 1, 2],
                                              [0.0, tol, 1e-3, float("inf")],
                                              [0.0, tol, 5e-4, 1e-3], [float("inf"), 1e-3, 5e-4],
                                              [0, 1])):
        states = []
        for d in ("cpu", dev):
            sc = sk.Schedule.create(5, 0.7, d)
            sc.sf[sk.OBJ] = 37.0
            sk.round_schedule(sk.INIT, sc, dims)
            rnd, done, checks, cheap_prev, full_v, prev_v, has_prev = row
            if i % 3 == 0:
                sc.si[sk.SLICE_END] = rnd + 1
            sc.si[sk.RND], sc.si[sk.DONE], sc.si[sk.CHECKS], sc.si[sk.HAS_PREV] = rnd, done, checks, has_prev
            sc.sf[sk.CHEAP_PREV], sc.sf[sk.PREV_V] = cheap_prev, prev_v
            sk.round_schedule(sk.GATE, sc, dims)
            if sc.si[sk.NEED_FULL]:
                sc.sf[sk.FULL_V] = full_v
            sk.round_schedule(sk.DECIDE, sc, dims)
            if sc.si[sk.RUN]:
                sc.acc += 11
                sc.sf[sk.CHEAP] = 2e-3
                sc.sf[sk.OBJ] = 5.0
            sk.round_schedule(sk.CLOSE, sc, dims)
            sk.round_schedule(sk.EXIT, sc, dims)
            states.append([t.cpu() for t in (sc.si, sc.sf, sc.acc, sc.ys, sc.count)])
        for a, b in zip(*states):
            same = torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                         and torch.equal(a.nan_to_num(), b.nan_to_num()))
            check(same, f"round_schedule differs from the plain version on {row}")
        rows += 1
    sc = sk.Schedule.create(5, 0.7, dev)
    sc_cpu = sk.Schedule.create(5, 0.7, "cpu")
    kt = measure(lambda: sk.round_schedule(sk.GATE, sc, dims))
    p_ms = host_time_ms(lambda: sk.round_schedule(sk.GATE, sc_cpu, dims))
    # a phase reads and writes the int and float state once (68 B), the
    # loop's counters (8 B) and one ys row (56 B); a few dozen scalar
    # operations
    b_ms, b_by = bound(132, 60.0)
    out["round_schedule"] = dict(max_abs_err=0.0, **timings(kt, dict(ms=p_ms, call_ms=p_ms, ms_source="host clock, CPU tensors")),
                                 library_ms=None, bound_ms=b_ms, bound_by=b_by,
                                 tolerance=f"exact, every phase over {rows} table rows", n=1)
    return out


def check_apply_collisions(cfg, device) -> str:
    """apply_moves on survivors that meet on shared hosts and on a swap's
    two brokers, with values from 1e-2 to 1e8: the card's floats equal the
    plain version's on the CPU (index order, the reference's) bit for bit,
    on each of three runs."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import apply as apply_k
    from cruise_control_tpu_torch.testing.fixtures import apply_collision_case, collision_cluster

    small = dict(num_candidates=256, leadership_candidates=64, steps_per_round=8, num_rounds=2)
    ref = None
    for dev in ("cpu", device, device, device):
        state = collision_cluster(dev)
        eng = Engine(state, DEFAULT_CHAIN, config=dataclasses.replace(cfg, **small))
        sv_r, payr, sv_l, payl, agg = apply_collision_case(state, 0)
        carry = eng.init_carry(Key.from_seed(0))
        for f, a in agg.items():
            setattr(carry, f, torch.from_numpy(a.copy()).to(dev))

        def t(a, dev=dev):
            return torch.from_numpy(a).to(dev)

        apply_k.apply_moves(eng.statics, carry, t(sv_r), {k: t(v) for k, v in payr.items()},
                            t(sv_l), {k: t(v) for k, v in payl.items()})
        got = {f: getattr(carry, f).cpu() for f in agg}
        if ref is None:
            ref = got
            continue
        for f in agg:
            check(torch.equal(got[f].view(torch.int32), ref[f].view(torch.int32)),
                  f"apply_moves: {f} differs from the plain version on the collision case")
    return "bit for bit on 3 runs"


def check_small_cluster() -> None:
    """Phase 3: the card's run of a small cluster against the CPU's."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster

    spec = RandomClusterSpec(num_brokers=12, num_partitions=200, skew=1.0)
    res = {}
    for dev in ("cpu", "cuda"):
        res[dev] = GoalOptimizer(config=OptimizerConfig(**FAST), device=dev).optimize(
            random_cluster(spec, seed=3, device=dev)
        )
    a, b = res["cpu"], res["cuda"]
    same = bool((a.state_after.replica_broker == b.state_after.replica_broker.cpu()).all())
    log(json.dumps({"phase": "small_cluster", "objective_cpu": a.objective_after,
                    "objective_cuda": b.objective_after, "violated_cpu": a.violated_goals_after(),
                    "violated_cuda": b.violated_goals_after(), "identical_placement": same}))
    # the same input scores the same (f32 sums in another order: rtol 1e-5);
    # the anneals part ways at the first near-zero delta whose sign the
    # card's summation order flips, so their outcomes are held to goal
    # quality: the same violated goals, and both residuals converged
    check(abs(b.objective_before - a.objective_before) <= 1e-5 * abs(a.objective_before),
          "small cluster: the card scores the input differently")
    check(b.violated_goals_after() == a.violated_goals_after(), "small cluster: goal outcome differs")
    for r in (a, b):
        check(r.objective_after <= 1e-6 * r.objective_before, "small cluster did not converge")


def profile_steps(state, cfg) -> dict:
    """Phase 7: where an eager north-star step's time goes (the legacy
    route's step, in the run's buffers, at T=0).  Host clock around 32
    steps (with the launches of each kernel per step), one round prep and
    one full-chain evaluation; then torch.profiler over 16 more steps for
    the device's time, and the order of the step's device operations: one
    select launch and nothing else between candidates and apply_moves.
    The steps are the first 52 of round 0, each at its own select epoch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cruise_control_tpu_torch import kernels as kernels_mod
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.kernels import schedule as sched_k

    eng = Engine(state, DEFAULT_CHAIN, config=dataclasses.replace(cfg, fused_rounds=False))
    ws = eng._workspace()
    eng._init_run(ws, eng._sched_dims(False))
    ws.sched.value(sched_k.T_R).fill_(0.0)
    carry = ws.carry

    done = [0]

    def steps(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            eng._step(ws, done[0])
            done[0] += 1
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / n * 1e3

    steps(4)
    kernels_mod.reset_launches()
    step_ms = steps(32)
    launches_per_step = {k: v / 32 for k, v in kernels_mod.LAUNCHES.items()}
    t0 = time.monotonic()
    cheap = eng.round_prep(ws)
    float(cheap)
    prep_ms = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    float(eng.evaluate(carry)[1].max())
    eval_ms = (time.monotonic() - t0) * 1e3
    n = 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_step_ms = steps(n)
    kernels, order = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = kernels.setdefault(kernel_name(e.name), [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3 / n
            rec[1] += 1
            order.append((e.time_range.start, kernel_name(e.name)))
    # the device operations between each candidates launch and the next
    # apply_moves launch
    between, cur = [], None
    for _, name in sorted(order):
        if name == "candidates_kernel":
            cur = []
        elif name == "apply_moves_kernel" and cur is not None:
            between.append(cur)
            cur = None
        elif cur is not None:
            cur.append(name)
    busy = sum(v[0] for v in kernels.values())
    own = sum(v[0] for k, v in kernels.items() if k in OWN_KERNELS)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    out = dict(
        phase="profile", step_ms=step_ms, round_prep_ms=prep_ms, evaluate_ms=eval_ms,
        profiled_step_ms=profiled_step_ms,
        device_busy_ms_per_step=busy if kernels else "not measured",
        device_busy_share=busy / step_ms if kernels else "not measured",
        own_kernels_ms_per_step=own if kernels else "not measured",
        device_busy_share_profiled=busy / profiled_step_ms if kernels else "not measured",
        device_ops_per_step=sum(v[1] for v in kernels.values()) / n,
        launches_per_step=launches_per_step, between_candidates_and_apply=between[:1],
        top_kernels=[[k[:80], round(v[0], 5), v[1] // n] for k, v in top],
    )
    log(json.dumps(out))
    check(launches_per_step["candidates"] == 1 and launches_per_step["step_globals"] == 1
          and launches_per_step["select_survivors"] == 1 and launches_per_step["apply_moves"] == 1
          and launches_per_step["threefry_uniform"] == 0 and launches_per_step["move_delta"] == 0,
          f"a step's launches are not the fused path's: {launches_per_step}")
    if kernels:
        # the profiler may drop a few of the steps' events; most steps show
        check(len(between) >= n // 2 and all(b == ["select_survivors_kernel"] for b in between),
              f"device operations between candidates and apply_moves: {between[:2]}")
    eng.release()
    del eng, ws, carry
    return out


def run_proposal(opt, state, label, initial_placement=None, prior=None):
    import numpy as np
    import torch

    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer.goals import HARD_GOAL_NAMES
    from cruise_control_tpu_torch.models import validate
    from cruise_control_tpu_torch.models.state import member_width

    # the caller's stream, not the device: phase 20 runs this while the
    # warm pool captures on another thread, and a device-wide sync during
    # a capture is refused ("operation not permitted when stream is
    # capturing")
    torch.cuda.current_stream().synchronize()
    kernels.reset_launches()
    t0 = time.monotonic()
    res = opt.optimize(state, initial_placement=initial_placement, prior=prior)
    torch.cuda.current_stream().synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    check(validate(res.state_after, strict=False) == [], "optimized state fails validate")
    check(res.objective_after < res.objective_before, "objective did not improve")
    hard = [n for n, v in zip(res.goal_names, res.violations_after) if n in HARD_GOAL_NAMES and v > 1e-6]
    check(not hard, f"hard goals violated after the proposal: {hard}")
    check(len(res.proposals) > 0, "no proposals")
    check(np.isfinite(res.violations_after).all(), "non-finite goal violations")
    rounds = [h for h in res.history if "round" in h]
    timing = next(h for h in res.history if h.get("timing"))
    check(timing.get("fused") is True and timing["blocking_syncs"] == 1,
          f"the {label} did not run the fused route with one blocking sync: {timing}")
    check(timing["graph_launches"] == 1 and timing["masked_rounds"] == 0,
          f"the {label} did not run as one loop-graph launch without masked rounds: {timing}")
    engine = opt._engines[(state.shape, member_width(state), opt.config)]
    # round_schedule: INIT in the init graph, three a loop iteration and
    # EXIT (a capture's warm-up counts into its own record)
    want = 3 * timing["loop_iterations"] + 2
    check(launches["round_schedule"] == want,
          f"the {label} launched round_schedule {launches['round_schedule']} times, expected {want}")
    log(json.dumps({
        "phase": label, "wall_s": wall, "rounds": len(rounds),
        "host_dispatch_s": timing["host_dispatch_s"], "device_s": timing["device_s"],
        "graph_launches": timing["graph_launches"], "loop_iterations": timing["loop_iterations"],
        "masked_rounds": timing["masked_rounds"],
        "host_extract_s": timing["host_extract_s"],
        "graph_captures": engine.graph_stats.get("captures", []),
        "accepted": [h["accepted"] for h in rounds], "objective_before": res.objective_before,
        "objective_after": res.objective_after, "balancedness_before": res.balancedness_before,
        "balancedness_after": res.balancedness_after, "proposals": len(res.proposals),
        "replica_moves": res.num_inter_broker_moves, "leader_moves": res.num_leadership_moves,
        "violated_after": res.violated_goals_after(), "engine_cache_hit": timing["engine_cache_hit"],
        "blocking_syncs": timing["blocking_syncs"], "launches": launches,
    }))
    missing = [k for k in PATH_KERNELS if launches[k] == 0]
    check(not missing, f"kernels never launched on the {label} path: {missing}")
    fused = {k: v for k, v in launches.items() if k not in PATH_KERNELS and v}
    check(not fused, f"standalone kernels launched on the {label} path: {fused}")
    return res, launches


def check_generation(res, state, cfg, label: str, walls: dict, prior=None) -> None:
    """A request on a cached engine's new model generation (`res`, of
    `state`): it captured nothing, and its placements are byte for byte a
    fresh optimizer's run on the same state.  Its wall is printed beside
    the fresh run's and `walls`."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    timing = next(h for h in res.history if h.get("timing"))
    opt = GoalOptimizer(config=cfg, device="cuda")
    fresh = opt.optimize(state, prior=prior)
    same = {f: bool(torch.equal(getattr(res.state_after, f), getattr(fresh.state_after, f)))
            for f in PLACEMENT}
    log(json.dumps({"phase": f"{label}_generation", "captured": timing["captured"],
                    "engine_cache_hit": timing["engine_cache_hit"], "bucket": timing["bucket"],
                    "wall_s": dict(walls, **{label: res.wall_seconds,
                                             f"{label}_fresh_engine": fresh.wall_seconds}),
                    "identical_to_fresh_engine": same,
                    "objective_after": [res.objective_after, fresh.objective_after]}))
    check(timing["engine_cache_hit"] and timing["captured"] == [],
          f"the {label} captured on its path: {timing['captured']}")
    check(all(same.values()), f"the {label} is not a fresh engine's run: {same}")
    for engine in opt._engines.values():
        engine.release()


def captures_per_key(label: str, records: list) -> dict:
    """Phases 15 and 17: each anneal's or reflatten's captures (1 where its
    run captured) summed per (bucket, max_rf) key, printed; at most one a
    key."""
    per: dict = {}
    for r in records:
        key = json.dumps(r["bucket"], sort_keys=True)
        per[key] = per.get(key, 0) + r["captures"]
    log(json.dumps({"phase": f"{label}_captures", "per_bucket": per,
                    "runs": [r["captures"] for r in records]}))
    check(all(n <= 1 for n in per.values()), f"{label}: a bucket captured more than once: {per}")
    return per


def compare_routes(state, cfg, label, chain=None) -> dict:
    """Phase 6: the graph route and the legacy host loop, which share every
    kernel, on one cluster at T=0: identical placements, rounds and
    accepted counts."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine

    base = dataclasses.replace(cfg, init_temperature_scale=0.0)
    res = {}
    for fused in (True, False):
        eng = Engine(state, chain or DEFAULT_CHAIN, config=dataclasses.replace(base, fused_rounds=fused))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        final, hist = eng.run()
        torch.cuda.synchronize()
        res[fused] = (final, hist, time.monotonic() - t0)
        eng.release()
    (ff, hf, wf), (fl, hl, wl) = res[True], res[False]

    def rounds(h):
        return [(r["round"], r["accepted"], r.get("early_stop"), r.get("extra")) for r in h if "round" in r]

    same = {f: bool(torch.equal(getattr(ff, f), getattr(fl, f)))
            for f in ("replica_broker", "replica_is_leader", "replica_disk")}
    tf_, tl = hf[-1], hl[-1]
    rec = dict(phase="routes_t0", cluster=label, identical=same, rounds_fused=rounds(hf),
               rounds_legacy=rounds(hl), syncs_fused=tf_["blocking_syncs"], syncs_legacy=tl["blocking_syncs"],
               wall_fused_s=wf, wall_legacy_s=wl)
    log(json.dumps(rec))
    check(all(same.values()), f"{label}: the graph and legacy routes' placements differ at T=0: {same}")
    check(rounds(hf) == rounds(hl), f"{label}: the graph and legacy routes' rounds differ at T=0")
    check(tf_["fused"] is True and tf_["blocking_syncs"] == 1, f"{label}: the graph route synced {tf_}")
    return rec


def profile_fused(state, cfg) -> dict:
    """Phase 7: a whole fused north-star run (graphs captured by a first
    run) under torch.profiler: device busy and idle share, each of the
    package's kernels' device time, one loop-graph launch and no masked
    round; then, alone and timed with CUDA events, one loop iteration on
    the finished run (the loop graph without its init: one masked round and
    EXIT), a full-chain check, the init graph and a round body replayed
    from their captured graphs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from cruise_control_tpu_torch import kernels as kernels_mod
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.kernels import schedule as sched_k

    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    eng.run()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, hist = eng.run()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    kernels_mod.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("fused_run"):
            t0 = time.monotonic()
            _, hist_p = eng.run()
            torch.cuda.synchronize()
            prof_wall_ms = (time.monotonic() - t0) * 1e3
    launches = {k: v for k, v in kernels_mod.LAUNCHES.items() if v}
    # the run's window on the profiler's clock: a device event outside it
    # (a stale record from an earlier session) is counted apart
    window = [e.time_range for e in prof.events()
              if e.name == "fused_run" and e.device_type == DeviceType.CPU]
    kernels, ops, in_window, outside = {}, 0, {}, {}
    for e in prof.events():
        # (the window's own range is mirrored on the device's timeline)
        if e.device_type == DeviceType.CUDA and e.name != "fused_run":
            name = kernel_name(e.name)
            rec = kernels.setdefault(name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
            ops += 1
            if name in OWN_KERNELS:
                inside = any(w.start <= e.time_range.start and e.time_range.end <= w.end for w in window)
                tally = in_window if inside else outside
                tally[name] = tally.get(name, 0) + 1
    busy = sum(v[0] for v in kernels.values())
    timing = hist_p[-1]
    check(timing["graph_launches"] == 1 and timing["masked_rounds"] == 0,
          f"the profiled fused run was not one loop-graph launch without masked rounds: {timing}")
    ws = eng._ws
    stream = torch.cuda.current_stream()
    # the run is done, so each launch of the loop alone runs one masked
    # iteration (its handle starts at 1; CLOSE ends it) and EXIT
    dims = eng._sched_dims(False)
    loop_only = sched_k.LoopGraph(ws.sched, dims, None, ws.graphs["eval"], ws.graphs["body"])
    iteration = time_ms(lambda: loop_only.launch(stream.cuda_stream), reps=100)
    loop_only.close()
    full = time_ms(lambda: ws.graphs["eval"].replay(), reps=10)
    init = time_ms(lambda: ws.graphs["init"].replay(), reps=5)
    # a round body alone, at T=0 (the init replay above set the carry and
    # the plan, and cleared the select minima): rounds 0, 1, ... in turn,
    # each with its own keys and select epochs
    ws.sched.sf[sched_k.T_R] = 0.0
    rnd = [0]

    def body():
        ws.sched.si[sched_k.RND] = rnd[0]
        rnd[0] += 1
        ws.graphs["body"].replay()

    body_ms = time_ms(body, reps=5)
    rounds = [h for h in hist_p if "round" in h]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]
    out = dict(
        phase="profile_fused", run_wall_ms=wall_ms, profiled_run_wall_ms=prof_wall_ms,
        rounds=len(rounds), timing=timing,
        device_busy_ms=busy if kernels else "not measured",
        device_idle_share=1.0 - busy / prof_wall_ms if kernels else "not measured",
        device_ops=ops, own_events_in_window=in_window, own_events_outside_window=outside,
        launches=launches, window_found=len(window) == 1,
        graph_captures=eng.graph_stats.get("captures", []),
        loop_iteration_ms=iteration, full_check_ms=full, round_body_ms=body_ms, init_ms=init,
        own_kernel_ms={k: round(v[0], 6) for k, v in kernels.items() if k in OWN_KERNELS},
        own_kernel_events={k: v[1] for k, v in kernels.items() if k in OWN_KERNELS},
        top_kernels=[[k, round(v[0], 5), v[1]] for k, v in top],
    )
    log(json.dumps(out))
    check(hist_p[-1]["blocking_syncs"] == 1, "the profiled fused run synced more than once")
    eng.release()
    return out


def carry_on(carry, dev):
    """A copy of an engine carry with its tensors on `dev`."""
    import torch

    return dataclasses.replace(carry, **{
        f.name: getattr(carry, f.name).to(dev, copy=True) for f in dataclasses.fields(carry)
        if isinstance(getattr(carry, f.name), torch.Tensor)
    })


def check_jbod_step(state, chain, cfg, label: str) -> dict:
    """Phases 8-9: the candidates kernel against its plain version on one
    real step of a JBOD cluster (ids, masks and payload rows exact, deltas
    within the delta bar, acceptance identical on every candidate), and
    apply_moves on the step's survivors bit for bit against the plain
    version on the CPU (the reference's order), three times, every slot
    back at -1."""
    import types

    import torch

    from cruise_control_tpu_torch.analyzer import Engine
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import apply as apply_k
    from cruise_control_tpu_torch.kernels import candidates as cand_k

    eng = Engine(state, chain, config=cfg)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    with Capture([(cand_k, "candidates"), (apply_k, "apply_moves")]) as cap:
        eng.step(carry, 0.0, plan)
    torch.cuda.synchronize()
    (c_args, c_kw), = cap.calls["candidates"]
    ck = cand_k.candidates(*c_args, **c_kw)
    cpl = cand_k.candidates_plain(*c_args, **c_kw)
    K = int(cpl["delta"].shape[0])
    for f in ("feas", "src", "dst", "part1", "part2", "accept"):
        check(torch.equal(ck[f], cpl[f]), f"{label}: candidates {f} differs from the plain version")
    for name in ("payr", "payl"):
        for f, want in cpl[name].items():
            check(torch.equal(ck[name][f], want), f"{label}: candidates payload {name}.{f} differs")
    err = float((ck["delta"] - cpl["delta"]).abs().max())
    bad = int(((ck["delta"] - cpl["delta"]).abs() > delta_bar(cpl["delta"])).sum())
    check(bool(torch.isfinite(ck["delta"]).all()) and bad == 0,
          f"{label}: {bad} candidate deltas outside tolerance (max err {err})")
    kt = measure(lambda: cand_k.candidates(*c_args, **c_kw))
    pt = measure(lambda: cand_k.candidates_plain(*c_args, **c_kw), graph=False)
    if eng.config.intra_broker:
        nb = candidates_intra_bound_bytes(eng, c_args[0], c_args[5], ck)
    else:
        nb = candidates_bound_bytes(eng, c_args[2], ck)
    s = state.shape
    D = s.max_disks_per_broker
    # an intra lane: 2-4 threefry hashes (~80 operations each) and two
    # evaluations of a broker's disk terms (~14 a logdir); an inter-broker
    # lane: ~600 (phase 2) and four evaluations of the disk terms
    per = (320.0 + 28.0 * D) if eng.config.intra_broker else (600.0 + 56.0 * D)
    b_ms, b_by = bound(nb, per * K + 90.0 * (s.B + s.num_hosts))
    rec = dict(
        max_abs_err=err, **timings(kt, pt), library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bound_bytes=nb, tolerance="ids, masks, payload and acceptance exact; |d| <= 1e-4 (|plain| + "
                                  "1e-2 max|plain|)",
        accepted=int(ck["accept"].sum()), feasible=int(ck["feas"].sum()), n=K,
        kinds=dict(K_r=eng.K_r, K_s=eng.K_s, K_l=eng.K_l),
    )

    # apply_moves on the step's survivors against the plain version on the
    # CPU, three times
    ((sx_a, c0, sv_r, payr, sv_l, payl), _), = cap.calls["apply_moves"]
    sx_cpu = types.SimpleNamespace(state=cpu_copy(sx_a.state))
    want = carry_on(c0, "cpu")
    apply_k.apply_plain(sx_cpu, want, sv_r.cpu(), {k: v.cpu() for k, v in payr.items()},
                        sv_l.cpu(), {k: v.cpu() for k, v in payl.items()})
    for _ in range(3):
        got = c0.clone()
        apply_k.apply_moves(sx_a, got, sv_r, payr, sv_l, payl)
        torch.cuda.synchronize()
        for f in ("replica_broker", "replica_disk", "replica_is_leader", "broker_replica_count",
                  "broker_leader_count", "broker_topic_count", "part_rack_count", "broker_load",
                  "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load", "host_load"):
            a, b = getattr(got, f).cpu(), getattr(want, f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b), f"{label}: apply_moves {f} differs from the plain version on the CPU")
        check(bool((sx_a.apply_slots == -1).all()), f"{label}: apply_moves left a slot set")
    same_broker = int((payr["src"][sv_r] == payr["dst"][sv_r]).sum())
    rec.update(apply_survivors=int(sv_r.sum()) + int(sv_l.sum()), apply_src_is_dst=same_broker,
               apply="bit for bit against the plain version on the CPU, 3 runs")
    if eng.config.intra_broker:
        check(same_broker == int(sv_r.sum()) > 0 and sv_l.numel() == 0,
              f"{label}: the intra step's survivors are not all src == dst rows")
    log(json.dumps({"phase": "kernel", "name": label, **rec}))
    eng.release()
    return rec


def check_jbod(cfg) -> dict:
    """Phases 8-9: BASELINE configuration 3 and rebalance_disk on its
    cluster.  Returns the two candidates cases' records, with the
    launches of their proposal runs."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
    from cruise_control_tpu_torch.analyzer.objective import GoalChain
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    t0 = time.monotonic()
    state = random_cluster_fast(RandomClusterSpec(**{**MID_SPEC, "disks_per_broker": 4}), seed=42,
                                device="cuda")
    torch.cuda.synchronize()
    s = state.shape
    log(json.dumps({"phase": "jbod_fixture", "seconds": time.monotonic() - t0, "brokers": s.B,
                    "partitions": s.P, "replicas": s.R, "disks_per_broker": s.max_disks_per_broker}))
    check((s.B, s.P, s.max_disks_per_broker) == (500, 50_000, 4), f"configuration 3's shape: {s}")
    out = {}

    # phase 8: configuration 3, inter-broker moves with the disk terms
    chain3 = GoalChain.from_names(list(CONFIG3_CHAIN))
    out["candidates_disk_terms"] = check_jbod_step(state, chain3, cfg, "candidates_disk_terms")
    opt = GoalOptimizer(chain=chain3, config=cfg, device="cuda")
    res, launches = run_proposal(opt, state, "config3_proposal")
    again, _ = run_proposal(opt, state, "config3_proposal_repeat")
    same = {f: bool(torch.equal(getattr(res.state_after, f), getattr(again.state_after, f)))
            for f in PLACEMENT}
    rounds = [len([h for h in r.history if "round" in h]) for r in (res, again)]
    log(json.dumps({"phase": "config3_determinism", "identical": same, "rounds": rounds,
                    "proposals": [len(res.proposals), len(again.proposals)]}))
    check(all(same.values()) and rounds[0] == rounds[1] and len(res.proposals) == len(again.proposals),
          f"configuration 3: two proposals with the same seed differ: {same}, {rounds}")
    out["candidates_disk_terms"]["launches"] = launches["candidates"]
    for engine in opt._engines.values():
        engine.release()
    del res, again, opt
    compare_routes(state, cfg, "config3", chain=chain3)

    # phase 9: rebalance_disk
    chain_d = GoalChain.from_names(list(DEFAULT_INTRA_BROKER_GOAL_ORDER))
    cfg_d = dataclasses.replace(cfg, intra_broker=True)
    out["candidates_intra"] = check_jbod_step(state, chain_d, cfg_d, "candidates_intra")
    opt = GoalOptimizer(chain=chain_d, config=cfg_d, device="cuda")
    res, launches = run_proposal(opt, state, "rebalance_disk_proposal")
    after = res.state_after
    disk_moves = sum(bool(p.disk_moves) for p in res.proposals)
    unchanged = {f: bool(torch.equal(getattr(after, f), getattr(state, f)))
                 for f in ("replica_broker", "replica_is_leader")}
    moved_disks = int((after.replica_disk != state.replica_disk)[state.replica_valid].sum())
    log(json.dumps({"phase": "rebalance_disk_check", "unchanged": unchanged, "disk_moves": disk_moves,
                    "replicas_on_other_logdirs": moved_disks,
                    "objective": [res.objective_before, res.objective_after]}))
    check(all(unchanged.values()), f"rebalance_disk moved replicas between brokers or leaders: {unchanged}")
    check(disk_moves > 0 and moved_disks > 0, "rebalance_disk proposed no disk move")
    check(all(sorted(p.old_replicas) == sorted(p.new_replicas) for p in res.proposals),
          "rebalance_disk proposed an inter-broker move")
    out["candidates_intra"]["launches"] = launches["candidates"]
    for engine in opt._engines.values():
        engine.release()
    del res, opt, state
    return out


def check_bucketed(state, cfg, exact: dict) -> dict:
    """Phase 10: the north star padded by DEFAULT_BUCKET_POLICY through
    optimize, against phase 4's exact run: the same violated goals, every
    hard goal satisfied (run_proposal), the padding rows untouched, and
    the exact run's placements bit for bit.  Should the placements differ
    (a sum over the padded broker axis rounding otherwise on some card),
    the record says so and the padded run must instead end within 10% of
    the exact run's final objective or below it: on an H100, two
    north-star runs that reach the floor from different starts (phases 4
    and 11) ended 1% apart (4.855e-9 and 4.805e-9)."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.kernels.candidates import CDF_SMEM_MAX
    from cruise_control_tpu_torch.models import DEFAULT_BUCKET_POLICY, pad_state

    padded = pad_state(state, DEFAULT_BUCKET_POLICY.bucket_shape(state.shape))
    s, n = padded.shape, state.shape.R
    opt = GoalOptimizer(config=cfg, device="cuda")
    res, launches = run_proposal(opt, padded, "bucketed_north_star")
    after = res.state_after
    identical = all(bool(torch.equal(getattr(after, f)[:n], exact[f])) for f in PLACEMENT)
    rounds = len([h for h in res.history if "round" in h])
    padding_kept = all(bool(torch.equal(getattr(after, f)[n:], getattr(padded, f)[n:])) for f in PLACEMENT)
    if identical:
        bar = "bit-identical placements"
    else:
        bar = "placements differ from the exact run's: objective <= 1.1 x the exact run's"
    rec = dict(phase="bucketed_check", shape=dict(R=s.R, B=s.B, P=s.P, T=s.num_topics,
                                                   racks=s.num_racks, hosts=s.num_hosts),
               cdf_in_shared_memory=4 * s.B <= CDF_SMEM_MAX, bit_identical=identical,
               rounds=[rounds, exact["rounds"]], proposals=[len(res.proposals), exact["proposals"]],
               objective_after=[res.objective_after, exact["objective_after"]],
               violated_after=[res.violated_goals_after(), exact["violated_after"]],
               padding_rows_untouched=padding_kept, launches=launches, bar=bar,
               tolerance="same violated goals, hard goals <= 1e-6; the exact run's placements bit "
                         "for bit, else an objective <= 1.1 x the exact run's")
    log(json.dumps(rec))
    check(res.violated_goals_after() == exact["violated_after"], "bucketed: the violated goals differ")
    check(identical or res.objective_after <= 1.1 * exact["objective_after"],
          f"bucketed: placements differ and objective {res.objective_after} vs the exact run's "
          f"{exact['objective_after']}")
    check(padding_kept, "bucketed: a padding replica row changed")
    timing = next(h for h in res.history if h.get("timing"))
    (cap,) = next(iter(opt._engines.values())).graph_stats["captures"]
    PADDED_RUN.update(wall_s=res.wall_seconds, engine_build_s=timing["engine_build_s"],
                      capture_s=cap["warmup_s"] + cap["capture_s"] + cap["instantiate_s"],
                      **{f: getattr(after, f).clone() for f in PLACEMENT})
    for engine in opt._engines.values():
        engine.release()
    return rec


def check_warm_start(state, cfg, exact: dict) -> dict:
    """Phase 11: a warm start from the statics' own placement is the cold
    run (phase 4's) exactly; a warm start from phase 4's result runs as
    one graph launch with one sync and leaves the caller's tensors as
    they were."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    opt = GoalOptimizer(config=cfg, device="cuda")
    own = tuple(getattr(state, f).clone() for f in PLACEMENT)
    res, _ = run_proposal(opt, state, "warm_start_own_placement", initial_placement=own)
    rounds = [h["accepted"] for h in res.history if "round" in h]
    same = {f: bool(torch.equal(getattr(res.state_after, f), exact[f])) for f in PLACEMENT}
    check(all(same.values()) and rounds == exact["accepted"] and len(res.proposals) == exact["proposals"],
          f"a warm start from the cluster's own placement is not the cold run: {same}")
    start = tuple(exact[f] for f in PLACEMENT)
    kept = tuple(t.clone() for t in start)
    res2, _ = run_proposal(opt, state, "warm_start_from_result", initial_placement=start)
    untouched = all(bool(torch.equal(a, b)) for a, b in zip(start, kept))
    timing = next(h for h in res2.history if h.get("timing"))
    rec = dict(phase="warm_start_check", own_placement_identical=same,
               rounds_from_result=len([h for h in res2.history if "round" in h]),
               objective_from_result=[res2.objective_before, res2.objective_after],
               graph_launches=timing["graph_launches"], blocking_syncs=timing["blocking_syncs"],
               caller_tensors_unchanged=untouched)
    log(json.dumps(rec))
    check(untouched, "a warm start wrote into the caller's placement")
    for engine in opt._engines.values():
        engine.release()
    return rec


def on_cpu(x):
    """A copy of x on the CPU: a tensor, or a dict or dataclass of them
    (recursively)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: on_cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(on_cpu(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: on_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


def capture_step(state, cfg, prior=None):
    """An engine of `cfg` (and `prior`) and the recorded wrapper calls of
    its first step at T=0 (the legacy route's eager step)."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import candidates as cand_k
    from cruise_control_tpu_torch.kernels import select as select_k

    eng = Engine(state, DEFAULT_CHAIN, config=cfg, prior=prior)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    with Capture([(cand_k, "candidates"), (select_k, "select_survivors")]) as cap:
        eng.step(carry, 0.0, plan)
    torch.cuda.synchronize()
    return eng, cap


def prior_probe_bytes(eng, ck, keys) -> int:
    """Bytes of the prior table the prior-drawn lanes of one step read,
    each once: the CDF entries their binary searches probe (replayed here
    on the step's draws), 4 B each."""
    import torch

    from cruise_control_tpu_torch.kernels import candidates as cand_k

    sx = eng.statics
    fp = ck["from_prior"]
    t = sx.state.replica_topic[ck["payr"]["r"][:eng.K_r][fp].long()].long()
    if isinstance(keys, cand_k.KeyCursor):
        keys = keys.step_keys()
    u = cand_k._uniform(keys.prior_p, eng.K_r, t.device)[fp]
    B = sx.prior_cdf.shape[1]
    cdf = sx.prior_cdf.flatten()
    lo, hi = torch.zeros_like(t), torch.full_like(t, sx.gen.values()["n_dest"])
    probed = []
    while bool((lo < hi).any()):
        act = lo < hi
        mid = lo + (hi - lo) // 2
        probed.append((t * B + mid)[act])
        go = cdf[t * B + mid.clamp(max=B - 1)] <= u
        lo = torch.where(act & go, mid + 1, lo)
        hi = torch.where(act & ~go, mid, hi)
    return 4 * (int(torch.unique(torch.cat(probed)).numel()) if probed else 0)


def check_candidates_variant(eng, cap, label: str, extra_ops: float, extra_bytes,
                             bitwise: bool = False) -> tuple[dict, dict]:
    """Phases 13-14: a candidates variant against its plain version on the
    card on one real north-star step: ids, masks, the took-the-prior mask
    and payload rows exact, acceptance identical on every candidate,
    deltas within the delta bar (bit-identical ones counted, and against
    the plain version on the CPU too; with `bitwise`, every delta bit for
    bit against both); the kernel's and the plain version's times and the
    bound."""
    import torch

    from cruise_control_tpu_torch.kernels import candidates as cand_k

    (c_args, c_kw), = cap.calls["candidates"]
    ck = cand_k.candidates(*c_args, **c_kw)
    cpl = cand_k.candidates_plain(*c_args, **c_kw)
    K = int(cpl["delta"].shape[0])
    for f in ("feas", "src", "dst", "part1", "part2", "accept"):
        check(torch.equal(ck[f], cpl[f]), f"{label}: candidates {f} differs from the plain version")
    check((ck["from_prior"] is None) == (cpl["from_prior"] is None)
          and (cpl["from_prior"] is None or torch.equal(ck["from_prior"], cpl["from_prior"])),
          f"{label}: the took-the-prior mask differs from the plain version")
    for name in ("payr", "payl"):
        for f, want in cpl[name].items():
            check(torch.equal(ck[name][f], want), f"{label}: candidates payload {name}.{f} differs")
    err = float((ck["delta"] - cpl["delta"]).abs().max())
    bad = int(((ck["delta"] - cpl["delta"]).abs() > delta_bar(cpl["delta"])).sum())
    check(bool(torch.isfinite(ck["delta"]).all()) and bad == 0,
          f"{label}: {bad} candidate deltas outside tolerance (max err {err})")
    same_bits = int((ck["delta"].view(torch.int32) == cpl["delta"].view(torch.int32)).sum())
    cpu = cand_k.candidates_plain(*on_cpu(c_args), **on_cpu(c_kw))
    same_bits_cpu = int((ck["delta"].cpu().view(torch.int32) == cpu["delta"].view(torch.int32)).sum())
    accept_cpu = bool(torch.equal(ck["accept"].cpu(), cpu["accept"]))
    check(not bitwise or (same_bits == same_bits_cpu == K and accept_cpu),
          f"{label}: deltas not bit for bit: {same_bits} / {same_bits_cpu} of {K} (card / CPU plain)")
    kt = measure(lambda: cand_k.candidates(*c_args, **c_kw))
    pt = measure(lambda: cand_k.candidates_plain(*c_args, **c_kw), graph=False)
    nb = candidates_bound_bytes(eng, c_args[2], ck) + extra_bytes(ck, c_args[3])
    s = eng.shape
    b_ms, b_by = bound(nb, (600.0 + extra_ops) * K + 90.0 * (s.B + s.num_hosts))
    rec = dict(
        max_abs_err=err, **timings(kt, pt), library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bound_bytes=nb, tolerance="ids, masks, payload and acceptance exact; " + (
            "deltas bit for bit (the plain version on the card and on the CPU)" if bitwise else
            "|d| <= 1e-4 (|plain| + 1e-2 max|plain|)"),
        deltas_bit_identical=same_bits, deltas_bit_identical_cpu=same_bits_cpu,
        accept_identical_cpu=accept_cpu, accepted=int(ck["accept"].sum()),
        from_prior=None if ck["from_prior"] is None else int(ck["from_prior"].sum()), n=K,
    )
    log(json.dumps({"phase": "kernel", "name": label, **rec}))
    return rec, dict(args=c_args, kw=c_kw)


def engine_runs(state, cfgs: dict, order) -> dict:
    """Warmed fused runs of one engine per config (each captured by a
    first run), in `order`: host wall to the sync and `device_s` of each."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine

    engs = {k: Engine(state, DEFAULT_CHAIN, config=c) for k, c in cfgs.items()}
    for e in engs.values():
        e.run()
    out = {k: dict(wall_ms=[], device_s=[]) for k in engs}
    for k in order:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, hist = engs[k].run()
        torch.cuda.synchronize()
        out[k]["wall_ms"].append((time.monotonic() - t0) * 1e3)
        out[k]["device_s"].append(hist[-1]["device_s"])
    for e in engs.values():
        e.release()
    return out


def check_diagnostics(state, cfg, exact: dict) -> dict:
    """Phase 12: convergence diagnostics on the north star through
    optimize: the placements, rounds and proposals of phase 4's run; one
    graph launch and one sync; every round record carries the diagnostics
    with accepted == sum(accepted_by_kind); the convergence summary's last
    objective is the after-report's (rtol 1e-5, after the summary's
    rounding to 8 decimals); warmed runs with and without diagnostics
    timed in turns; and select_survivors' diagnostics instantiation
    against its plain version on the step's inputs."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.kernels import select as select_k

    cfg_d = dataclasses.replace(cfg, diagnostics=True)
    dev = state.device
    opt = GoalOptimizer(config=cfg_d, device=dev)
    res, launches = run_proposal(opt, state, "diagnostics_north_star")
    rounds = [h for h in res.history if "round" in h]
    timing = next(h for h in res.history if h.get("timing"))
    conv = timing["convergence"]
    same = all(bool(torch.equal(getattr(res.state_after, f), exact[f])) for f in PLACEMENT)
    kinds_ok = all(r["accepted"] == sum(r["accepted_by_kind"].values())
                   and len(r["goal_violations"]) == len(res.goal_names) for r in rounds)
    last = conv["objective_trajectory"][-1]
    obj_gap = abs(last - res.objective_after)
    rec = dict(phase="diagnostics_check", identical_to_phase4=same, rounds=len(rounds),
               proposals=len(res.proposals), accepted=[r["accepted"] for r in rounds],
               accepted_by_kind=conv["accepted_by_kind"], prior=conv["prior"],
               objective_trajectory=conv["objective_trajectory"],
               last_round_objective=rounds[-1]["objective"], objective_after=res.objective_after,
               final_goal_violations=conv["final_goal_violations"], graph_launches=timing["graph_launches"],
               blocking_syncs=timing["blocking_syncs"], wall_s=res.wall_seconds,
               device_s=timing["device_s"], launches=launches)
    check(same and len(rounds) == exact["rounds"] and len(res.proposals) == exact["proposals"],
          f"diagnostics changed the north star's run: {rec}")
    check(kinds_ok, "diagnostics: a round record's counts do not add up")
    check(obj_gap <= 5e-9 + 1e-5 * abs(res.objective_after)
          and abs(rounds[-1]["objective"] - res.objective_after) <= 1e-5 * abs(res.objective_after),
          f"diagnostics: last objective {last} / {rounds[-1]['objective']} vs {res.objective_after}")
    for engine in opt._engines.values():
        engine.release()
    del opt, res
    runs = engine_runs(state, {"off": cfg, "on": cfg_d}, ("off", "on", "on", "off", "off", "on"))
    rec["warm_runs"] = runs
    log(json.dumps(rec))

    # select_survivors<true> on the step's inputs, with a took-the-prior
    # mask over 40% of the relocations (seeded) so that every count moves
    eng, cap = capture_step(state, cfg)
    (args, kw), = cap.calls["select_survivors"]
    sizes = dict(B=kw["num_brokers"], P=kw["num_parts"], n_r=kw["n_r"], n_s=kw["n_s"])
    g = torch.Generator(device=dev).manual_seed(12)
    fp = torch.rand(sizes["n_r"], generator=g, device=dev) < 0.4
    K = int(args[0].shape[0])
    bufs = select_k.select_buffers(K, sizes["n_r"], sizes["n_s"], sizes["B"], sizes["P"], dev,
                                   n_epochs=3)
    n_acc = len(select_k.DIAG_FIELDS)
    acc = torch.zeros(n_acc, dtype=torch.int64, device=dev)
    for epoch, mask in ((1, fp), (2, None), (3, fp)):
        before = acc.clone()
        got = select_k.select_survivors(*args, num_brokers=sizes["B"], num_parts=sizes["P"],
                                        n_r=sizes["n_r"], n_s=sizes["n_s"], acc=acc, bufs=bufs,
                                        epoch=select_k.Epoch(epoch - 1), from_prior=mask, diag=True)
        want = select_k.select_plain(*args, *sizes.values(), from_prior=mask, diag=True)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and (acc - before).tolist() == want[2].tolist(),
              f"select_survivors_diag differs from the plain version at epoch {epoch}")
    counts = dict(zip(select_k.DIAG_FIELDS, want[2].tolist()))
    check(counts["accepted"] == counts["acc_replica"] + counts["acc_swap"] + counts["acc_lead"] > 0,
          f"select_survivors_diag: counts do not add up: {counts}")
    acc_t = torch.zeros(n_acc, dtype=torch.int64, device=dev)
    kt = measure(lambda: select_k.select_survivors(*args, **{**kw, "acc": acc_t, "bufs": bufs,
                                                             "from_prior": fp, "diag": True}))
    one_launch(kt, "select_survivors_kernel")
    pt = measure(lambda: select_k.select_plain(*args, *sizes.values(), from_prior=fp, diag=True), graph=False)
    acc1 = torch.zeros(1, dtype=torch.int64, device=dev)
    default = measure(lambda: select_k.select_survivors(*args, **{**kw, "acc": acc1, "bufs": bufs}))
    # the default kernel's bytes, the mask (1 B a relocation) and five more
    # 8-byte counts; ~12 operations a candidate and ~6 for the tally
    nb = nbytes(*args, got[0], got[1], acc1) + nbytes(fp) + 8 * (n_acc - 1)
    b_ms, b_by = bound(nb, 18.0 * K)
    out = dict(max_abs_err=0.0, **timings(kt, pt), library_ms=None, bound_ms=b_ms, bound_by=b_by,
               bound_bytes=nb, default_kernel_ms=default["ms"], default_kernel_call_ms=default["call_ms"],
               tolerance="exact survivors, relocation mask and the six counts, fresh and over 3 "
                         "epochs of one buffer, with and without a prior mask",
               counts=counts, n=K, launches=launches["select_survivors"])
    log(json.dumps({"phase": "kernel", "name": "select_survivors_diag", **out}))
    eng.release()
    return out


def fit_prior(res, state, mix: float):
    """Phase 13's warm prior: MoveAcceptancePrior(mix, min_observations=0)
    fitted on a proposal's moves, materialised on the cluster's (T, B).  The
    north-star fixture has no ClusterCatalog, so the catalog names topic t
    "t<t>": the table is the one ProposalSet.destination_pairs gives
    directly, mass per (topic, destination broker)."""
    from cruise_control_tpu_torch.controller import MoveAcceptancePrior
    from cruise_control_tpu_torch.models.builder import ClusterCatalog

    catalog = ClusterCatalog(topics=tuple(f"t{t}" for t in range(state.shape.num_topics)), partitions=())
    prior = MoveAcceptancePrior(mix=mix, min_observations=0)
    n = prior.observe_proposals(res.proposals, catalog)
    return prior.table(catalog, state.shape), n, prior, catalog


def check_prior(state, cfg, exact: dict, table, table2, table3) -> dict:
    """Phase 13: the learned prior on the north star.  A cold prior
    (prior_enabled, no prior: mix 0) is phase 4's run bit for bit; the
    candidates prior variant against its plain version on one warm-prior
    step (acceptance and the took-the-prior mask identical on every
    candidate); the warm-prior proposal (hard goals met, validation clean:
    rounds, proposals and objective reported, not claimed better); then
    `optimize(prior=)` with a second table and `rebind_prior` with a third
    on the same engine: no capture, one graph launch."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    cfg_p = dataclasses.replace(cfg, prior_enabled=True)
    opt = GoalOptimizer(config=cfg_p, device=state.device)
    cold, _ = run_proposal(opt, state, "prior_cold_north_star")
    rounds = [h["accepted"] for h in cold.history if "round" in h]
    same = all(bool(torch.equal(getattr(cold.state_after, f), exact[f])) for f in PLACEMENT)
    check(same and rounds == exact["accepted"] and len(cold.proposals) == exact["proposals"],
          f"a cold prior is not phase 4's run: identical={same}, rounds {rounds}")
    del cold
    eng, cap = capture_step(state, cfg_p, prior=table)
    krec, _ = check_candidates_variant(eng, cap, "candidates_prior", 180.0,
                                       lambda ck, keys: 16 + 4 + eng.K_r + prior_probe_bytes(eng, ck, keys))
    eng.release()
    del eng, cap
    warm, launches = run_proposal(opt, state, "prior_warm_north_star", prior=table)
    PLACEMENTS["13"] = {f: getattr(warm.state_after, f).clone() for f in PLACEMENT}
    w_rounds = [h for h in warm.history if "round" in h]
    second, _ = run_proposal(opt, state, "prior_second_table", prior=table2)
    t2 = next(h for h in second.history if h.get("timing"))
    engine = next(iter(opt._engines.values()))
    n_caps = len(engine.graph_stats.get("captures", []))
    engine.rebind_prior(table3)
    final3, hist3 = engine.run()
    t3 = hist3[-1]
    rec = dict(phase="prior_check", cold_identical_to_phase4=same, warm_mix=table.mix,
               warm_rounds=len(w_rounds), warm_accepted=[h["accepted"] for h in w_rounds],
               warm_proposals=len(warm.proposals), warm_objective=[warm.objective_before,
                                                                   warm.objective_after],
               warm_violated_after=warm.violated_goals_after(), phase4_rounds=exact["rounds"],
               phase4_proposals=exact["proposals"], phase4_objective_after=exact["objective_after"],
               second_table_captured=t2["captured"], second_table_graph_launches=t2["graph_launches"],
               rebind_prior_captured=t3["captured"], rebind_prior_graph_launches=t3["graph_launches"],
               captures_before_after_rebind_prior=[n_caps, len(engine.graph_stats.get("captures", []))],
               launches=launches)
    log(json.dumps(rec))
    check(t2["captured"] == [] and t2["graph_launches"] == 1 and t2["engine_cache_hit"],
          f"optimize(prior=) with a second table captured anew: {t2}")
    check(t3["captured"] == [] and t3["graph_launches"] == 1 and t3["blocking_syncs"] == 1
          and rec["captures_before_after_rebind_prior"][0] == rec["captures_before_after_rebind_prior"][1],
          f"rebind_prior captured anew: {t3}")
    for engine in opt._engines.values():
        engine.release()
    krec["launches"] = launches["candidates"]
    return krec


def check_bf16(state, cfg, exact: dict) -> dict:
    """Phase 14: bf16 scoring on the north star.  The candidates bf16
    variant against the bf16 plain version on one step (acceptance
    identical on every candidate; deltas bit for bit, against the plain
    version on the card and on the CPU);
    its time against the f32 call's in turns; the proposal: hard goals
    met, validation clean, and the JAX package's tolerance gate against
    phase 4's f32 objective, |obj_bf16 - obj_f32| <= 0.02 max(|obj_f32|,
    1e-6) (analyzer.precision.tolerance)."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.kernels import candidates as cand_k

    cfg_b = dataclasses.replace(cfg, score_dtype="bfloat16")
    eng, cap = capture_step(state, cfg_b)
    krec, call = check_candidates_variant(eng, cap, "candidates_bf16", 30.0, lambda ck, keys: 0,
                                          bitwise=True)
    f32_eng, f32_cap = capture_step(state, cfg)
    (f_args, f_kw), = f32_cap.calls["candidates"]
    turns = []
    for which in ("f32", "bf16", "bf16", "f32"):
        a, k = (f_args, f_kw) if which == "f32" else (call["args"], call["kw"])
        turns.append([which, measure(lambda: cand_k.candidates(*a, **k))["ms"]])
    krec["f32_vs_bf16_ms"] = turns
    eng.release()
    f32_eng.release()
    del eng, cap, f32_eng, f32_cap, call
    opt = GoalOptimizer(config=cfg_b, device=state.device)
    res, launches = run_proposal(opt, state, "bf16_north_star")
    ref = exact["objective_after"]
    gap = abs(res.objective_after - ref)
    bar = 0.02 * max(abs(ref), 1e-6)
    rounds = [h for h in res.history if "round" in h]
    rec = dict(phase="bf16_check", objective_after=res.objective_after, f32_objective_after=ref,
               gap=gap, gate=bar, rounds=len(rounds), accepted=[h["accepted"] for h in rounds],
               proposals=len(res.proposals), violated_after=res.violated_goals_after(),
               candidates_ms_turns=turns, launches=launches)
    log(json.dumps(rec))
    check(gap <= bar, f"bf16: objective {res.objective_after} vs f32 {ref} fails the 0.02 gate")
    for engine in opt._engines.values():
        engine.release()
    krec["launches"] = launches["candidates"]
    return krec


def stream_window(host: dict, live_state, n_parts, factor: float, rng):
    """One window of phase 15: the leader and follower rows of `n_parts`
    partitions drawn from `rng` (every partition when None, none when 0)
    at `factor` times their live loads (host numpy: rows i32[n], f32[n, 4]
    each)."""
    import numpy as np

    valid, part = host["replica_valid"], host["replica_partition"]
    if n_parts is None:
        rows = np.nonzero(valid)[0]
    elif n_parts == 0:
        rows = np.zeros(0, np.int64)
    else:
        chosen = rng.choice(int(part[valid].max()) + 1, size=n_parts, replace=False)
        rows = np.nonzero(valid & np.isin(part, chosen))[0]
    rows = rows.astype(np.int32)
    ll = live_state.replica_load_leader.cpu().numpy()[rows] * np.float32(factor)
    fl = live_state.replica_load_follower.cpu().numpy()[rows] * np.float32(factor)
    return rows, ll.astype(np.float32), fl.astype(np.float32)


def check_scatter_kernel(state, windows: list) -> dict:
    """Phase 15's kernel: scatter_loads against scatter_loads_plain, bit for
    bit, from a staging buffer of capacity R (as the cycle's), on the
    window-2 and window-3 inputs (window 3 with sentinel, past-the-end and
    negative rows among its real ones) and on an empty window; then its
    time on window 2's 500,245 rows beside the plain version's and one
    `index_copy_` pair's on the unpadded rows, and the bound: 68 B a row."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch.kernels import scatter as scatter_k

    dev = state.device
    R = state.shape.R
    base = (state.replica_load_leader.clone(), state.replica_load_follower.clone())

    def staging(rows, ll, fl):
        n = int(rows.size)
        st_rows = torch.full((R,), R, dtype=torch.int32, device=dev)
        st_ll = torch.zeros((R, 4), dtype=torch.float32, device=dev)
        st_fl = torch.zeros((R, 4), dtype=torch.float32, device=dev)
        if n:
            st_rows[:n] = torch.from_numpy(rows).to(dev)
            st_ll[:n] = torch.from_numpy(ll).to(dev)
            st_fl[:n] = torch.from_numpy(fl).to(dev)
        return st_rows, st_ll, st_fl, torch.tensor([n], dtype=torch.int32, device=dev)

    rows3, ll3, fl3 = windows[1]
    rows3 = rows3.copy()
    rows3[2::83] -= R  # the same rows counted from the end, as a JAX index is
    rows3[::97] = R  # the sentinel
    rows3[1::89] = R + 17  # past the end
    cases = {"window2": windows[0], "window3_sentinels": (rows3, ll3, fl3),
             "empty": (np.zeros(0, np.int32), np.zeros((0, 4), np.float32),
                       np.zeros((0, 4), np.float32))}
    checked = {}
    for name, (rows, ll, fl) in cases.items():
        args = staging(rows, ll, fl)
        got = [t.clone() for t in base]
        want = [t.clone() for t in base]
        for _ in range(3):
            scatter_k.scatter_loads(*got, *args)
        scatter_k.scatter_loads_plain(*want, *args)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(g.view(torch.int32), w.view(torch.int32)))
                   for g, w in zip(got, want))
        changed = int((got[0] != base[0]).any(1).sum())
        checked[name] = dict(rows=int(rows.size), bit_for_bit=same, rows_changed=changed)
        check(same, f"scatter_loads differs from its plain version on {name}")
    rows2, ll2, fl2 = windows[0]
    args = staging(rows2, ll2, fl2)
    out = [t.clone() for t in base]
    kt = measure(lambda: scatter_k.scatter_loads(*out, *args))
    one_launch(kt, "scatter_loads_kernel")
    pt = measure(lambda: scatter_k.scatter_loads_plain(*out, *args), graph=False)
    idx = torch.from_numpy(rows2.astype(np.int64)).to(dev)
    new_ll, new_fl = torch.from_numpy(ll2).to(dev), torch.from_numpy(fl2).to(dev)
    lib = measure(lambda: (out[0].index_copy_(0, idx, new_ll), out[1].index_copy_(0, idx, new_fl)), graph=False)
    n = int(rows2.size)
    nb = 68 * n  # a row's index, two new rows read, two rows written
    b_ms, b_by = bound(nb, 0.0)
    rec = dict(max_abs_err=0.0, **timings(kt, pt), library_ms=lib["ms"], library_call_ms=lib["call_ms"],
               bound_ms=b_ms, bound_by=b_by, bound_bytes=nb, n=n, cases=checked,
               tolerance="bit for bit, three calls, window 2, window 3 with sentinel, past-the-end "
                         "and negative rows, and an empty window")
    log(json.dumps({"phase": "kernel", "name": "scatter_loads", **rec}))
    return rec


def check_streaming(state, cfg, prior, catalog) -> dict:
    """Phase 15: the streaming replay at full width.  Two optimizers from
    the same state, SEARCH with the prior on: `fused` (LiveState +
    optimize_streaming_cycle) and `staged` (LiveState.set_partition_loads +
    optimize(initial_placement=, prior=)); a reflatten (a cold optimize on
    each), then STREAM_WINDOWS, the prior refreshed before each window
    from the previous window's proposals.  Each window: identical
    placements, proposal columns and live loads on both paths; one
    blocking sync, no capture and the two counted dispatches on every
    fused cycle; no capture on the staged path after the reflatten; every
    hard goal met on both.  Launch counts are zeroed just before each
    fused cycle and read just after."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.goals import HARD_GOAL_NAMES
    from cruise_control_tpu_torch.analyzer.proposals import fetch_before_host
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter
    from cruise_control_tpu_torch.models.whatif import LiveState

    cfg_p = dataclasses.replace(cfg, prior_enabled=True)
    dev = state.device
    shape = state.shape
    host = {f: getattr(state, f).cpu().numpy() for f in ("replica_valid", "replica_partition")}
    rng = np.random.default_rng(15)

    def live():
        return LiveState(dataclasses.replace(
            state, replica_load_leader=state.replica_load_leader.clone(),
            replica_load_follower=state.replica_load_follower.clone()))

    paths = {"fused": (GoalOptimizer(config=cfg_p, device=dev), live()),
             "staged": (GoalOptimizer(config=cfg_p, device=dev), live())}

    def hard_ok(res) -> bool:
        return all(v <= 1e-6 for n, v in zip(res.goal_names, res.violations_after)
                   if n in HARD_GOAL_NAMES)

    def record(res, wall, counts, rows):
        t = next(h for h in res.history if h.get("timing"))
        return dict(rows=rows, scatter_width=t.get("scatter_width"), wall_s=wall,
                    host_dispatch_s=t["host_dispatch_s"], device_s=t["device_s"],
                    host_extract_s=t["host_extract_s"],
                    rounds=len([h for h in res.history if "round" in h]),
                    graph_launches=t["graph_launches"], report_graph_launches=t["report_graph_launches"],
                    blocking_syncs=t["blocking_syncs"], captured=t["captured"], dispatches=counts,
                    proposals=len(res.proposals), objective=[res.objective_before, res.objective_after],
                    hard_goals_met=hard_ok(res), fused_cycle=bool(t.get("fused_cycle")))

    # window 1: the reflatten, a cold optimize on both paths
    table = prior.table(catalog, shape)
    res, windows_out = {}, []
    rec1 = {}
    for name, (opt, lv) in paths.items():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with dispatch_meter() as m:
            res[name] = opt.optimize(lv.state, prior=table)
        torch.cuda.synchronize()
        rec1[name] = record(res[name], time.monotonic() - t0, dict(m.counts), 0)
    before_host = fetch_before_host(paths["fused"][1].state)
    reflattens = [next(h for h in res["fused"].history if h.get("timing"))]
    log(json.dumps({"phase": "stream_window", "window": 1, "kind": "reflatten", **rec1}))
    check(all(r["hard_goals_met"] for r in rec1.values()), f"stream window 1: a hard goal is violated: {rec1}")
    fused_launches = {k: 0 for k in kernels.LAUNCHES}
    kernel_windows = []
    for w, (n_parts, factor) in enumerate(STREAM_WINDOWS, start=2):
        prior.observe_proposals(res["fused"].proposals, catalog)
        table = prior.table(catalog, shape)
        rows, ll, fl = stream_window(host, paths["fused"][1].state, n_parts, factor, rng)
        if w in (2, 3):
            kernel_windows.append((rows, ll, fl))
        rec = {}
        # fused: one cycle
        opt, lv = paths["fused"]
        warm = tuple(getattr(res["fused"].state_after, f) for f in PLACEMENT)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.monotonic()
        with dispatch_meter() as m:
            out = opt.optimize_streaming_cycle(lv.state, rows=rows, leader_loads=ll, follower_loads=fl,
                                               initial_placement=warm, prior=table,
                                               before_host=before_host)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(kernels.LAUNCHES)
        check(out is not None, f"stream window {w}: no cached engine for the fused cycle")
        res["fused"], (n_ll, n_fl) = out
        lv.adopt_loads(n_ll, n_fl)
        rec["fused"] = record(res["fused"], wall, dict(m.counts), int(rows.size))
        rec["fused"]["launches"] = launches
        for k, v in launches.items():
            fused_launches[k] += v
        # staged: the scatter, then a warm optimize
        opt, lv = paths["staged"]
        warm = tuple(getattr(res["staged"].state_after, f) for f in PLACEMENT)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with dispatch_meter() as m:
            width = lv.set_partition_loads(rows, ll, fl)
            res["staged"] = opt.optimize(lv.state, initial_placement=warm, prior=table)
        torch.cuda.synchronize()
        rec["staged"] = record(res["staged"], time.monotonic() - t0, dict(m.counts), int(rows.size))
        rec["staged"]["scatter_width"] = width
        f, g = res["fused"], res["staged"]
        same_place = all(bool(torch.equal(getattr(f.state_after, x), getattr(g.state_after, x)))
                         for x in (*PLACEMENT, "replica_offline"))
        fc, gc = f.proposals._c, g.proposals._c
        same_prop = fc.keys() == gc.keys() and all(np.array_equal(fc[k], gc[k]) for k in fc)
        lf, ls = paths["fused"][1].state, paths["staged"][1].state
        same_loads = all(bool(torch.equal(getattr(lf, x).view(torch.int32), getattr(ls, x).view(torch.int32)))
                         for x in ("replica_load_leader", "replica_load_follower"))
        same_reports = (f.objective_before == g.objective_before and f.objective_after == g.objective_after
                        and np.array_equal(f.violations_after, g.violations_after))
        rec.update(phase="stream_window", window=w, partitions=n_parts, factor=factor, mix=table.mix,
                   identical_placements=same_place, identical_proposals=same_prop,
                   identical_live_loads=same_loads, identical_reports=same_reports)
        log(json.dumps(rec))
        check(same_place and same_prop and same_loads and same_reports,
              f"stream window {w}: the fused cycle differs from the staged path")
        fr = rec["fused"]
        check(fr["fused_cycle"] and fr["blocking_syncs"] == 1 and fr["captured"] == []
              and fr["dispatches"] == {"engine.cycle": 1, "engine.extract": 1},
              f"stream window {w}: the fused cycle broke its contract: {fr}")
        check(rec["staged"]["captured"] == [], f"stream window {w}: the staged path captured anew")
        check(fr["hard_goals_met"] and rec["staged"]["hard_goals_met"],
              f"stream window {w}: a hard goal is violated")
        missing = [k for k in PATH_KERNELS if launches[k] == 0]
        check(not missing, f"stream window {w}: kernels never launched by the cycle: {missing}")
        check(launches["scatter_loads"] == 1,
              f"stream window {w}: the cycle launched scatter_loads {launches['scatter_loads']} times")
        windows_out.append(rec)
    # a second reflatten on the fused path: the live state (the loads the
    # windows left) with broker 3 dead, a new model generation of the bucket
    opt, lv = paths["fused"]
    st = lv.state
    alive = st.broker_alive.clone()
    alive[3] = False
    gen = dataclasses.replace(st, broker_alive=alive, disk_alive=alive[:, None] & st.disk_alive,
                              replica_offline=st.replica_offline | (st.replica_valid
                                                                     & ~alive[st.replica_broker]))
    torch.cuda.synchronize()
    again = opt.optimize(gen, prior=table)
    torch.cuda.synchronize()
    reflattens.append(next(h for h in again.history if h.get("timing")))
    check_generation(again, gen, cfg_p, "stream_reflatten", dict(reflatten_1=rec1["fused"]["wall_s"]),
                     prior=table)
    captures_per_key("stream_reflatten", [dict(bucket=t["bucket"], captures=int(bool(t["captured"])))
                                          for t in reflattens])
    for opt, _ in paths.values():
        for engine in opt._engines.values():
            engine.release()
    del paths, res, again
    torch.cuda.empty_cache()
    krec = check_scatter_kernel(state, kernel_windows)
    krec["launches"] = fused_launches["scatter_loads"]
    krec["launches_a_cycle"] = fused_launches["scatter_loads"] / len(STREAM_WINDOWS)
    log(json.dumps({"phase": "stream_check", "windows": len(windows_out) + 1,
                    "fused_cycle_launches": fused_launches}))
    return krec


def scenario_batch(n: int, start: int, racks: int, brokers: int, topics: int) -> list:
    """`bench.py:scenarios_bench`'s what-ifs (bench.py:1992-2007), i from
    `start`: i % 4 picks the kind — kill rack i % racks, add 1 + i % 3
    brokers, remove broker i % brokers, or scale topic i % topics by
    1 + 0.25 (i % 5)."""
    from cruise_control_tpu_torch.planner import BrokerAdd, Scenario

    out = []
    for i in range(start, start + n):
        kind = i % 4
        if kind == 0:
            out.append(Scenario(name=f"kill-rack-{i}", kill_racks=(i % racks,)))
        elif kind == 1:
            out.append(Scenario(name=f"add-{i}", add_brokers=(BrokerAdd(count=1 + i % 3),)))
        elif kind == 2:
            out.append(Scenario(name=f"remove-{i}", remove_brokers=(i % brokers,)))
        else:
            out.append(Scenario(name=f"scale-{i}", topic_load_factors={i % topics: 1.0 + 0.25 * (i % 5)}))
    return out


def check_scenario_step() -> dict:
    """Phase 16's kernel: scenario_step against its plain version on a
    table of (i, n) cases (exact), then its time beside the plain
    version's (host, CPU tensors) and its bound: one thread reads ctrl and
    the slot's 1 + G floats and writes a row and the counter."""
    import torch

    from cruise_control_tpu_torch.kernels import scenario as scen_k

    G = 16
    cases = [(0, 5), (4, 5), (7, 5), (3, 40), (31, 32), (-1, 3), (0, 0)]
    for i, n in cases:
        got, want = (scen_k.ScenarioLoop.create(32, G, d) for d in ("cuda", "cpu"))
        for s in (got, want):
            s.obj_slot.fill_(1.25)
            s.viol_slot.copy_(torch.linspace(0.0, 1.0, G))
            s.ctrl.copy_(torch.tensor([i, n], dtype=torch.int32))
        scen_k.scenario_step(got)
        scen_k.scenario_step_plain(want)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(got, f).cpu(), getattr(want, f)) for f in ("ctrl", "obj_out", "viol_out"))
        check(same, f"scenario_step differs from its plain version at i={i}, n={n}")
    # timed with i kept below n, so every call stores its row
    cap = 1 << 20
    loop = scen_k.ScenarioLoop.create(cap, G, "cuda")
    loop.ctrl.copy_(torch.tensor([0, cap], dtype=torch.int32, device="cuda"))
    kt = measure(lambda: scen_k.scenario_step_cuda(loop))
    one_launch(kt, "scenario_step_kernel")
    plain = scen_k.ScenarioLoop.create(cap, G, "cpu")
    plain.ctrl[1] = cap
    p_ms = host_time_ms(lambda: scen_k.scenario_step_plain(plain))
    nb = 8 + 4 * (1 + G) + 4 * (1 + G) + 4
    b_ms, b_by = bound(nb, 0.0)
    rec = dict(max_abs_err=0.0, ms=kt["ms"], own_kernel_ms=kt["own_kernel_ms"], call_ms=kt["call_ms"],
               ms_source=kt["ms_source"], plain_ms=p_ms, plain_ms_source="host, CPU tensors",
               library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_bytes=nb,
               tolerance=f"exact on {len(cases)} (i, n) cases")
    log(json.dumps({"phase": "kernel", "name": "scenario_step", **rec}))
    return rec


def check_scenarios(state) -> dict:
    """Phase 16: 32 north-star what-ifs of one planned shape as one batch:
    one graph launch and one sync, each scenario's objective and
    violations bit for bit `_single_eval`'s (the sequential chain, every
    launch from the host); warmed batched and sequential walls (the JAX
    package's gate: batched <= sequential); a second batch of 12 other
    scenarios with the same varying fields captures nothing.  Launch
    counts are zeroed just before the first batch and read just after."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import ScenarioEvaluator
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.planner import apply_scenario, plan_shape

    s = state.shape
    dims = (NORTH_STAR_SPEC["num_racks"], NORTH_STAR_SPEC["num_brokers"], NORTH_STAR_SPEC["num_topics"])
    scenarios = scenario_batch(32, 0, *dims)
    second = scenario_batch(12, 32, *dims)
    t0 = time.monotonic()
    shape = plan_shape(state, scenarios + second)
    base = pad_state(state, shape) if shape != s else state
    states = [apply_scenario(base, sc, shape=shape) for sc in scenarios]
    states2 = [apply_scenario(base, sc, shape=shape) for sc in second]
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    ev = ScenarioEvaluator(max_scenarios=32)
    kernels.reset_launches()
    t0 = time.monotonic()
    with dispatch_meter() as m:
        obj, viol, _ = ev.evaluate_states(states)
    first_wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    first = dict(ev.last_batch)
    check(m.counts == {"scenario.batch": 1, "scenario.sync": 1},
          f"the scenario batch made other dispatches than one launch and one sync: {m.counts}")
    # the loop's counter, read back from the device in the batch's one
    # sync: the scenarios the WHILE node ran
    check(first["steps"] == 32, f"the batch graph ran {first['steps']} scenarios of 32")
    body = first["body_launches"]
    missing = [k for k in ("group_by_broker", "refresh_aggregates") if not body.get(k)]
    check(not missing, f"kernels missing from the captured scenario body: {missing}")
    want = {k: first["warmup_launches"].get(k, 0) + body.get(k, 0) * first["steps"]
            for k in set(body) | set(first["warmup_launches"])}
    want["scenario_step"] = first["steps"]
    got = {k: v for k, v in launches.items() if v}
    check(got == want, f"the batch's launches {got} are not the warm-up's and one body a scenario: {want}")
    check(np.isfinite(obj).all() and np.isfinite(viol).all() and viol.shape == (32, 16),
          "non-finite or misshapen scenario outputs")
    # the sequential twin: each scenario scored alone, warmed
    ev._single_eval(states[0])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    singles = [ev._single_eval(st) for st in states]
    seq_wall = time.monotonic() - t0
    mism = [i for i, (o, v) in enumerate(singles)
            if float(o) != obj[i] or not np.array_equal(np.asarray(v, np.float64), viol[i])]
    check(not mism, f"the batch differs from scoring each scenario alone at {mism}")
    SCENARIO_SCORES["16"] = (obj.copy(), viol.copy())
    # warmed batched walls
    walls, dev_ms = [], []
    for _ in range(3):
        t0 = time.monotonic()
        again, _, _ = ev.evaluate_states(states)
        walls.append(time.monotonic() - t0)
        dev_ms.append(ev.last_batch["device_ms"])
        check(np.array_equal(again, obj), "a repeated batch differs")
    batched_wall = min(walls)
    with dispatch_meter() as m2:
        obj2, viol2, _ = ev.evaluate_states(states2)
    rec2 = dict(ev.last_batch)
    check(m2.counts == {"scenario.batch": 1, "scenario.sync": 1} and not rec2["captured"],
          f"the second batch captured or dispatched anew: {m2.counts}, captured={rec2['captured']}")
    check(rec2["steps"] == 12, f"the second batch graph ran {rec2['steps']} scenarios of 12")
    check(rec2["varying"] == first["varying"], "the second batch varies other fields")
    mism2 = [i for i, st in enumerate(states2) if float(ev._single_eval(st)[0]) != obj2[i]]
    check(not mism2, f"the second batch differs from scoring each scenario alone at {mism2}")
    rec = dict(phase="scenario_batch", scenarios=32, shape=dict(R=shape.R, B=shape.B, P=shape.P),
               setup_s=setup_s, first_wall_s=first_wall, batched_wall_s=batched_wall,
               batched_walls_s=walls, device_ms=dev_ms, device_ms_per_scenario=min(dev_ms) / 32,
               sequential_wall_s=seq_wall, sequential_ms_per_scenario=seq_wall / 32 * 1e3,
               batched_ms_per_scenario=batched_wall / 32 * 1e3,
               batched_le_sequential=batched_wall <= seq_wall,
               capture=dict(warmup_s=first["warmup_s"], capture_s=first["capture_s"],
                            instantiate_s=first["instantiate_s"]),
               body_nodes=first["body_nodes"], body_launches=body, warmup_launches=first["warmup_launches"],
               device_steps=first["steps"], varying=first["varying"], identical_to_single=True,
               second_batch=dict(n=12, wall_s=rec2["wall_s"], device_ms=rec2["device_ms"], captured=False),
               objective_range=[float(obj.min()), float(obj.max())], launches=launches)
    log(json.dumps(rec))
    check(batched_wall <= seq_wall, f"batched wall {batched_wall} s above the sequential {seq_wall} s")
    del states, states2, ev
    torch.cuda.empty_cache()
    return launches


def check_placement_batch(state) -> dict:
    """Phase 16, the replica rows varying: the base north star and the
    placements of phases 4, 5 and 13, the last with its replicas'
    positions reversed within partitions 0-999 (a member table of its
    own), scored as one batch: one graph launch and one sync, each score
    bit for bit its sequential `_single_eval`."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import ScenarioEvaluator
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter

    states = [state] + [dataclasses.replace(state, **PLACEMENTS[k]) for k in ("4", "5", "13")]
    last = states[-1]
    part, valid = last.replica_partition.long(), last.replica_valid
    rf = torch.bincount(part[valid], minlength=last.shape.P)[part]
    flip = valid & (part < 1000)
    pos = torch.where(flip, rf - 1 - last.replica_pos.long(), last.replica_pos.long())
    states[-1] = dataclasses.replace(last, replica_pos=pos.to(torch.int32))
    check(not torch.equal(states[-1].members, state.members),
          "the reversed positions left the member table as it was")
    ev = ScenarioEvaluator(max_scenarios=len(states))
    t0 = time.monotonic()
    with dispatch_meter() as m:
        obj, viol, _ = ev.evaluate_states(states)
    wall = time.monotonic() - t0
    rec = dict(ev.last_batch)
    check(m.counts == {"scenario.batch": 1, "scenario.sync": 1},
          f"the placement batch made other dispatches than one launch and one sync: {m.counts}")
    check(rec["steps"] == len(states), f"the placement batch ran {rec['steps']} scenarios")
    want = {"replica_broker", "replica_is_leader", "replica_disk", "replica_pos"}
    check(want <= set(rec["varying"]), f"the placement batch varies {rec['varying']}")
    singles = [ev._single_eval(st) for st in states]
    mism = [i for i, (o, v) in enumerate(singles)
            if float(o) != obj[i] or not np.array_equal(np.asarray(v, np.float64), viol[i])]
    check(not mism, f"the placement batch differs from scoring each state alone at {mism}")
    check(np.isfinite(obj).all() and len(set(obj.tolist())) > 1,
          f"the placements' objectives are not finite and distinct: {obj.tolist()}")
    out = dict(phase="placement_batch", states=len(states), varying=rec["varying"], wall_s=wall,
               device_ms=rec["device_ms"], capture_s=rec["capture_s"], body_nodes=rec["body_nodes"],
               objectives=obj.tolist(), identical_to_single=True, dispatches=m.counts)
    log(json.dumps(out))
    del ev, states
    torch.cuda.empty_cache()
    return out


def check_threads(state, cfg, exact: dict) -> dict:
    """Phase 19: one GoalOptimizer shared by two threads on the card.
    FAST on random_cluster(20/400) and on a second shape of it (30
    brokers): three runs a thread on one shape, then the two shapes
    alternating through a one-engine cache; every run the single-thread
    run's placements, proposals and rounds, and no engine evicted from the
    cache released while a run holds it.  Then the north star (SEARCH)
    once from each of two threads: both phase 4's placements, rounds and
    proposals."""
    import threading

    import torch

    from cruise_control_tpu_torch.analyzer import Engine, GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster

    def outcome(res):
        place = tuple(getattr(res.state_after, f).cpu().numpy().tobytes() for f in PLACEMENT)
        props = [(p.partition, p.old_leader, p.new_leader, p.old_replicas, p.new_replicas)
                 for p in res.proposals]
        return place, props, [h["accepted"] for h in res.history if "round" in h]

    def in_threads(jobs):
        results, errors = [[] for _ in jobs], []
        start = threading.Barrier(len(jobs))

        def work(i):
            try:
                start.wait()
                for job in jobs[i]:
                    results[i].append(job())
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results

    pinned_releases = []
    real_release = Engine.release

    def release(self):
        if getattr(self, "_cc_evicted", False) and self._cc_pins:
            pinned_releases.append(self._cc_pins)
        real_release(self)

    Engine.release = release
    try:
        fast = OptimizerConfig(**FAST)
        shapes = {n: random_cluster(RandomClusterSpec(num_brokers=n, num_partitions=400, skew=1.0),
                                    seed=2, device="cuda") for n in (20, 30)}
        single = {n: outcome(GoalOptimizer(config=fast, device="cuda").optimize(st))
                  for n, st in shapes.items()}
        t0 = time.monotonic()
        opt = GoalOptimizer(config=fast, device="cuda")
        one = in_threads([[lambda: outcome(opt.optimize(shapes[20]))] * 3] * 2)
        check(all(r == [single[20]] * 3 for r in one), "threads on one shape differ from one thread")
        opt1 = GoalOptimizer(config=fast, device="cuda", engine_cache_size=1)

        def job(n):
            return lambda: (n, outcome(opt1.optimize(shapes[n])))

        alt = in_threads([[job(20), job(30), job(20)], [job(30), job(20), job(30)]])
        check(all(got == single[n] for r in alt for n, got in r),
              "threads alternating two shapes differ from one thread")
        small_s = time.monotonic() - t0
        t0 = time.monotonic()
        north = GoalOptimizer(config=cfg, device="cuda")
        both = in_threads([[lambda: north.optimize(state)]] * 2)
        north_s = time.monotonic() - t0
        for (res,) in both:
            same = all(bool(torch.equal(getattr(res.state_after, f), exact[f])) for f in PLACEMENT)
            check(same and [h["accepted"] for h in res.history if "round" in h] == exact["accepted"]
                  and len(res.proposals) == exact["proposals"],
                  "a north-star run from a thread is not phase 4's run")
        hits = [next(h for h in r.history if h.get("timing"))["engine_cache_hit"] for (r,) in both]
        check(sorted(hits) == [False, True], f"the two north-star threads' cache hits: {hits}")
        check(not pinned_releases, f"engines released while pinned: {pinned_releases}")
        rec = dict(phase="threads", small_runs=12, small_wall_s=small_s,
                   cache1_misses=opt1.engine_cache_misses, cache1_hits=opt1.engine_cache_hits,
                   north_star_runs=2, north_star_wall_s=north_s, north_star_identical_to_phase4=True,
                   released_while_pinned=0)
        log(json.dumps(rec))
        for o in (opt, opt1, north):
            for engine in o._engines.values():
                engine.release()
    finally:
        Engine.release = real_release
    torch.cuda.empty_cache()
    return rec


def check_planner(state, cfg) -> dict:
    """Phase 17: evaluate(optimize=True) on a lose-rack / add-3 /
    double-a-topic batch of the north star (one engine, rebound twice;
    the captures each scenario's anneal made), then Rightsizer.rightsize
    with max_anneals=16 on bench.py's scenarios cluster (500 brokers,
    50,000 partitions, 20 racks, 100 topics, skew 0.5, seed 7) and on the
    north star."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer, ScenarioEvaluator
    from cruise_control_tpu_torch.planner import BrokerAdd, Scenario
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    opt = GoalOptimizer(config=cfg, device="cuda")
    ev = ScenarioEvaluator(optimizer=opt)
    scs = [Scenario(name="lose-rack", kill_racks=(0,)),
           Scenario(name="add-3", add_brokers=(BrokerAdd(count=3),)),
           Scenario(name="double-T0", topic_load_factors={0: 2.0})]
    base_alive = int((state.broker_valid & state.broker_alive).sum())
    t0 = time.monotonic()
    out = ev.evaluate(state, scs, optimize=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    fixes = ev.last_batch["fix"]
    rec = dict(phase="planner_simulate", wall_s=wall, engine_cache_hits=opt.engine_cache_hits,
               engine_cache_misses=opt.engine_cache_misses,
               captures=[dict(name=f["name"], engine_cache_hit=f["engine_cache_hit"],
                              captured=f["captured"], captures=f["captures"], bucket=f["bucket"],
                              wall_s=f["wall_s"]) for f in fixes],
               outcomes=[dict(o.to_json(), fix={k: o.fix[k] for k in (
                   "numReplicaMovements", "numLeaderMovements", "objectiveBefore", "objectiveAfter",
                   "violatedGoalsBefore", "violatedGoalsAfter", "hardGoalsSatisfiedAfter", "wallSeconds")})
                   for o in out])
    log(json.dumps(rec))
    check((opt.engine_cache_misses, opt.engine_cache_hits) == (1, 2),
          f"the batch's anneals built {opt.engine_cache_misses} engines")
    lose, add3, double = out
    rack_size = int((state.broker_rack == 0).sum())
    check([o.brokers_alive for o in out] == [base_alive - rack_size, base_alive + 3, base_alive],
          f"brokers alive: {[o.brokers_alive for o in out]}")
    check("OfflineReplicaGoal" in lose.violated_goals and lose.fix["numReplicaMovements"] > 0,
          "losing a rack stranded no replica, or the fix moved none")
    check(all(o.fix["hardGoalsSatisfiedAfter"] for o in out),
          f"a fix leaves a hard goal violated: {[o.fix['violatedGoalsAfter'] for o in out]}")
    check(all(np.isfinite(o.objective) for o in out), "non-finite scenario objective")
    captures_per_key("planner_simulate", fixes)
    for engine in opt._engines.values():
        engine.release()
    # the two later anneals (rebound, no capture) against a fresh engine's:
    # the same batch with that scenario first, on a new optimizer
    keys = ("numReplicaMovements", "numLeaderMovements", "dataToMoveMB", "objectiveBefore",
            "objectiveAfter", "balancednessAfter", "violatedGoalsAfter")
    for i in (1, 2):
        fresh_opt = GoalOptimizer(config=cfg, device="cuda")
        order = [scs[i]] + [sc for j, sc in enumerate(scs) if j != i]
        first = ScenarioEvaluator(optimizer=fresh_opt).evaluate(state, order, optimize=True)[0]
        got, want = {k: out[i].fix[k] for k in keys}, {k: first.fix[k] for k in keys}
        log(json.dumps({"phase": "planner_fresh_engine", "scenario": scs[i].name, "rebound": got,
                        "fresh": want}))
        check(got == want, f"the rebound anneal of {scs[i].name} is not a fresh engine's")
        for engine in fresh_opt._engines.values():
            engine.release()
    del opt, ev, out
    torch.cuda.empty_cache()

    spec = RandomClusterSpec(num_brokers=500, num_partitions=50_000, num_racks=20, num_topics=100, skew=0.5)
    mid = random_cluster_fast(spec, seed=7, device="cuda")
    rec = run_rightsize("scenarios_cluster", mid, cfg)
    del mid
    rec_north = run_rightsize("north_star", state, cfg)
    check(rec_north["provisionStatus"] != "UNDER_PROVISIONED",
          "the north star, whose proposal meets every hard goal, came out under-provisioned")
    return dict(scenarios_cluster=rec, north_star=rec_north)


def run_rightsize(label: str, st, cfg) -> dict:
    """One Rightsizer.rightsize (max_anneals=16) on `st` through a fresh
    optimizer and evaluator: the verdict, the anneals (each one's
    engine-cache hit and captures), the wall; feasibility monotone in the
    broker count."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer, ScenarioEvaluator
    from cruise_control_tpu_torch.planner import Rightsizer

    opt = GoalOptimizer(config=cfg, device="cuda")
    rightsizer = Rightsizer(ScenarioEvaluator(optimizer=opt))
    t0 = time.monotonic()
    rs = rightsizer.rightsize(st)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    fixes = rightsizer.last_anneals
    verdict = {k: rs[k] for k in ("provisionStatus", "currentBrokers", "minBrokers", "minBrokersUpperBound",
                                  "searchedRange", "annealsRun", "undecided", "wallSeconds")}
    rec = dict(phase="rightsize", cluster=label, brokers=int(st.broker_valid.sum()), replicas=st.shape.R,
               wall_s=wall, **verdict, candidates=rs["candidates"],
               screened=sorted(int(n) for n in rs["preMoveViolations"]),
               engine_cache_hits=opt.engine_cache_hits, engine_cache_misses=opt.engine_cache_misses,
               anneals=fixes, anneals_that_captured=sum(1 for f in fixes if f["captured"]))
    log(json.dumps(rec))
    captures_per_key(f"rightsize_{label}", fixes)
    check(rs["provisionStatus"] in ("RIGHT_SIZED", "OVER_PROVISIONED", "UNDER_PROVISIONED", "UNDECIDED"),
          f"rightsize verdict {rs['provisionStatus']}")
    check(1 <= rs["annealsRun"] <= 16 and len(fixes) == rs["annealsRun"],
          f"rightsize ran {rs['annealsRun']} anneals")
    lo, hi = rs["searchedRange"]
    if rs["minBrokers"] is not None:
        check(lo <= rs["minBrokers"] <= hi, "minBrokers outside the searched range")
    feas = sorted((c["brokers"], c["feasible"]) for c in rs["candidates"])
    check(all(not a[1] or b[1] for a, b in zip(feas, feas[1:])),
          f"feasibility is not monotone in the broker count: {feas}")
    for engine in opt._engines.values():
        engine.release()
    del opt, rightsizer
    torch.cuda.empty_cache()
    return rec


def check_greedy() -> dict:
    """Phase 18: the greedy oracle on the card against its CPU run on the
    small fixtures: the same violated goals, the objective within rtol
    1e-5; the placements' identity and the ms per candidate evaluation
    printed."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN
    from cruise_control_tpu_torch.analyzer.greedy import greedy_optimize
    from cruise_control_tpu_torch.common import compilation_cache
    from cruise_control_tpu_torch.testing import fixtures

    captures0 = compilation_cache.engine_capture_counts()
    out = {}
    for name in ("small_cluster", "rack_violated_cluster", "dead_broker_cluster"):
        res = {}
        for dev in ("cpu", "cuda"):
            st = getattr(fixtures, name)(dev)
            t0 = time.monotonic()
            final, info = greedy_optimize(st, DEFAULT_CHAIN, return_info=True, device=dev)
            wall = time.monotonic() - t0
            obj, viol, _ = DEFAULT_CHAIN.evaluate(final)
            res[dev] = dict(final=final, info=info, wall=wall, evals=info["evaluations"],
                            objective=float(obj), violated=[n for n, v in zip(DEFAULT_CHAIN.names(),
                                                                               viol.tolist()) if v > 1e-6])
        a, b = res["cpu"], res["cuda"]
        same = all(bool(torch.equal(getattr(a["final"], f), getattr(b["final"], f).cpu()))
                   for f in ("replica_broker", "replica_is_leader"))
        rec = dict(moves=[a["info"]["moves"], b["info"]["moves"]], evals=[a["evals"], b["evals"]],
                   ms_per_eval_cpu=a["wall"] / max(a["evals"], 1) * 1e3,
                   ms_per_eval_cuda=b["wall"] / max(b["evals"], 1) * 1e3,
                   objective=[a["objective"], b["objective"]], violated=b["violated"],
                   identical_placement=same)
        log(json.dumps({"phase": "greedy", "fixture": name, **rec}))
        check(a["violated"] == b["violated"], f"greedy on {name}: the card's violated goals differ")
        check(abs(a["objective"] - b["objective"]) <= 1e-5 * abs(a["objective"]) + 1e-12,
              f"greedy on {name}: objective {b['objective']} against the CPU's {a['objective']}")
        out[name] = rec
    made = {k: {s: n - captures0.get(k, {}).get(s, 0) for s, n in v.items()}
            for k, v in compilation_cache.engine_capture_counts().items()}
    made = {k: v for k, v in made.items() if any(v.values())}
    log(json.dumps({"phase": "greedy_captures", "engine_captures": made}))
    check(all(sum(v.values()) <= 1 for v in made.values()), f"greedy: a bucket captured twice: {made}")
    return out


def check_prewarm(state, cfg, exact: dict) -> dict:
    """Phase 20: GoalOptimizer.prewarm of the bucket-padded north star
    (phase 10's state) on the warm pool while the north star runs on the
    same optimizer (phase 4's placements and launch counts); then the
    padded request captures nothing on its path and gives phase 10's
    unprewarmed placements byte for byte."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.common import compilation_cache
    from cruise_control_tpu_torch.analyzer.prewarm import bucket_key
    from cruise_control_tpu_torch.models import DEFAULT_BUCKET_POLICY, pad_state
    from cruise_control_tpu_torch.models.state import member_width

    padded = pad_state(state, DEFAULT_BUCKET_POLICY.bucket_shape(state.shape))
    opt = GoalOptimizer(config=cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    opt.prewarm(padded)
    prewarm_build_s = opt.compile_attribution()[bucket_key(padded.shape)]["buildSeconds"]
    check(opt.has_engine_for(padded.shape) and (opt.engine_cache_hits, opt.engine_cache_misses) == (0, 0),
          "prewarm did not cache its engine, or counted a hit or miss")
    res, _ = run_proposal(opt, state, "north_star_beside_prewarm")
    beside = all(bool(torch.equal(getattr(res.state_after, f), exact[f])) for f in PLACEMENT)
    warm = opt._engines[(padded.shape, member_width(padded), cfg)]
    warm._warm.result(timeout=600)
    prewarm_s = time.monotonic() - t0
    cap = warm.graph_stats["captures"]
    check(beside, "the north star run beside the prewarm is not phase 4's run")
    check([c["source"] for c in cap] == ["prewarm"], f"the prewarm's captures: {cap}")
    res_p, launches = run_proposal(opt, padded, "prewarmed_bucket")
    timing = next(h for h in res_p.history if h.get("timing"))
    same = {f: bool(torch.equal(getattr(res_p.state_after, f), PADDED_RUN[f])) for f in PLACEMENT}
    prewarm_capture_s = cap[0]["warmup_s"] + cap[0]["capture_s"] + cap[0]["instantiate_s"]
    # the unprewarmed request built its engine and captured on its path;
    # the prewarmed one only rebinds: its saving set beside the build and
    # capture the prewarm took off the path
    rec = dict(phase="prewarm", prewarm_s=prewarm_s, captured=timing["captured"],
               engine_cache_hit=timing["engine_cache_hit"],
               wall_s=dict(prewarmed=res_p.wall_seconds, unprewarmed_phase_10=PADDED_RUN["wall_s"],
                           north_star_beside=res.wall_seconds),
               saving_s=PADDED_RUN["wall_s"] - res_p.wall_seconds,
               engine_build_s=dict(prewarmed=timing["engine_build_s"],
                                   unprewarmed_phase_10=PADDED_RUN["engine_build_s"],
                                   prewarm=prewarm_build_s),
               capture_s=dict(prewarmed=0.0, unprewarmed_phase_10=PADDED_RUN["capture_s"],
                              prewarm=prewarm_capture_s),
               prewarm_capture=dict(warmup_s=cap[0]["warmup_s"], capture_s=cap[0]["capture_s"],
                                    instantiate_s=cap[0]["instantiate_s"],
                                    warmup_launches=cap[0]["warmup_launches"]),
               identical_to_unprewarmed=same, compile_attribution=opt.compile_attribution(),
               engine_captures=compilation_cache.engine_capture_counts(),
               cache=[opt.engine_cache_hits, opt.engine_cache_misses])
    log(json.dumps(rec))
    check(timing["engine_cache_hit"] and timing["captured"] == [],
          f"the prewarmed bucket's request captured on its path: {timing['captured']}")
    check(all(same.values()), f"the prewarmed bucket's run differs from the unprewarmed one: {same}")
    for engine in opt._engines.values():
        engine.release()
    return rec


def check_node_floor() -> dict:
    """The floor of a one-thread kernel node inside a WHILE body, the
    position of round_schedule's GATE, DECIDE and CLOSE and of the
    scenario loop's step: kernels/schedule.py `NodeFloorGraph`, 1,000
    iterations a launch with 0 and with 8 empty one-thread nodes after the
    loop's tick; the difference over 8,000 is one node's time."""
    import torch

    from cruise_control_tpu_torch.kernels import schedule as sched_k

    iters, extra = 1000, 8
    stream = torch.cuda.current_stream()
    graphs = {n: sched_k.NodeFloorGraph(iters, n, "cuda") for n in (0, extra)}
    try:
        ms = {}
        for n, g in list(graphs.items()) + list(graphs.items())[::-1]:  # in turns
            ms.setdefault(n, []).append(time_ms(lambda g=g: g.launch(stream.cuda_stream), reps=20))
        counted = {n: g.iterations() for n, g in graphs.items()}
    finally:
        for g in graphs.values():
            g.close()
    check(counted == {0: iters, extra: iters}, f"the node-floor loops ran {counted} iterations")
    t0, t8 = (sum(ms[n]) / len(ms[n]) for n in (0, extra))
    rec = dict(phase="node_floor", iterations=iters, empty_nodes=extra, launch_ms=ms,
               node_ms=(t8 - t0) / (extra * iters), tick_iteration_ms=t0 / iters)
    log(json.dumps(rec))
    check(rec["node_ms"] > 0.0, f"an empty graph node measured {rec['node_ms']} ms")
    return rec


def check_segmented(state, decom, cfg, exact: dict) -> dict:
    """Phase 21: the fused anneal as preemptible slices of one slice graph
    under the device scheduler (fleet/scheduler.py).  (a) A north-star
    optimize granted BACKGROUND with a 0.01 s slice budget: at least four
    slices, one sync each, phase 4's exact run bit for bit, no capture
    added to the bucket, one slice-graph instantiation; the main path's
    kernels all launched (round_schedule three a loop iteration, INIT and
    one EXIT a slice).  Warmed walls of the one-launch run, the segmented
    run and a one-round-slice run (SegmentContext(1e-9)) in turns.
    (b) The same BACKGROUND run preempted mid-run by an URGENT decommission
    of the same bucket (phase 5's state) from a second thread, through the
    same optimizer and engine: the urgent request's queue-to-dispatch wait
    at most one measured slice wall plus 0.05 s, both results bit for bit
    phases 4's and 5's.  (c) The node floor (`check_node_floor`)."""
    import threading

    import numpy as np
    import torch

    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.engine import SegmentContext, segmented_execution
    from cruise_control_tpu_torch.analyzer.prewarm import bucket_key
    from cruise_control_tpu_torch.common import compilation_cache
    from cruise_control_tpu_torch.fleet.scheduler import DeviceScheduler, WorkClass

    budget, slack = 0.01, 0.05

    def timing_of(res):
        return next(h for h in res.history if h.get("timing"))

    def same_as(res, phase: str) -> bool:
        return all(bool(torch.equal(getattr(res.state_after, f), PLACEMENTS[phase][f]))
                   for f in PLACEMENT)

    def scheduler(cls=DeviceScheduler):
        return cls(slice_budget_s=budget, freshness_slo_s=60.0, aging_s=30.0, shed_queue_depth=8,
                   brownout_after_s=60.0)

    opt = GoalOptimizer(config=cfg, device="cuda")
    warm, _ = run_proposal(opt, state, "segmented_warm")  # captures the bucket's graphs
    check(same_as(warm, "4"), "phase 21's one-launch run is not phase 4's")
    bucket = bucket_key(state.shape)
    captures = compilation_cache.engine_capture_counts().get(bucket)
    slice_graphs = compilation_cache.slice_graph_counts().get(bucket, 0)

    # (a) one BACKGROUND grant, segmented
    sched = scheduler()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.monotonic()
    seg = sched.run(WorkClass.BACKGROUND, lambda: opt.optimize(state), op="drift")
    torch.cuda.synchronize()
    seg_wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    t = timing_of(seg)
    (engine,) = opt._engines.values()
    rec = dict(phase="segmented", slice_budget_s=budget, wall_s=seg_wall, segments=t["segments"],
               blocking_syncs=t["blocking_syncs"], slices=t["slices"],
               loop_iterations=t["loop_iterations"], device_s=t["device_s"],
               host_dispatch_s=t["host_dispatch_s"], captured=t["captured"],
               instantiated=t["instantiated"], slice_graph=engine.graph_stats["slice_graphs"],
               engine_captures=compilation_cache.engine_capture_counts().get(bucket),
               slice_graphs=compilation_cache.slice_graph_counts().get(bucket), launches=launches,
               dispatches=sched.stats["dispatches"], identical_to_phase4=same_as(seg, "4"))
    log(json.dumps(rec))
    check(t.get("segmented") is True and t["segments"] >= 4,
          f"the BACKGROUND north star ran {t.get('segments')} slices, expected at least 4")
    check(t["blocking_syncs"] == t["segments"] == t["graph_launches"],
          f"not one slice-graph launch and one sync a slice: {t}")
    check(rec["identical_to_phase4"], "the segmented north star is not phase 4's run")
    check([h["accepted"] for h in seg.history if "round" in h] == exact["accepted"],
          "the segmented north star's rounds are not phase 4's")
    check(t["captured"] == [] and rec["engine_captures"] == captures,
          f"the segmented run captured: {t['captured']}, {captures} -> {rec['engine_captures']}")
    check(t["instantiated"] == ["slice"] and rec["slice_graphs"] == slice_graphs + 1
          and len(rec["slice_graph"]) == 1, f"slice graphs: {rec['slice_graph']}")
    want = 3 * t["loop_iterations"] + 1 + t["segments"]
    check(launches["round_schedule"] == want,
          f"the segmented run launched round_schedule {launches['round_schedule']} times, expected {want}")
    missing = [k for k in PATH_KERNELS if launches[k] == 0]
    check(not missing, f"kernels never launched on the segmented path: {missing}")
    fused = {k: v for k, v in launches.items() if k not in PATH_KERNELS and v}
    check(not fused, f"standalone kernels launched on the segmented path: {fused}")

    # warmed walls in turns: one launch, segmented, one-round slices
    def one_launch():
        return opt.optimize(state)

    def segmented():
        return scheduler().run(WorkClass.BACKGROUND, lambda: opt.optimize(state))

    def one_round_slices():
        with segmented_execution(SegmentContext(1e-9)):
            return opt.optimize(state)

    walls: dict = {}
    runs = {"one_launch": one_launch, "segmented": segmented, "one_round_slices": one_round_slices}
    for name in ("one_launch", "segmented", "one_round_slices", "one_round_slices", "segmented",
                 "one_launch"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = runs[name]()
        torch.cuda.synchronize()
        tt = timing_of(res)
        walls.setdefault(name, []).append(dict(
            wall_s=time.monotonic() - t0, engine_s=tt["device_s"] + tt["host_dispatch_s"],
            segments=tt.get("segments", 1), syncs=tt["blocking_syncs"]))
        check(same_as(res, "4"), f"the {name} north star is not phase 4's run")
    mean = {k: float(np.mean([w["engine_s"] for w in v])) for k, v in walls.items()}
    segs = {k: v[0]["segments"] for k, v in walls.items()}
    per_slice = {k: (mean[k] - mean["one_launch"]) / max(1, segs[k] - 1)
                 for k in ("segmented", "one_round_slices")}
    log(json.dumps(dict(phase="segmented_walls", runs=walls, mean_engine_s=mean,
                        extra_s_per_slice=per_slice)))

    # (b) a same-bucket URGENT decommission preempts a BACKGROUND north star
    class Signalled(DeviceScheduler):
        """Signals its first checkpoint (and waits for nothing)."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.first = threading.Event()

        def _checkpoint(self, ticket, ctx=None):
            self.first.set()
            return super()._checkpoint(ticket, ctx)

    sched2 = scheduler(Signalled)
    out, errors = {}, []

    def background():
        try:
            out["bg"] = sched2.run(WorkClass.BACKGROUND, lambda: opt.optimize(state), op="drift")
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    def urgent():
        try:
            check(sched2.first.wait(120.0), "the background run never reached a checkpoint")
            t0 = time.monotonic()
            out["urgent"] = sched2.run(
                WorkClass.URGENT, lambda: (time.monotonic() - t0, opt.optimize(decom)),
                op="fix:decommission")
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    kernels.reset_launches()
    threads = [threading.Thread(target=background, daemon=True),
               threading.Thread(target=urgent, daemon=True)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300.0)
    check(not any(th.is_alive() for th in threads), "the same-bucket preemption deadlocked")
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    launches_b = dict(kernels.LAUNCHES)
    wait, res_u = out["urgent"]
    tb, tu = timing_of(out["bg"]), timing_of(res_u)
    slice_wall = max(s["wall_s"] for s in tb["slices"])
    pre = dict(phase="segmented_preemption", urgent_wait_s=wait, slice_wall_max_s=slice_wall,
               slack_s=slack, bg_slices=tb["slices"], bg_pauses=tb["pauses"],
               bg_restores=tb["restores"], bg_paused_s=tb["paused_s"],
               urgent_captured=tu["captured"], urgent_segmented=tu.get("segmented", False),
               preemptions=sched2.stats["preemptions"], dispatches=sched2.stats["dispatches"],
               cache=[opt.engine_cache_hits, opt.engine_cache_misses],
               bg_identical_to_phase4=same_as(out["bg"], "4"),
               urgent_identical_to_phase5=same_as(res_u, "5"), launches=launches_b)
    log(json.dumps(pre))
    check(sched2.stats["preemptions"] == 1 and tb["pauses"] == 1 and tb["restores"] == 1,
          f"the background run was not preempted once and restored: {pre}")
    check(wait <= slice_wall + slack,
          f"the urgent request waited {wait} s, more than one slice ({slice_wall} s) + {slack} s")
    check(pre["bg_identical_to_phase4"], "the preempted background run is not phase 4's")
    check(pre["urgent_identical_to_phase5"], "the urgent decommission is not phase 5's")
    check(tu["captured"] == [] and opt.engine_cache_misses == 1,
          f"the urgent run captured or built an engine: {tu['captured']}, {pre['cache']}")
    missing = [k for k in PATH_KERNELS if launches_b[k] == 0]
    check(not missing, f"kernels never launched on the preempted path: {missing}")
    for e in opt._engines.values():
        e.release()
    torch.cuda.empty_cache()
    # (c) the floor of a one-thread control kernel's node
    floor = check_node_floor()
    return dict(a=rec, walls=walls, per_slice=per_slice, b=pre, floor=floor)


@contextlib.contextmanager
def card_answers_only():
    """Phases 4-21 run without a supervisor, so none of their answers may
    be degraded: every GoalOptimizer.optimize result and streaming cycle,
    every ScenarioEvaluator batch and outcome is checked for `degraded`
    False (and an optimize result's `summary()["degraded"]` False) as it
    is returned, and counted into AUDIT."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, ScenarioEvaluator

    lock = threading.Lock()
    orig = dict(optimize=GoalOptimizer.optimize, cycle=GoalOptimizer.optimize_streaming_cycle,
                batch=ScenarioEvaluator.evaluate_states, evaluate=ScenarioEvaluator.evaluate)

    def seen(kind: str, n: int = 1) -> None:
        with lock:
            AUDIT[kind] = AUDIT.get(kind, 0) + n

    def optimize(self, *a, **kw):
        res = orig["optimize"](self, *a, **kw)
        check(res.degraded is False and res.summary()["degraded"] is False,
              f"a degraded optimize answer in phases 4-21: {res.history[:1]}")
        seen("optimize")
        return res

    def cycle(self, *a, **kw):
        out = orig["cycle"](self, *a, **kw)
        if out is not None:
            check(out[0].degraded is False, "a degraded streaming cycle in phases 4-21")
            seen("streaming_cycle")
        return out

    def batch(self, states):
        obj, viol, degraded = orig["batch"](self, states)
        check(degraded is False, "a degraded scenario batch in phases 4-21")
        seen("scenario_batch")
        return obj, viol, degraded

    def evaluate(self, *a, **kw):
        outcomes = orig["evaluate"](self, *a, **kw)
        check(not any(o.degraded for o in outcomes), "a degraded scenario outcome in phases 4-21")
        seen("scenario_outcome", len(outcomes))
        return outcomes

    GoalOptimizer.optimize, GoalOptimizer.optimize_streaming_cycle = optimize, cycle
    ScenarioEvaluator.evaluate_states, ScenarioEvaluator.evaluate = batch, evaluate
    try:
        yield
    finally:
        GoalOptimizer.optimize, GoalOptimizer.optimize_streaming_cycle = orig["optimize"], orig["cycle"]
        ScenarioEvaluator.evaluate_states, ScenarioEvaluator.evaluate = orig["batch"], orig["evaluate"]


def spin_cycles_per_ms() -> float:
    """`torch.cuda._sleep` cycles a ms on this card, measured."""
    import torch

    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return 100_000_000 / start.elapsed_time(end)


def real_oom(op, fn, args, kwargs):
    """A fault effect: the caching allocator's own out-of-memory error, from
    asking it for more bytes than the card has."""
    import torch

    torch.empty(torch.cuda.get_device_properties(0).total_memory + (1 << 20), dtype=torch.uint8,
                device="cuda")
    return fn(*args, **kwargs)


def same_placement(res, exact: dict) -> bool:
    import torch

    return all(torch.equal(getattr(res.state_after, f), exact[f]) for f in PLACEMENT)


def check_supervision(state, cfg, exact: dict) -> dict:
    """Phase 22: supervision on the card.  (a) a real OOM, (b) a real hang,
    (c) a real sticky error in a child process, (d) the scenario batch
    supervised, healthy and with a real OOM (module docstring)."""
    import gc

    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer, ScenarioEvaluator
    from cruise_control_tpu_torch.common.device_watchdog import (
        BreakerState,
        DeviceDegradedError,
        DeviceSupervisor,
        FailureClass,
    )
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.planner import apply_scenario, plan_shape
    from cruise_control_tpu_torch.testing import faults

    def refused(fn, cls):
        """The DeviceDegradedError of class `cls` that fn raises, and the
        seconds until it was raised."""
        t0 = time.monotonic()
        try:
            fn()
        except DeviceDegradedError as e:
            check(e.failure_class is cls, f"{e!r} is not of class {cls.value}")
            return e, time.monotonic() - t0
        raise AssertionError(f"no DeviceDegradedError of class {cls.value} was raised")

    out = {}
    state.members  # the state's member table, built once, held before the phase
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()

    # (a) a real OOM
    sup = DeviceSupervisor(op_timeout_s=120.0, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, device="cuda")
    opt = GoalOptimizer(config=cfg, device="cuda", supervisor=sup)
    with faults.device_fault(real_oom, schedule=faults.first(1)) as fl:
        err, wall = refused(lambda: opt.optimize(state), FailureClass.OOM)
    check(fl.fired == {"engine.run": 1}, f"the OOM fault did not fire once on engine.run: {fl.fired}")
    check(isinstance(err.__cause__, torch.cuda.OutOfMemoryError),
          f"the failure is not the allocator's: {err.__cause__!r}")
    check(sup.breaker.state is BreakerState.OPEN, "the breaker is not open after the OOM")
    check(not opt.has_engine_for(state.shape, config=cfg), "the failed engine stayed cached")
    del err
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    check(mem1 == mem0, f"the allocator holds {mem1 - mem0} bytes more after the OOM")
    out["oom"] = dict(failure_to_error_s=wall, memory_allocated=[mem0, mem1])
    # recovery: the probe closes the breaker, the engine is re-captured once
    rec_res, _ = run_proposal(opt, state, "supervised_recovery_after_oom")
    t = next(h for h in rec_res.history if h.get("timing"))
    check(not rec_res.degraded and sup.breaker.state is BreakerState.CLOSED, "no recovery after the OOM")
    check(same_placement(rec_res, exact) and len(rec_res.proposals) == exact["proposals"],
          "the recovered run is not phase 4's")
    check(t["captured"], "the purged engine was not re-captured")
    caps = [c for e in opt._engines.values() for c in e.graph_stats.get("captures", [])]
    check(len(caps) == 1, f"the purged engine was captured {len(caps)} times")
    out["oom"].update(recovery_wall_s=rec_res.wall_seconds, probes=sup.num_probes,
                      recapture_s=caps[0]["warmup_s"] + caps[0]["capture_s"] + caps[0]["instantiate_s"],
                      recapture=dict(warmup_s=caps[0]["warmup_s"], capture_s=caps[0]["capture_s"],
                                     instantiate_s=caps[0]["instantiate_s"]),
                      proposals=len(rec_res.proposals))
    log(json.dumps({"phase": "supervision_oom", **out["oom"]}))
    del rec_res

    # (b) a real hang: a 5 s spin on the card under a 2 s budget, which
    # stays the budget of the recovery
    cpm = spin_cycles_per_ms()
    spin_ms, budget = 5000.0, 2.0
    worker = {}

    def spin(op, fn, args, kwargs):
        worker["start"] = time.monotonic()
        torch.cuda._sleep(int(spin_ms * cpm))
        torch.cuda.current_stream().synchronize()
        worker["spin_end"] = time.monotonic()
        out = fn(*args, **kwargs)  # the abandoned run, to its end
        worker["done"] = time.monotonic()
        return out

    sup.op_timeout_s = budget
    with faults.device_fault(spin, schedule=faults.first(1)):
        _, hang_wall = refused(lambda: opt.optimize(state), FailureClass.HANG)
        check(sup.breaker.state is BreakerState.OPEN, "the breaker is not open after the hang")
        # the worker still waits for the spin: the probe must fail
        spinning = "spin_end" not in worker
        check(spinning and not sup.available(), "the breaker closed while the spin still ran")
        diagnosis = sup.last_failure["error"]
        check("abandoned" in diagnosis, f"the probe failed for another reason: {diagnosis}")
        deadline = time.monotonic() + 120.0
        while sup.abandoned_running() and time.monotonic() < deadline:
            time.sleep(0.01)
        check("done" in worker, "the abandoned worker never finished its run")
    t_rec = time.monotonic()
    again, _ = run_proposal(opt, state, "supervised_recovery_after_hang")
    check(not again.degraded and sup.breaker.state is BreakerState.CLOSED, "no recovery after the hang")
    check(same_placement(again, exact) and len(again.proposals) == exact["proposals"],
          "the run after the hang is not phase 4's")
    t = next(h for h in again.history if h.get("timing"))
    caps = [c for e in opt._engines.values() for c in e.graph_stats.get("captures", [])]
    out["hang"] = dict(
        budget_s=budget, recovery_budget_s=sup.op_timeout_s, spin_ms=spin_ms,
        spin_s=worker["spin_end"] - worker["start"], failure_to_error_s=hang_wall,
        breaker_open_while_spinning=True, probe_diagnosis=diagnosis,
        abandoned_worker_done_after_s=worker["done"] - worker["start"],
        recovery_started_after_spin_start_s=t_rec - worker["start"],
        recovery_waited_for_spin="no: the probe held the breaker open until the abandoned "
                                 "worker, and with it the spin, had ended",
        recovery_wall_s=again.wall_seconds, captured=t["captured"],
        recapture_s=(caps[0]["warmup_s"] + caps[0]["capture_s"] + caps[0]["instantiate_s"])
        if caps else None,
    )
    log(json.dumps({"phase": "supervision_hang", **out["hang"]}))
    del again

    # (c) a real sticky error, in a child process
    t0 = time.monotonic()
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--sticky-child"],
                           capture_output=True, text=True, timeout=600, cwd=ROOT)
    child_wall = time.monotonic() - t0
    check(child.returncode == 0, f"the sticky-error child failed ({child.returncode}): "
                                 f"{child.stderr[-3000:]}")
    lines = child.stdout.strip().splitlines()
    check(len(lines) == 1, f"the child printed {len(lines)} lines: {child.stdout[-2000:]}")
    cr = json.loads(lines[0])
    check(cr["first"]["degraded"] is False, f"the child's first optimize was degraded: {cr}")
    check(cr["sticky"]["raised"] == "DeviceDegradedError" and cr["sticky"]["reason"] == "device_lost",
          f"the device-side assert was not DEVICE_LOST: {cr}")
    check(cr["sticky"]["retries"] == 0 and cr["sticky"]["failure_counts"]["transient"] == 0,
          f"the sticky error was retried: {cr}")
    check(cr["second"]["raised"] == "BreakerOpenError" and cr["second"]["reason"] == "breaker-open"
          and cr["second"]["engine_calls"] == 0, f"the second optimize touched the card: {cr}")
    check(cr["second"]["probe_failures"] >= 1, f"no probe failed in the dead context: {cr}")
    out["sticky"] = dict(child_wall_s=child_wall, **cr)
    log(json.dumps({"phase": "supervision_sticky_child", **out["sticky"]}))

    # (d) phase 16's 32 what-ifs, supervised
    dims = (NORTH_STAR_SPEC["num_racks"], NORTH_STAR_SPEC["num_brokers"], NORTH_STAR_SPEC["num_topics"])
    scenarios = scenario_batch(32, 0, *dims)
    shape = plan_shape(state, scenarios + scenario_batch(12, 32, *dims))
    base = pad_state(state, shape) if shape != state.shape else state
    states = [apply_scenario(base, sc, shape=shape) for sc in scenarios]
    sup2 = DeviceSupervisor(op_timeout_s=120.0, max_retries=0, breaker_failure_threshold=1,
                            probe_interval_s=0.0, device="cuda")
    ev = ScenarioEvaluator(max_scenarios=32, supervisor=sup2)
    want_obj, want_viol = SCENARIO_SCORES["16"]
    walls, device_ms = [], []
    for label in ("healthy", "after_oom"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with dispatch_meter() as m:
            obj, viol, degraded = ev.evaluate_states(states)
        walls.append(time.monotonic() - t0)
        batch = dict(ev.last_batch)
        device_ms.append(batch["device_ms"])
        check(not degraded and batch["degraded"] is False, f"the supervised batch is degraded ({label})")
        check(m.counts == {"scenario.batch": 1, "scenario.sync": 1},
              f"the supervised batch made other dispatches than a launch and a sync: {m.counts}")
        check(batch["graph_launches"] == 1 and batch["blocking_syncs"] == 1 and batch["steps"] == 32,
              f"the supervised batch was not one launch and one sync: {batch}")
        check(np.array_equal(obj, want_obj) and np.array_equal(viol, want_viol),
              f"the supervised batch's scores are not phase 16's ({label})")
        if label == "healthy":
            with faults.device_fault(real_oom, ops=("scenario.batch-eval",),
                                     schedule=faults.first(1)) as fl:
                _, oom_wall = refused(lambda: ev.evaluate_states(states), FailureClass.OOM)
            check(fl.fired == {"scenario.batch-eval": 1}, f"the batch's OOM did not fire: {fl.fired}")
            check(sup2.breaker.state is BreakerState.OPEN, "the breaker is not open after the OOM")
    out["scenarios"] = dict(
        n=32, supervised_wall_s=walls[0], device_ms=device_ms, dispatches=m.counts,
        identical_to_phase16=True, failure_to_error_s=oom_wall, after_recovery_wall_s=walls[1],
        probes=sup2.num_probes,
    )
    log(json.dumps({"phase": "supervision_scenarios", **out["scenarios"]}))
    del states, base, ev, opt
    torch.cuda.empty_cache()
    return out


def loopback(h: int) -> str:
    """Host h's loopback address, 127.0.0.1 upward: the fake Kafka cluster
    binds each broker's listener on its host's address (phase 25)."""
    return f"127.0.{h // 254}.{h % 254 + 1}"


def partition_keys(host: dict, P: int):
    """Partition p's topic name ("topic-<t>") and number (its rank among
    its topic's partitions), and the partitions in (topic, number) order,
    the order a Kafka cluster's Metadata reports them in."""
    import numpy as np

    v = host["replica_valid"]
    part_topic = np.zeros(P, np.int64)
    part_topic[host["replica_partition"][v]] = host["replica_topic"][v]
    by_topic = np.lexsort((np.arange(P), part_topic))
    first = np.searchsorted(part_topic[by_topic], part_topic[by_topic])
    part_num = np.empty(P, np.int64)
    part_num[by_topic] = np.arange(P) - first
    names = [f"topic-{t:03d}" for t in range(int(part_topic.max()) + 1)]
    return [names[t] for t in part_topic.tolist()], part_num, by_topic


def monitor_topology(host: dict, shape):
    """The ClusterTopology of a fixture's host arrays, as a metadata
    provider would report it: broker b on rack "r<rack>" and the loopback
    address of its host; partition p of topic t as ("topic-<t>", its rank
    among t's partitions), its replicas' brokers in position order, its
    leader the leader replica's broker, the partitions in (topic, number)
    order.  Also f32[P, 4] the leader load of each partition, in topology
    order."""
    import numpy as np

    from cruise_control_tpu_torch.monitor.topology import BrokerNode, ClusterTopology, PartitionInfo

    v = host["replica_valid"]
    rp = host["replica_partition"][v]
    rb, lead = host["replica_broker"][v], host["replica_is_leader"][v]
    P = shape.P
    order = np.lexsort((host["replica_pos"][v], rp))
    counts = np.bincount(rp, minlength=P)
    groups = np.split(rb[order], np.cumsum(counts)[:-1])
    leader = np.full(P, -1, np.int64)
    leader[rp[lead]] = rb[lead]
    ll = np.zeros((P, 4), np.float32)
    ll[rp[lead]] = host["replica_load_leader"][v][lead]
    names, part_num, by_topic = partition_keys(host, P)
    parts = tuple(
        PartitionInfo(names[p], int(part_num[p]), leader=int(leader[p]), replicas=tuple(groups[p].tolist()))
        for p in by_topic.tolist()
    )
    brokers = tuple(
        BrokerNode(b, rack=f"r{r}", host=loopback(h), alive=bool(a))
        for b, (r, h, a) in enumerate(zip(host["broker_rack"].tolist(), host["broker_host"].tolist(),
                                          host["broker_alive"].tolist()))
    )
    return ClusterTopology(brokers=brokers, partitions=parts), ll[by_topic]


def monitor_records(topo, ll, time_ms: int) -> list:
    """One reporting round of every broker, from the partitions' leader
    loads: BROKER_CPU_UTIL (the CPU of the partitions it leads),
    TOPIC_BYTES_IN / TOPIC_BYTES_OUT of each topic it leads, and
    PARTITION_SIZE (the disk load) of each partition it leads."""
    import numpy as np

    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.reporter.metrics import BrokerMetric, MetricType, PartitionMetric, TopicMetric

    cols = topo.columns()
    leader = np.fromiter((p.leader for p in topo.partitions), np.int64, count=len(topo.partitions))
    B = len(topo.brokers)
    cpu = np.zeros(B)
    np.add.at(cpu, leader, ll[:, Resource.CPU].astype(np.float64))
    pair = leader * len(cols.topic_names) + cols.part_topic
    keys, inv = np.unique(pair, return_inverse=True)
    tb_in, tb_out = np.zeros(keys.size), np.zeros(keys.size)
    np.add.at(tb_in, inv, ll[:, Resource.NW_IN].astype(np.float64))
    np.add.at(tb_out, inv, ll[:, Resource.NW_OUT].astype(np.float64))
    names = cols.topic_names
    T = len(names)
    recs = [BrokerMetric(MetricType.BROKER_CPU_UTIL, time_ms, b, float(c)) for b, c in enumerate(cpu.tolist())]
    for k, i, o in zip(keys.tolist(), tb_in.tolist(), tb_out.tolist()):
        b, t = divmod(k, T)
        recs.append(TopicMetric(MetricType.TOPIC_BYTES_IN, time_ms, b, i, topic=names[t]))
        recs.append(TopicMetric(MetricType.TOPIC_BYTES_OUT, time_ms, b, o, topic=names[t]))
    for p, d in zip(topo.partitions, ll[:, Resource.DISK].tolist()):
        recs.append(PartitionMetric(MetricType.PARTITION_SIZE, time_ms, p.leader, d, topic=p.topic,
                                    partition=p.partition))
    return recs


def aggregator_state(agg, by_entity: bool = False) -> dict:
    """What an aggregator holds of its current window: its window indices,
    generation, entities (in row order) and groups, and its rows'
    accumulators, latest timestamps and counts in the window's slot
    (copies).  `by_entity` orders the rows by entity and leaves out the
    row order and the generation, for an aggregator that interned the same
    entities in another order."""
    import numpy as np

    with agg._lock:
        ents = list(agg._entity_rows)
        rows = np.fromiter(agg._entity_rows.values(), np.int64, count=len(ents))
        if by_entity:
            order = sorted(range(len(ents)), key=lambda i: (ents[i].topic, ents[i].partition))
            ents, rows = [ents[i] for i in order], rows[order]
        slot = agg._slot(agg._current_window)
        out = dict(current=agg._current_window, oldest=agg._oldest_window, entities=ents,
                   groups=dict(agg._entity_group), acc=agg._acc[rows, slot].copy(),
                   latest=agg._latest_ts[rows, slot].copy(), counts=agg._counts[rows, slot].copy())
        if not by_entity:
            out["generation"] = agg._generation
        return out


def same_aggregator_state(a: dict, b: dict) -> list:
    """The keys of two aggregator_state()s that differ (arrays bit for bit)."""
    import numpy as np

    return [k for k in a if not (np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                                 if isinstance(a[k], np.ndarray) else a[k] == b[k])]


def check_monitor(state, cfg) -> dict:
    """Phase 23: the monitor on the card, at the north star's width.  (a)
    The north-star fixture's topology and leader loads as a monitored
    cluster (capacities its broker capacity).  (b) One window over the
    wire: every broker's records serialized by MetricSerde into a
    transport, framed and decoded by the native C++ path, turned into
    partition samples by CruiseControlMetricsReporterSampler and added to
    the aggregator (the C++ path must have run).  (c) The other windows
    with those samples, through add_samples_columnar; the window in
    progress at x1.1 on every 7th partition.  (d) cluster_model() on the
    card: every tensor on CUDA, every field byte for byte the same
    monitor's build on the CPU, validate passes.  (e) GoalOptimizer
    .optimize on it with SEARCH: every hard goal met.  (f) The window
    roll: the next window's samples complete the x1.1 window; the host
    stages of the controller's delta (history_snapshot,
    extract_window_delta, the partitions' replica rows through
    partition_replica_table, follower_loads) timed, the changed set
    exactly the x1.1 partitions, then one optimize_streaming_cycle on a
    LiveState of (d)'s model: one blocking sync, no capture, the two
    counted dispatches."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch import kernels, native
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.engine import partition_replica_table
    from cruise_control_tpu_torch.analyzer.goals import HARD_GOAL_NAMES
    from cruise_control_tpu_torch.analyzer.proposals import fetch_before_host
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter
    from cruise_control_tpu_torch.convert import to_numpy
    from cruise_control_tpu_torch.models import builder
    from cruise_control_tpu_torch.models.state import STATE_FIELDS, validate
    from cruise_control_tpu_torch.models.whatif import LiveState
    from cruise_control_tpu_torch.monitor import (
        KAFKA_METRIC_DEF, FixedCapacityResolver, LoadMonitor, ModelCompletenessRequirements,
        StaticMetadataProvider, WindowedMetricSampleAggregator,
    )
    from cruise_control_tpu_torch.monitor.delta import extract_window_delta
    from cruise_control_tpu_torch.monitor.reporter_sampler import CruiseControlMetricsReporterSampler
    from cruise_control_tpu_torch.native import batch_deserialize, frame_records
    from cruise_control_tpu_torch.reporter import InMemoryTransport, MetricSerde

    dev = state.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    W, window_ms = MONITOR_WINDOWS, MONITOR_WINDOW_MS
    mid = lambda w: w * window_ms + window_ms // 2  # noqa: E731
    out: dict = {"phase": "monitor"}
    t_phase = time.monotonic()
    # (a) the monitored cluster
    t0 = time.monotonic()
    keys = ("replica_valid", "replica_partition", "replica_topic", "replica_pos", "replica_broker",
            "replica_is_leader", "replica_load_leader", "broker_rack", "broker_host", "broker_alive")
    host = {k: getattr(state, k).cpu().numpy() for k in keys}
    topo, ll = monitor_topology(host, state.shape)
    cols = topo.columns()
    out["topology"] = dict(seconds=time.monotonic() - t0, brokers=len(topo.brokers),
                           racks=len({b.rack for b in topo.brokers}), topics=len(cols.topic_names),
                           partitions=len(topo.partitions), replicas=topo.num_replicas)
    check(topo.num_replicas == int(host["replica_valid"].sum()), "the topology lost replicas")
    agg = WindowedMetricSampleAggregator(W, window_ms, 1, KAFKA_METRIC_DEF)

    # (b) one window over the wire
    t0 = time.monotonic()
    recs = monitor_records(topo, ll, mid(0))
    t_records = time.monotonic() - t0
    t0 = time.monotonic()
    payloads = [MetricSerde.serialize(r) for r in recs]
    t_serialize = time.monotonic() - t0
    t0 = time.monotonic()
    framed = frame_records(payloads)
    t_frame = time.monotonic() - t0
    t0 = time.monotonic()
    batch = batch_deserialize(framed)
    t_decode = time.monotonic() - t0
    check(len(batch) == len(recs), "the native decoder lost records")
    transport = InMemoryTransport()
    for p in payloads:
        transport.send(p)
    sampler = CruiseControlMetricsReporterSampler(transport, lambda: topo)
    check(native.native_available(), "the native serde did not build")
    calls = native.native_calls()
    t0 = time.monotonic()
    res = sampler.get_samples([], 0, window_ms - 1)
    t_sampler = time.monotonic() - t0
    check(native.native_calls() == calls + 1, "the sampler did not decode its batch on the C++ path")
    samples = res.partition_samples
    ents = [s.entity for s in samples]
    check(len(ents) == len(topo.partitions) and len(set(ents)) == len(ents),
          f"the sampler gave {len(ents)} partition samples for {len(topo.partitions)} partitions")
    vals = np.stack([s.values for s in samples])
    t0 = time.monotonic()
    check(agg.add_samples_columnar(ents, samples[0].time_ms, vals), "the wire window was refused")
    t_add = time.monotonic() - t0
    wire_s = t_serialize + t_frame + t_sampler + t_add
    wire_state = aggregator_state(agg)
    out["wire"] = dict(records=len(recs), bytes=len(framed), build_records_s=t_records,
                       serialize_s=t_serialize, frame_s=t_frame, native_decode_s=t_decode,
                       native_decode_records_per_s=len(recs) / t_decode,
                       sampler_s=t_sampler, aggregator_add_s=t_add, seconds=wire_s,
                       records_per_s=len(recs) / wire_s, native_available=True,
                       native_calls=native.native_calls() - calls)

    # (c) the other windows; the one in progress at x1.1 on every 7th
    # partition (topology order)
    row = {(e.topic, e.partition): i for i, e in enumerate(ents)}
    topo_rows = np.fromiter((row[(int(t), int(p))] for t, p in zip(cols.part_topic, cols.part_num)),
                            np.int64, count=len(ents))
    hot = np.zeros(len(ents), bool)
    hot[topo_rows[::7]] = True
    v_hot = vals.copy()
    v_hot[hot] *= np.float32(1.1)
    per_window = []
    for w in range(1, W + 1):
        t0 = time.monotonic()
        check(agg.add_samples_columnar(ents, mid(w), v_hot if w == W else vals), f"window {w} refused")
        per_window.append(time.monotonic() - t0)
    out["columnar_windows_s"] = per_window

    # (d) cluster_model on the card, and on the CPU from the same monitor
    metadata = StaticMetadataProvider(topo)
    capacity = FixedCapacityResolver(list(NORTH_STAR_SPEC["broker_capacity"]))
    req = ModelCompletenessRequirements(min_required_num_windows=W)
    spans: dict = {}
    orig_build, orig_aggregate = builder.build_state_columnar, agg.aggregate

    def timed_build(*a, **kw):
        t0 = time.monotonic()
        r = orig_build(*a, **kw)
        sync()
        spans["build_s"] = time.monotonic() - t0
        return r

    def timed_aggregate(*a, **kw):
        t0 = time.monotonic()
        r = orig_aggregate(*a, **kw)
        spans["aggregate_s"] = time.monotonic() - t0
        return r

    models = {}
    builder.build_state_columnar, agg.aggregate = timed_build, timed_aggregate
    try:
        # the card's monitor names no device: it builds on the current
        # CUDA device by default
        for name, kw in (("card", {} if cuda else {"device": dev}), ("cpu", {"device": "cpu"})):
            mon = LoadMonitor(metadata, capacity, agg, **kw)
            sync()
            t0 = time.monotonic()
            st = mon.cluster_model(req)
            sync()
            wall = time.monotonic() - t0
            models[name] = (mon, st)
            out[f"cluster_model_{name}"] = dict(
                seconds=wall, aggregate_s=spans["aggregate_s"], build_s=spans["build_s"],
                join_s=wall - spans["aggregate_s"] - spans["build_s"])
    finally:
        builder.build_state_columnar = orig_build
        del agg.aggregate
    monitor, model = models["card"]
    off = [f for f in STATE_FIELDS if getattr(model, f).device != torch.device(dev)]
    check(not off, f"cluster_model left fields off {dev}: {off}")
    # copies: the window roll below rewrites the model's loads in place
    got = {f: a.copy() for f, a in to_numpy(model).items()}
    want = to_numpy(models["cpu"][1])
    differ = [f for f in STATE_FIELDS if got[f].dtype != want[f].dtype or got[f].tobytes() != want[f].tobytes()]
    check(model.shape == models["cpu"][1].shape and not differ,
          f"the card's model differs from the CPU build: {differ}")
    check(validate(model) == [], "the monitored model fails validate")
    s = model.shape
    out["model"] = dict(brokers=s.B, partitions=s.P, replicas=s.R, topics=s.num_topics,
                        racks=s.num_racks, on=str(dev), card_equals_cpu=True, validate=True)
    del models

    # (e) optimize on it
    live = LiveState(model)
    opt = GoalOptimizer(config=cfg, device=dev)
    sync()
    kernels.reset_launches()
    t0 = time.monotonic()
    res_e = opt.optimize(live.state)
    sync()
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    hard = {n: float(v) for n, v in zip(res_e.goal_names, res_e.violations_after) if n in HARD_GOAL_NAMES}
    timing = next(h for h in res_e.history if h.get("timing"))
    out["optimize"] = dict(wall_s=wall, proposals=len(res_e.proposals), captured=timing["captured"],
                           objective=[res_e.objective_before, res_e.objective_after],
                           hard_goals_max=max(hard.values()), launches=launches)
    check(all(v <= 1e-6 for v in hard.values()), f"hard goals violated on the monitored model: {hard}")
    if cuda:
        missing = [k for k in PATH_KERNELS if launches[k] == 0]
        check(not missing, f"kernels never launched on the monitored model's optimize: {missing}")

    # (f) the window roll into the streaming cycle
    stages: dict = {}

    def stage(name, fn):
        t0 = time.monotonic()
        r = fn()
        stages[name] = time.monotonic() - t0
        return r

    prev = agg.history_snapshot()
    check(agg.add_samples_columnar(ents, mid(W + 1), v_hot), "the roll's window was refused")
    cur = stage("history_snapshot_s", agg.history_snapshot)
    delta = stage("extract_window_delta_s", lambda: extract_window_delta(prev, cur, KAFKA_METRIC_DEF))
    got_hot = {(e.topic, e.partition) for e, c in zip(delta.entities, delta.changed) if c}
    want_hot = {(ents[i].topic, ents[i].partition) for i in np.nonzero(hot)[0]}
    check(got_hot == want_hot and not delta.requires_reflatten and not delta.stale,
          f"the delta changed {len(got_hot)} partitions, the x1.1 window {len(want_hot)}")
    # the reflatten's tables (streaming.py _reflatten), then the window's
    # rows (streaming.py _delta_rows)
    part_rows = stage("partition_replica_table_s", lambda: partition_replica_table(live.state))

    def lookup():
        pid = {key: i for i, key in enumerate(monitor.last_catalog.partitions)}
        first_seen: dict = {}
        for p in topo.partitions:
            first_seen.setdefault(p.topic, len(first_seen))
        return {(first_seen[p.topic], int(p.partition)): pid[(p.topic, int(p.partition))]
                for p in topo.partitions}

    part_lookup = stage("partition_lookup_s", lookup)
    before_host = stage("fetch_before_host_s", lambda: fetch_before_host(live.state))

    def delta_rows():
        changed = delta.changed
        ll_c = delta.loads[changed]
        pids = np.fromiter((part_lookup[(int(e.topic), int(e.partition))]
                            for e, c in zip(delta.entities, changed) if c), np.int64)
        rows_p = part_rows[pids]
        valid = rows_p < s.R
        return rows_p[valid].astype(np.int32), ll_c, valid.sum(1)

    rows, ll_c, per_part = stage("delta_rows_s", delta_rows)
    fl_c = stage("follower_loads_s", lambda: monitor.follower_loads(ll_c))
    ll_rows = np.repeat(ll_c, per_part, axis=0)
    fl_rows = np.repeat(fl_c, per_part, axis=0)
    warm = tuple(getattr(res_e.state_after, f) for f in PLACEMENT)
    sync()
    kernels.reset_launches()
    t0 = time.monotonic()
    with dispatch_meter() as m:
        cyc = opt.optimize_streaming_cycle(live.state, rows=rows, leader_loads=ll_rows,
                                           follower_loads=fl_rows, initial_placement=warm,
                                           before_host=before_host)
    sync()
    stages["optimize_streaming_cycle_s"] = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    check(cyc is not None, "no cached engine for the monitored model's cycle")
    res_f, (n_ll, n_fl) = cyc
    live.adopt_loads(n_ll, n_fl)
    t = next(h for h in res_f.history if h.get("timing"))
    host_stages = ("history_snapshot_s", "extract_window_delta_s", "delta_rows_s", "follower_loads_s")
    out["roll"] = dict(
        **stages, window_host_s=sum(stages[k] for k in host_stages), changed_partitions=len(got_hot),
        rows=int(rows.size), blocking_syncs=t["blocking_syncs"], captured=t["captured"],
        dispatches=dict(m.counts), fused_cycle=bool(t.get("fused_cycle")), device_s=t["device_s"],
        host_extract_s=t["host_extract_s"], proposals=len(res_f.proposals), launches=launches)
    check(t.get("fused_cycle") and t["blocking_syncs"] == 1 and t["captured"] == []
          and dict(m.counts) == {"engine.cycle": 1, "engine.extract": 1},
          f"the monitored window's cycle broke its contract: {out['roll']}")
    hard = [n for n, v in zip(res_f.goal_names, res_f.violations_after) if n in HARD_GOAL_NAMES and v > 1e-6]
    check(not hard, f"hard goals violated after the monitored window's cycle: {hard}")
    scattered = live.state.replica_load_leader[torch.from_numpy(rows).to(dev).long()].cpu().numpy()
    check(np.array_equal(scattered, ll_rows), "the cycle did not scatter the window's loads")
    if cuda:
        check(launches["scatter_loads"] == 1, f"the cycle launched scatter_loads {launches['scatter_loads']} times")
        missing = [k for k in PATH_KERNELS if launches[k] == 0]
        check(not missing, f"kernels never launched by the monitored window's cycle: {missing}")
    out["seconds"] = time.monotonic() - t_phase
    log(json.dumps(out))
    for engine in opt._engines.values():
        engine.release()
    # phases 24 and 25 go on from this monitored cluster
    return out, dict(metadata=metadata, monitor=monitor, aggregator=agg, capacity=capacity,
                     requirements=req, device=dev, topology=topo, payloads=payloads,
                     wire_state=wire_state, entities=ents, values=vals, hot_values=v_hot,
                     model=got, hot=hot, topology_rows=topo_rows)


class RecordingChain:
    """A goal chain that keeps the violations of its last evaluation (the
    tensor, on the state's device; reading it is the caller's sync)."""

    def __init__(self, chain):
        self.chain = chain
        self.violations = None

    def evaluate(self, state, *a, **kw):
        out = self.chain.evaluate(state, *a, **kw)
        self.violations = out[1]
        return out

    @property
    def weights(self):
        return self.chain.weights

    def names(self):
        return self.chain.names()

    def hard_mask(self):
        return self.chain.hard_mask()


def count_syncs(fn, cuda: bool):
    """fn() under PyTorch's sync debug mode ("warn") on the card: its
    result and the synchronizing CUDA operations it made, each with its
    line, thread and the Python frames above it."""
    import traceback
    import warnings

    import torch

    syncs: list = []

    def noted(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            frames = traceback.extract_stack()[-9:-1]
            syncs.append(dict(at=f"{Path(filename).name}:{lineno}", thread=threading.current_thread().name,
                              stack=[f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in frames]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = noted
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    return out, syncs


@contextlib.contextmanager
def executor_spans(admin, executor, journal):
    """Time an execution's parts: the planner's drains (its class's methods,
    the planner being made inside the execution), the admin's submissions,
    ticks and reads (each topology read's wall apart), the per-tick
    topology snapshot
    (`Executor._partitions_by_key`) and the journal's appends and fsyncs.
    Also counts the reassignments the ticks landed."""
    from cruise_control_tpu_torch.executor import ExecutionTaskPlanner

    spans: dict = {"landed": 0, "topology_walls": []}
    undo = []

    def wrap(owner, name, key, on_class=False):
        if not hasattr(owner, name):
            return  # not this admin's (a real cluster's admin has no tick)
        orig = getattr(owner, name)
        # an instance attribute set before (a spy) comes back on exit
        prev = vars(owner).get(name) if not on_class else orig

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                r = orig(*a, **kw)
            finally:
                wall = time.perf_counter() - t0
                spans[key] = spans.get(key, 0.0) + wall
                spans[key + "_calls"] = spans.get(key + "_calls", 0) + 1
                if name == "topology":
                    spans["topology_walls"].append(wall)
            if name == "tick":
                spans["landed"] += len(r)
            return r

        setattr(owner, name, timed)
        undo.append((owner, name, prev))

    for name in ("get_inter_broker_replica_movement_tasks", "get_intra_broker_replica_movement_tasks",
                 "get_leadership_movement_tasks"):
        wrap(ExecutionTaskPlanner, name, "drain_s", on_class=True)
    for name in ("reassign_partitions", "elect_leaders", "set_replication_throttle", "clear_replication_throttle"):
        wrap(admin, name, "admin_submit_s")
    wrap(admin, "tick", "admin_tick_s")
    for name in ("in_progress_reassignments", "in_progress_logdir_moves", "topology"):
        wrap(admin, name, "admin_read_s")
    wrap(executor, "_partitions_by_key", "snapshot_s")
    wrap(journal, "append", "journal_s")
    wrap(journal, "_fsync_locked", "fsync_s")
    try:
        yield spans
    finally:
        for owner, name, orig in reversed(undo):
            if orig is not None:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)


def check_executor(cfg, mon: dict) -> dict:
    """Phase 24: the self-healing loop at the north star's width, from phase
    23's monitored cluster.  (a) 1% of the brokers die (2,574-2,599, as
    bench.py's config_5 picks them).  (b) AnomalyDetector.run_once with a
    BrokerFailureDetector (its failure times in a temporary file) and a
    GoalViolationDetector on the monitor's model built on the card, under
    a SelfHealingNotifier that fixes broker failures at once: the broker
    failure's record FIX_STARTED; the detection one sync (counted with
    PyTorch's sync debug mode) and its violations the CPU evaluation of the
    same monitor's CPU model (the same violated set; values within rtol
    1e-5, atol 1e-6, the detector's own tolerance).  (c) The fix, in the
    action: cluster_model on the card, GoalOptimizer.optimize with SEARCH,
    then Executor(SimulatedClusterAdmin(link 1e12 B/s), the monitor's
    catalog, an ExecutionJournal at fsync batch 1) with the dead brokers
    removed and a replication throttle.  (d) No task dead, no replica on a
    dead broker, every proposal's partition with its replica set and leader,
    the topology's generation grown by one per landed reassignment and one
    per election, the journal finished, and the goal-violation detector on
    the card over a model rebuilt from the executed topology with no hard
    goal violated.  (e) Every RECOVERY_STRIDE-th proposal of the fix (a cut
    of depth since PR 19: the whole fix executes in (d)) from the topology
    before the fix, a fresh admin and journal, crashed
    (testing/faults.process_crash) a third of the way through; a fresh
    Executor over the journal enters RECOVERING and
    resume_recovered_execution runs to the end: no reassignment submitted
    twice, no throttle left, (d)'s final replica sets and leaders on those
    proposals' partitions and the topology before the fix elsewhere.  (f) Walls: the detection, the model build and
    optimize, the execution split into its parts, the replay and resume.
    Every proposal of the fix executes: the topology starts from the
    fixture's placement, which is not rack-aware, so only the whole
    proposal meets the hard goals."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.goals import HARD_GOAL_NAMES
    from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN
    from cruise_control_tpu_torch.detector import (
        AnomalyDetector, AnomalyType, BrokerFailureDetector, GoalViolationDetector, SelfHealingNotifier,
    )
    from cruise_control_tpu_torch.executor import (
        ExecutionJournal, ExecutionOptions, Executor, ExecutorState, SimulatedClusterAdmin,
    )
    from cruise_control_tpu_torch.monitor import LoadMonitor
    from cruise_control_tpu_torch.testing import faults

    metadata, monitor, req, dev = mon["metadata"], mon["monitor"], mon["requirements"], mon["device"]
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out: dict = {"phase": "executor"}
    t_phase = time.monotonic()
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-executor-"))
    try:
        # (a) 1% of the brokers die
        topo0 = metadata.topology()
        B = len(topo0.brokers)
        n_dead = max(2, B // 100)
        dead = set(range(B - n_dead, B))
        metadata.set_topology(dataclasses.replace(topo0, brokers=tuple(
            dataclasses.replace(b, alive=b.broker_id not in dead) for b in topo0.brokers)))
        out["dead"] = dict(brokers=[min(dead), max(dead)], count=n_dead,
                           replicas=sum(1 for p in topo0.partitions for r in p.replicas if r in dead))

        # (b) detect
        sync()
        t0 = time.monotonic()
        model_b = monitor.cluster_model(req)
        sync()
        out["detect_model_s"] = time.monotonic() - t0
        chain = RecordingChain(DEFAULT_CHAIN)
        gvd = GoalViolationDetector(lambda: model_b, chain)
        seen: dict = {}

        def goal_violations():
            t0 = time.monotonic()
            try:
                found, syncs = count_syncs(gvd.detect, cuda)
            except BaseException as e:
                seen["goal_error"] = repr(e)
                raise
            seen["goal_s"] = time.monotonic() - t0
            seen["goal_syncs"], seen["goal_sync_sites"] = len(syncs), syncs
            seen["goal"] = found
            return found

        bfd = BrokerFailureDetector(metadata.topology, persist_path=str(tmp / "failed-brokers.json"))

        def broker_failures():
            t0 = time.monotonic()
            found = bfd.detect()
            seen["broker_s"] = time.monotonic() - t0
            seen["broker"] = found
            return found

        fix: dict = {}

        class Actions:
            is_busy = False

            def remove_brokers(self, broker_ids, reason):
                try:
                    fix.update(run_fix(set(broker_ids)))
                except BaseException as e:
                    fix["error"] = repr(e)
                    raise
                return True

        notifier = SelfHealingNotifier(self_healing={AnomalyType.BROKER_FAILURE: True},
                                       broker_failure_alert_threshold_ms=0,
                                       broker_failure_self_healing_threshold_ms=0)
        detector = AnomalyDetector(notifier, Actions())
        detector.register_detector(broker_failures)
        detector.register_detector(goal_violations)

        # the CPU evaluation of the same monitor's CPU model
        cpu_model = LoadMonitor(metadata, mon["capacity"], mon["aggregator"], device="cpu").cluster_model(req)
        cpu_chain = RecordingChain(DEFAULT_CHAIN)
        cpu_found = GoalViolationDetector(lambda: cpu_model, cpu_chain).detect()

        options = ExecutionOptions(replication_throttle_bytes_per_s=1e12)

        def execute(proposals, journal_dir: Path, uuid: str, admin, *, crash_at=None):
            journal = ExecutionJournal(str(journal_dir / "execution-journal.jsonl"))
            ex = Executor(admin, catalog=monitor.last_catalog, journal=journal)
            t0 = time.monotonic()
            with executor_spans(admin, ex, journal) as spans:
                if crash_at is None:
                    res = ex.execute_proposals(proposals, options, uuid=uuid, removed_brokers=dead)
                else:
                    res = None
                    with faults.process_crash(admin, schedule=faults.FaultSchedule(calls=[crash_at])):
                        try:
                            ex.execute_proposals(proposals, options, uuid=uuid, removed_brokers=dead)
                        except faults.SimulatedProcessCrash:
                            spans["crashed"] = True
            spans["wall_s"] = time.monotonic() - t0
            spans["records"], spans["fsyncs"] = journal.records_written, journal.fsyncs
            return res, journal, spans

        def run_fix(broker_ids: set) -> dict:
            check(broker_ids == dead, f"the fix was asked to remove {sorted(broker_ids)}")
            r: dict = {}
            sync()
            t0 = time.monotonic()
            model = monitor.cluster_model(req)
            sync()
            r["model_s"] = time.monotonic() - t0
            opt = GoalOptimizer(config=cfg, device=dev)
            t0 = time.monotonic()
            res = opt.optimize(model)
            sync()
            r["optimize_s"] = time.monotonic() - t0
            for engine in opt._engines.values():
                engine.release()
            hard = {n: float(v) for n, v in zip(res.goal_names, res.violations_after) if n in HARD_GOAL_NAMES}
            check(all(v <= 1e-6 for v in hard.values()), f"the fix's proposal violates hard goals: {hard}")
            proposals = list(res.proposals)
            r["proposals"] = len(proposals)
            r["evacuations"] = sum(1 for p in proposals if dead & set(p.old_replicas))
            r["executed_proposals"] = proposals
            r["before"] = metadata.topology()
            admin = SimulatedClusterAdmin(metadata, link_rate_bytes_per_s=1e12)
            gen0 = metadata.topology().generation
            result, journal, spans = execute(proposals, tmp / "fix", "phase-24-fix", admin)
            r.update(result=result, journal=journal, spans=spans, admin=admin, generation_before=gen0)
            return r

        # run the detection round; the fix runs in its action
        t0 = time.monotonic()
        records = detector.run_once()
        round_s = time.monotonic() - t0
        check("goal_error" not in seen and "goal" in seen and "broker" in seen,
              f"a detector failed: {seen.get('goal_error')}")
        check("error" not in fix and "result" in fix, f"the fix failed: {fix.get('error')}")
        status = {r.anomaly.anomaly_type.name: r.status for r in records}
        check(status.get("BROKER_FAILURE") == "FIX_STARTED", f"the broker failure was not fixed: {status}")
        check(seen["broker"] is not None and set(seen["broker"].failed_brokers) == dead,
              "the broker failure detector did not report the dead brokers")
        found = seen["goal"]
        got_v = chain.violations.double().cpu().numpy()
        want_v = cpu_chain.violations.double().numpy()
        lists = lambda v: None if v is None else (v.fixable_violations, v.unfixable_violations)  # noqa: E731
        check(lists(found) == lists(cpu_found),
              f"the card's detection {lists(found)} differs from the CPU's {lists(cpu_found)}")
        check(bool(np.all(np.abs(got_v - want_v) <= 1e-5 * np.abs(want_v) + 1e-6)),
              f"the card's violations differ from the CPU's: {got_v.tolist()} vs {want_v.tolist()}")
        check(found is not None and "RackAwareGoal" not in (found.unfixable_violations or []),
              "the dead brokers raised no goal violation")
        # the same detection again on the same model: the first call's
        # one-time costs apart
        t0 = time.monotonic()
        check(lists(gvd.detect()) == lists(found), "a repeated detection differs")
        repeat_s = time.monotonic() - t0
        out["detect"] = dict(
            seconds=seen["goal_s"] + seen["broker_s"], round_with_fix_s=round_s, goal_violation_s=seen["goal_s"],
            goal_violation_repeat_s=repeat_s, goal_violation_syncs=seen["goal_syncs"],
            sync_sites=seen["goal_sync_sites"],
            broker_failure_s=seen["broker_s"], statuses=status, fixable=found.fixable_violations,
            unfixable=found.unfixable_violations, violations_max_abs_diff=float(np.abs(got_v - want_v).max()))
        out["fix"] = dict(model_s=fix["model_s"], optimize_s=fix["optimize_s"], proposals=fix["proposals"],
                          evacuations=fix["evacuations"])
        fix["journal"].close()

        # (d) the fix landed
        result, admin, spans = fix["result"], fix["admin"], fix["spans"]
        proposals = fix["executed_proposals"]
        after = metadata.topology()
        on_dead = sum(1 for p in after.partitions for r in p.replicas if r in dead)
        by_key = {(p.topic, p.partition): p for p in after.partitions}
        catalog = monitor.last_catalog
        wrong = 0
        for p in proposals:
            got = by_key[catalog.partition_key(p.partition)]
            if set(got.replicas) != set(p.new_replicas) or (p.new_leader >= 0 and got.leader != p.new_leader):
                wrong += 1
        grown = after.generation - fix["generation_before"]
        want_grown = spans["landed"] + admin.election_calls
        unfinished = fix["journal"].unfinished_execution()
        tasks = result.completed + result.aborted + result.dead
        exec_spans = {k: v for k, v in spans.items() if k.endswith("_s") or k.endswith("_calls")}
        out["execute"] = dict(
            ticks=result.ticks, tasks=tasks, completed=result.completed, dead=result.dead,
            aborted=result.aborted, tasks_per_s=tasks / spans["wall_s"], landed=spans["landed"],
            elections=admin.election_calls, generation_grown=grown, journal_records=spans["records"],
            journal_fsyncs=spans["fsyncs"], **exec_spans,
            other_s=spans["wall_s"] - sum(spans.get(k, 0.0) for k in (
                "drain_s", "admin_submit_s", "admin_tick_s", "admin_read_s", "snapshot_s", "journal_s")))
        check(result.dead == 0 and result.aborted == 0 and not result.stopped,
              f"the fix's execution: {result.completed} completed, {result.aborted} aborted, {result.dead} dead")
        check(on_dead == 0, f"{on_dead} replicas left on dead brokers")
        check(wrong == 0, f"{wrong} partitions differ from their proposals")
        check(grown == want_grown, f"the generation grew by {grown}, the reference's count is {want_grown}")
        check(unfinished is None, "the journal holds an unfinished execution")
        sync()
        t0 = time.monotonic()
        healed = GoalViolationDetector(lambda: monitor.cluster_model(req), DEFAULT_CHAIN).detect()
        sync()
        hard_left = [] if healed is None else [
            n for n in healed.fixable_violations + healed.unfixable_violations if n in HARD_GOAL_NAMES]
        out["after"] = dict(detect_s=time.monotonic() - t0, replicas_on_dead=on_dead,
                            violated=None if healed is None else healed.fixable_violations + healed.unfixable_violations)
        check(not hard_left, f"hard goals violated after the fix: {hard_left}")
        final = {(p.topic, p.partition): (p.leader, p.replicas) for p in after.partitions}

        # (e) crash and recover, on every RECOVERY_STRIDE-th proposal
        subset = proposals[::RECOVERY_STRIDE]
        sub_keys = {catalog.partition_key(p.partition) for p in subset}
        want = {(p.topic, p.partition): final[(p.topic, p.partition)] if (p.topic, p.partition) in sub_keys
                else (p.leader, p.replicas) for p in fix["before"].partitions}
        metadata.set_topology(fix["before"])
        admin2 = SimulatedClusterAdmin(metadata, link_rate_bytes_per_s=1e12)
        submitted: dict = {}
        submit = admin2.reassign_partitions

        def counted(specs):
            for sp in specs:
                submitted[(sp.topic, sp.partition)] = submitted.get((sp.topic, sp.partition), 0) + 1
            return submit(specs)

        admin2.reassign_partitions = counted
        crash_at = max(1, result.ticks // (3 * RECOVERY_STRIDE))
        _, _, crash_spans = execute(subset, tmp / "crash", "phase-24-crash", admin2, crash_at=crash_at)
        check(crash_spans.get("crashed"), "the execution did not crash")
        check(admin2.throttle_rate is not None, "the crashed execution left no throttle to sweep")
        t0 = time.monotonic()
        journal3 = ExecutionJournal(str(tmp / "crash" / "execution-journal.jsonl"))
        ex3 = Executor(admin2, catalog=catalog, journal=journal3)
        replay_s = time.monotonic() - t0
        check(ex3.state == ExecutorState.RECOVERING, f"the fresh executor is {ex3.state}")
        recovery = ex3.recovery_info()
        check(admin2.throttle_rate is None, "the recovery did not sweep the throttle")
        t0 = time.monotonic()
        res3 = ex3.resume_recovered_execution()
        resume_s = time.monotonic() - t0
        check(res3 is not None and res3.dead == 0 and res3.aborted == 0,
              f"the resumed execution: {res3}")
        twice = sum(1 for n in submitted.values() if n > 1)
        check(twice == 0, f"{twice} reassignments were submitted twice")
        check(admin2.throttle_rate is None and not admin2.throttled_topics, "a throttle was left set")
        check(journal3.unfinished_execution() is None, "the recovered journal holds an unfinished execution")
        again = {(p.topic, p.partition): (p.leader, p.replicas) for p in metadata.topology().partitions}
        journal3.close()
        check(again == want, "the recovered execution's topology differs from the fix's")
        out["recover"] = dict(proposals=len(subset), crash_tick=crash_at, crashed_after_s=crash_spans["wall_s"],
                              crashed_records=crash_spans["records"], replay_s=replay_s, resume_s=resume_s,
                              submissions=sum(submitted.values()), submitted_twice=twice,
                              completed=res3.completed, ticks=res3.ticks, recovery=recovery,
                              same_topology=True)
        if cuda:
            check(seen["goal_syncs"] == 1,
                  f"the detection synced {seen['goal_syncs']} times: {seen['goal_sync_sites']}")
    except BaseException as e:
        out["failed"] = repr(e)
        log(json.dumps(out, default=str))
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.monotonic() - t_phase
    log(json.dumps(out))
    return out


#: phases 24 and 25 crash and recover every RECOVERY_STRIDE-th proposal of
#: the fix, not the whole fix (a cut of depth: (d) executes the whole fix),
#: and crash that execution a third of the way through its ticks
RECOVERY_STRIDE = 4


#: phase 25's execution runs at configuration 3's width (a cut of the north
#: star: the executor reads one wire topology a progress tick, one Metadata
#: and one DescribeLogDirs a broker, 20.4 s at the north star against 4.4 s
#: at this width on a CPU host)
KAFKA_EXEC_SPEC = {**MID_SPEC, "disks_per_broker": 4}
#: the service's own topics, left out of the model (the reporter sampler's
#: default exclusion)
OWN_TOPICS = r"^__(KafkaCruiseControl|CruiseControlMetrics).*"


def fake_spec(topo, logdirs=None) -> tuple:
    """FakeKafkaCluster's (brokers, topics) of a ClusterTopology: each
    broker on its rack and at its host's address, with `logdirs(b)`."""
    brokers = {b.broker_id: {"rack": b.rack, "host": b.host, **({"logdirs": logdirs(b.broker_id)} if logdirs else {})}
               for b in topo.brokers}
    topics: dict = {}
    for p in topo.partitions:
        topics.setdefault(p.topic, []).append({"partition": p.partition, "leader": p.leader,
                                               "replicas": list(p.replicas)})
    return brokers, topics


def raise_fd_limit(need: int) -> dict:
    """Raise this process's open-file soft limit to its hard limit; fail if
    the hard limit cannot hold `need` descriptors."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard != resource.RLIM_INFINITY and hard < need:
        check(False, f"the open-file hard limit {hard} cannot hold the ~{need} descriptors the fake "
                     "cluster's listeners and connections need")
    target = hard if hard != resource.RLIM_INFINITY else max(soft, need)
    resource.setrlimit(resource.RLIMIT_NOFILE, (target, hard))
    return dict(soft_before=soft, hard=hard, soft=target, need=need)


def kafka_window(client, payloads: list, topology, agg, window_ms: int) -> tuple:
    """One window of metric records over the wire: `payloads` produced
    through KafkaMetricsTransport into a one-partition
    __CruiseControlMetrics (one partition keeps the records' order), then
    CruiseControlMetricsReporterSampler fetches them through
    KafkaMetricsConsumer.poll_framed and decodes them on the native path;
    the window's partition samples go into `agg` as phase 23 adds its wire
    window.  Returns the walls and the sampling result."""
    import numpy as np

    from cruise_control_tpu_torch import native
    from cruise_control_tpu_torch.kafka.transport import DEFAULT_TOPIC, KafkaMetricsConsumer, KafkaMetricsTransport
    from cruise_control_tpu_torch.monitor.reporter_sampler import CruiseControlMetricsReporterSampler

    codes = client.create_topics([(DEFAULT_TOPIC, 1, 1)])
    check(codes == {DEFAULT_TOPIC: 0}, f"creating {DEFAULT_TOPIC}: {codes}")
    transport = KafkaMetricsTransport(client, flush_every=10_000)
    t0 = time.monotonic()
    for p in payloads:
        transport.send(p)
    transport.flush()
    produce_s = time.monotonic() - t0
    consumer = KafkaMetricsConsumer(client)
    fetched: dict = {}
    poll = consumer.poll_framed

    def timed_poll(*a, **kw):
        t0 = time.monotonic()
        framed = poll(*a, **kw)
        fetched.update(fetch_s=time.monotonic() - t0, framed_bytes=len(framed))
        return framed

    consumer.poll_framed = timed_poll
    sampler = CruiseControlMetricsReporterSampler(consumer, lambda: topology)
    calls = native.native_calls()
    t0 = time.monotonic()
    res = sampler.get_samples([], 0, window_ms - 1)
    sampler_s = time.monotonic() - t0
    check(native.native_calls() == calls + 1, "the sampler did not decode the fetched batch on the C++ path")
    samples = res.partition_samples
    t0 = time.monotonic()
    check(agg.add_samples_columnar([s.entity for s in samples], samples[0].time_ms,
                                   np.stack([s.values for s in samples])), "the wire window was refused")
    add_s = time.monotonic() - t0
    n = len(payloads)
    decode_s = sampler_s - fetched["fetch_s"]
    return dict(records=n, produce_s=produce_s, produce_records_per_s=n / produce_s,
                fetch_s=fetched["fetch_s"], fetch_records_per_s=n / fetched["fetch_s"],
                decode_s=decode_s, decode_records_per_s=n / decode_s, framed_bytes=fetched["framed_bytes"],
                aggregator_add_s=add_s, samples=len(samples)), res


def on_cpu_result(res):
    """The OptimizerResult with every tensor a decision record reads (the
    state before, the stats after) moved to the CPU."""
    from cruise_control_tpu_torch.models.state import STATE_FIELDS
    from cruise_control_tpu_torch.models.stats import ClusterStats

    st, stats = res.state_before, res.stats_after
    return dataclasses.replace(
        res, state_before=dataclasses.replace(st, **{f: getattr(st, f).cpu() for f in STATE_FIELDS}),
        stats_after=ClusterStats(**{f.name: getattr(stats, f.name).cpu() for f in dataclasses.fields(stats)}))


def check_kafka(cfg, mon: dict) -> dict:
    """Phase 25: the real-cluster loop over the Kafka wire protocol, from
    phase 23's monitored cluster, against the port's in-process fake
    cluster (testing/fake_kafka.py: one selector thread serves every
    broker's listener, each on its host's loopback address, and every
    connection, with real sockets and frames).  (a) The north
    star's data plane: the fake built from phase 23's topology (2,600
    brokers, 200,000 partitions) and started, with the open-file limit
    raised; one Metadata round trip, KafkaMetadataProvider.refresh and one
    KafkaClusterAdmin.topology timed; the provider's topology phase 23's.
    (b) Phase 23's wire window (its records) produced into
    __CruiseControlMetrics and fetched back into a fresh aggregator: its
    window bit for bit phase 23's; with phase 23's other windows,
    LoadMonitor.cluster_model on the card over the provider (the service's
    own topics left out) byte for byte phase 23's model.  (c) The window's
    samples stored by KafkaSampleStore and loaded by a fresh store over a
    fresh client into a fresh aggregator (MetricFetcherManager
    .load_samples, the warm restart): the window entity by entity bit for
    bit.  (d) At configuration 3's width (KAFKA_EXEC_SPEC, seed 42; each
    replica on its replica_disk's logdir), the samples over the wire, a
    model on the card; brokers 495-499 killed; BrokerFailureDetector over
    the provider reports exactly them; GoalViolationDetector on the card
    with one sync; the fix's optimize on the card; Executor over
    KafkaClusterAdmin (the fake completes a reassignment on the next poll,
    a logdir copy takes one DescribeLogDirs poll; the journal at fsync
    batch 1, the default caps): no dead task, no replica on a dead broker
    in the wire topology, each partition its proposal's replicas, no
    throttle config left (DescribeConfigs), no hard goal violated on a model
    rebuilt from the wire.  (e) Every RECOVERY_STRIDE-th proposal of the
    fix (a cut of depth since PR 19: the whole fix executes in (d)) on a
    fresh fake, the executor abandoned on the progress tick a third of the
    way through, a fresh Executor over a fresh client and the journal
    replays and reconciles against ListPartitionReassignments, then
    resumes: no partition's reassignment submitted twice over the wire,
    (d)'s final topology on those proposals' partitions, the fresh fake's
    elsewhere.  (f) A
    DecisionLedger around (d): the fix's decision record from the card's
    result in one transfer (one sync), equal to the record of the result
    copied to the CPU but for wallSeconds; the outcome joined when (d)
    ends; a calibration record from the monitor's model of the executed
    topology (its stats on the card); replay() one decision, one outcome,
    one calibration, no pending outcome."""
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer import ledger as ledger_mod
    from cruise_control_tpu_torch.analyzer.goals import HARD_GOAL_NAMES
    from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN
    from cruise_control_tpu_torch.convert import to_numpy
    from cruise_control_tpu_torch.detector import BrokerFailureDetector, GoalViolationDetector
    from cruise_control_tpu_torch.executor import ExecutionJournal, ExecutionOptions, Executor, ExecutorState
    from cruise_control_tpu_torch.kafka import KafkaAdminClient, KafkaClusterAdmin, KafkaMetadataProvider
    from cruise_control_tpu_torch.kafka.sample_store import KafkaSampleStore
    from cruise_control_tpu_torch.models.state import STATE_FIELDS
    from cruise_control_tpu_torch.models.stats import compute_stats
    from cruise_control_tpu_torch.monitor import (
        KAFKA_METRIC_DEF, FixedCapacityResolver, LoadMonitor, MetricFetcherManager, WindowedMetricSampleAggregator,
    )
    from cruise_control_tpu_torch.reporter import MetricSerde
    from cruise_control_tpu_torch.testing import faults
    from cruise_control_tpu_torch.testing.fake_kafka import FakeKafkaCluster
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    dev, req, topo0 = mon["device"], mon["requirements"], mon["topology"]
    cuda = torch.device(dev).type == "cuda"
    card = {} if cuda else {"device": dev}
    W, window_ms = MONITOR_WINDOWS, MONITOR_WINDOW_MS
    mid = lambda w: w * window_ms + window_ms // 2  # noqa: E731
    own = re.compile(OWN_TOPICS)
    keep = lambda name: not own.match(name)  # noqa: E731

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def rows(topo):
        return ([dataclasses.astuple(b) for b in topo.brokers], [dataclasses.astuple(p) for p in topo.partitions])

    def other_windows(agg, ents, vals, hot):
        for w in range(1, W + 1):
            check(agg.add_samples_columnar(ents, mid(w), hot if w == W else vals), f"window {w} refused")

    out: dict = {"phase": "kafka"}
    t_phase = time.monotonic()
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-kafka-"))
    clusters, clients = [], []

    def start(brokers, topics):
        cluster = FakeKafkaCluster(brokers, topics).start()
        clusters.append(cluster)
        return cluster

    def connect(cluster):
        client = KafkaAdminClient(cluster.bootstrap(), timeout_s=300.0)
        clients.append(client)
        return client

    try:
        # (a) the north star's data plane
        B = len(topo0.brokers)
        out["fd_limit"] = raise_fd_limit(3 * B + 1024)
        t0 = time.monotonic()
        brokers, topics = fake_spec(topo0)
        fake = FakeKafkaCluster(brokers, topics)
        build_s = time.monotonic() - t0
        t0 = time.monotonic()
        fake.start()
        clusters.append(fake)
        start_s = time.monotonic() - t0
        client = connect(fake)
        t0 = time.monotonic()
        md = client.metadata()
        metadata_s = time.monotonic() - t0
        provider = KafkaMetadataProvider(client)
        t0 = time.monotonic()
        wire_topo = provider.refresh()
        refresh_s = time.monotonic() - t0
        t0 = time.monotonic()
        admin_topo = KafkaClusterAdmin(client).topology()
        topology_s = time.monotonic() - t0
        check(rows(wire_topo) == rows(topo0), "the wire topology differs from phase 23's")
        check(all(b.logdirs == ("/data/d0",) for b in admin_topo.brokers)
              and rows(admin_topo)[1] == rows(wire_topo)[1], "the admin's topology differs from the provider's")
        out["data_plane"] = dict(brokers=B, partitions=len(wire_topo.partitions), replicas=wire_topo.num_replicas,
                                 racks=len({b.rack for b in wire_topo.brokers}), build_s=build_s, start_s=start_s,
                                 metadata_s=metadata_s, metadata_partitions=sum(len(t["partitions"])
                                                                                for t in md["topics"]),
                                 provider_refresh_s=refresh_s, admin_topology_s=topology_s,
                                 requests=dict(fake.requests), threads=threading.active_count(),
                                 equals_phase_23=True)
        log(json.dumps({"phase": "kafka_data_plane", **out["data_plane"], "fd_limit": out["fd_limit"]}))

        # (b) phase 23's wire window over the wire, then its model
        agg = WindowedMetricSampleAggregator(W, window_ms, 1, KAFKA_METRIC_DEF)
        out["stream"], res_b = kafka_window(client, mon["payloads"], wire_topo, agg, window_ms)
        differ = same_aggregator_state(aggregator_state(agg), mon["wire_state"])
        check(not differ, f"the window fetched over the wire differs from phase 23's: {differ}")
        window_b = aggregator_state(agg, by_entity=True)
        other_windows(agg, mon["entities"], mon["values"], mon["hot_values"])
        monitor = LoadMonitor(provider, mon["capacity"], agg, topic_filter=keep, **card)
        sync()
        t0 = time.monotonic()
        model = monitor.cluster_model(req)
        sync()
        model_s = time.monotonic() - t0
        got = to_numpy(model)
        differ = [f for f in STATE_FIELDS
                  if got[f].dtype != mon["model"][f].dtype or got[f].tobytes() != mon["model"][f].tobytes()]
        check(str(model.device) == str(torch.device(dev)) and not differ,
              f"the model over the wire differs from phase 23's: {differ}")
        out["stream"].update(window_equals_phase_23=True, cluster_model_s=model_s, model_equals_phase_23=True)
        log(json.dumps({"phase": "kafka_stream", **out["stream"]}))
        del model, got, monitor

        # (c) the warm restart through the sample store
        names = wire_topo.columns().topic_names
        ids = {n: i for i, n in enumerate(names)}
        store = KafkaSampleStore(client, topic_name_fn=names.__getitem__, topic_id_fn=ids.__getitem__)
        t0 = time.monotonic()
        store.store(res_b)
        store_s = time.monotonic() - t0
        client2 = connect(fake)
        fresh = WindowedMetricSampleAggregator(W, window_ms, 1, KAFKA_METRIC_DEF)
        loader = MetricFetcherManager(None, fresh, None,
                                      sample_store=KafkaSampleStore(client2, topic_name_fn=names.__getitem__,
                                                                    topic_id_fn=ids.__getitem__))
        t0 = time.monotonic()
        loaded = loader.load_samples()
        load_s = time.monotonic() - t0
        # the groups apart: the warm restart adds samples one by one with
        # their topic as group, a columnar window adds none
        loaded_state = aggregator_state(fresh, by_entity=True)
        groups = loaded_state.pop("groups")
        check(groups == {e: e.group for e in loaded_state["entities"]}, "the warm restart's groups")
        differ = same_aggregator_state(loaded_state, {k: v for k, v in window_b.items() if k != "groups"})
        check(loaded == len(res_b.partition_samples) and not differ,
              f"the warm restart loaded {loaded} samples of {len(res_b.partition_samples)}; differs: {differ}")
        out["warm_restart"] = dict(samples=loaded, store_s=store_s, load_s=load_s, wall_s=store_s + load_s,
                                   window_equals=True)
        log(json.dumps({"phase": "kafka_warm_restart", **out["warm_restart"]}))
        out["north_star_requests"] = dict(fake.requests)
        for c in clients:
            c.close()
        fake.stop()
        clients.clear()
        clusters.clear()
        del fake, agg, fresh, res_b, store

        # (d) detect, fix and execute at configuration 3's width
        t0 = time.monotonic()
        state3 = random_cluster_fast(RandomClusterSpec(**KAFKA_EXEC_SPEC), seed=42, device=dev)
        keys = ("replica_valid", "replica_partition", "replica_topic", "replica_pos", "replica_broker",
                "replica_is_leader", "replica_load_leader", "replica_disk", "broker_rack", "broker_host",
                "broker_alive")
        host3 = {k: getattr(state3, k).cpu().numpy() for k in keys}
        topo3, ll3 = monitor_topology(host3, state3.shape)
        D = state3.shape.max_disks_per_broker
        logdirs = lambda b: [f"/data/{b}/d{k}" for k in range(D)]  # noqa: E731
        brokers3, topics3 = fake_spec(topo3, logdirs)
        pnames, pnums, _ = partition_keys(host3, state3.shape.P)
        v = host3["replica_valid"]
        placed = list(zip(host3["replica_partition"][v].tolist(), host3["replica_broker"][v].tolist(),
                          host3["replica_disk"][v].tolist()))

        def place(cluster):
            # each replica on its replica_disk's logdir
            for p, b, d in placed:
                key = (pnames[p], int(pnums[p]))
                dirs = cluster.placement[b]
                dirs[f"/data/{b}/d0"].discard(key)
                dirs[f"/data/{b}/d{d}"].add(key)

        payloads3 = [MetricSerde.serialize(r) for r in monitor_records(topo3, ll3, mid(0))]
        n_dead = max(2, len(topo3.brokers) // 100)
        dead = set(range(len(topo3.brokers) - n_dead, len(topo3.brokers)))
        fixture_s = time.monotonic() - t0
        del state3
        fake3 = start(brokers3, topics3)
        place(fake3)
        fake3.auto_complete_after(1)
        fake3.intra_copy_polls = 1
        client3 = connect(fake3)
        provider3 = KafkaMetadataProvider(client3)
        topo3_wire = provider3.refresh()
        check(rows(topo3_wire) == rows(topo3), "configuration 3's wire topology differs from its fixture's")
        agg3 = WindowedMetricSampleAggregator(W, window_ms, 1, KAFKA_METRIC_DEF)
        stream3, res3 = kafka_window(client3, payloads3, topo3_wire, agg3, window_ms)
        samples3 = res3.partition_samples
        ents3, vals3 = [s.entity for s in samples3], np.stack([s.values for s in samples3])
        other_windows(agg3, ents3, vals3, vals3)
        capacity3 = FixedCapacityResolver(list(KAFKA_EXEC_SPEC["broker_capacity"]))
        monitor3 = LoadMonitor(provider3, capacity3, agg3, topic_filter=keep, **card)
        for b in sorted(dead):
            fake3.kill_broker(b)
        t0 = time.monotonic()
        found_b = BrokerFailureDetector(provider3.refresh, persist_path=str(tmp / "failed-brokers.json")).detect()
        broker_s = time.monotonic() - t0
        check(found_b is not None and set(found_b.failed_brokers) == dead,
              f"the broker failure detector reported {None if found_b is None else sorted(found_b.failed_brokers)}")
        sync()
        t0 = time.monotonic()
        model3 = monitor3.cluster_model(req)
        sync()
        model3_s = time.monotonic() - t0
        catalog = monitor3.last_catalog
        gvd = GoalViolationDetector(lambda: model3, DEFAULT_CHAIN)
        t0 = time.monotonic()
        found_g, syncs = count_syncs(gvd.detect, cuda)
        goal_s = time.monotonic() - t0
        check(found_g is not None, "the dead brokers raised no goal violation")
        opt = GoalOptimizer(config=cfg, device=dev)
        t0 = time.monotonic()
        res = opt.optimize(model3)
        sync()
        optimize_s = time.monotonic() - t0
        for engine in opt._engines.values():
            engine.release()
        hard = {n: float(v) for n, v in zip(res.goal_names, res.violations_after) if n in HARD_GOAL_NAMES}
        check(all(v <= 1e-6 for v in hard.values()), f"the fix's proposal violates hard goals: {hard}")
        proposals = list(res.proposals)
        out["detect_fix"] = dict(
            brokers=len(topo3.brokers), partitions=len(topo3.partitions), logdirs_per_broker=D,
            cut="configuration 3's width, not the north star's: the executor reads one wire topology a "
                "progress tick (one Metadata and one DescribeLogDirs a broker), 20.4 s at the north star "
                "against 4.4 s at this width on a CPU host",
            fixture_s=fixture_s, stream=stream3, dead=sorted(dead), broker_failure_s=broker_s,
            model_s=model3_s, goal_violation_s=goal_s, goal_violation_syncs=len(syncs), sync_sites=syncs,
            fixable=found_g.fixable_violations, unfixable=found_g.unfixable_violations,
            optimize_s=optimize_s, proposals=len(proposals),
            evacuations=sum(1 for p in proposals if dead & set(p.old_replicas)))
        log(json.dumps({"phase": "kafka_detect_fix", **out["detect_fix"]}))
        if cuda:
            check(len(syncs) == 1, f"the detection synced {len(syncs)} times: {syncs}")

        # (f) the decision record, from the card's result in one transfer
        ledger = ledger_mod.DecisionLedger(str(tmp / "ledger" / "decision-ledger.jsonl"))
        transfers = ledger_mod.TRANSFERS
        record, rec_syncs = count_syncs(lambda: ledger_mod.build_decision_record(
            res, source="self-healing", trace_id="phase-25", cluster_id="configuration-3",
            work_class="URGENT"), cuda)
        rec_transfers = ledger_mod.TRANSFERS - transfers
        host_record = ledger_mod.build_decision_record(
            on_cpu_result(res), source="self-healing", trace_id="phase-25", cluster_id="configuration-3",
            work_class="URGENT")
        check(ledger_mod.TRANSFERS - transfers == rec_transfers, "the CPU copy's record made a transfer")
        strip = lambda r: json.dumps({k: v for k, v in r.items() if k != "wallSeconds"})  # noqa: E731
        check(strip(record) == strip(host_record), "the card's decision record differs from the CPU copy's")
        if cuda:
            check(rec_transfers == 1 and len(rec_syncs) == 1,
                  f"the decision record made {rec_transfers} transfers and {len(rec_syncs)} syncs: {rec_syncs}")
        did = ledger.record_decision(record)
        ledger.begin_outcome(did)

        def execute(cluster, journal_path, crash_at=None, proposals=proposals) -> tuple:
            client_x = connect(cluster)
            admin = KafkaClusterAdmin(client_x)
            journal = ExecutionJournal(str(journal_path))
            # the topic names too: with a catalog alone the executor names a
            # throttled topic by its dense id (ROADMAP queue 3)
            ex = Executor(admin, catalog=catalog, topic_names=catalog.topic_names_by_id(), journal=journal)
            options = ExecutionOptions(replication_throttle_bytes_per_s=1e12, progress_check_interval_s=0.0)
            t0 = time.monotonic()
            with executor_spans(admin, ex, journal) as spans:
                if crash_at is None:
                    result = ex.execute_proposals(proposals, options, uuid="phase-25-fix", removed_brokers=dead)
                else:
                    result = None
                    with faults.process_crash(admin, on="in_progress_reassignments",
                                              schedule=faults.FaultSchedule(calls=[crash_at])):
                        try:
                            ex.execute_proposals(proposals, options, uuid="phase-25-fix", removed_brokers=dead)
                        except faults.SimulatedProcessCrash:
                            spans["crashed"] = True
            spans["wall_s"] = time.monotonic() - t0
            spans["records"], spans["fsyncs"] = journal.records_written, journal.fsyncs
            journal.close()
            return result, spans
        requests0 = dict(fake3.requests)
        result, spans = execute(fake3, tmp / "fix" / "execution-journal.jsonl")
        requests = {k: n - requests0.get(k, 0) for k, n in fake3.requests.items() if n > requests0.get(k, 0)}
        after = provider3.refresh()
        by_key = {(p.topic, p.partition): p for p in after.partitions}
        on_dead = sum(1 for p in after.partitions for r in p.replicas if r in dead)
        wrong = sum(1 for p in proposals if set(by_key[catalog.partition_key(p.partition)].replicas)
                    != set(p.new_replicas))
        live = sorted(b.broker_id for b in after.brokers if b.alive)
        left = {}
        for b in live:
            left.update({k: c for k, c in client3.describe_configs([(4, str(b))], node_id=b).items() if c})
        left.update({k: c for k, c in client3.describe_configs(
            [(2, t) for t in sorted({p.topic for p in after.partitions})]).items() if c})
        # and on no resource DescribeConfigs of the cluster's own cannot see
        left.update({k: c for k, c in fake3.configs.items() if c})
        tasks = result.completed + result.aborted + result.dead
        walls = spans["topology_walls"]
        admin_s = sum(spans.get(k, 0.0) for k in ("admin_submit_s", "admin_read_s"))
        out["execute"] = dict(
            ticks=result.ticks, tasks=tasks, completed=result.completed, dead=result.dead, aborted=result.aborted,
            tasks_per_s=tasks / spans["wall_s"], wall_s=spans["wall_s"], wire_admin_s=admin_s,
            topology_s=sum(walls), topology_walls=walls, drain_s=spans.get("drain_s", 0.0),
            journal_s=spans.get("journal_s", 0.0), fsync_s=spans.get("fsync_s", 0.0),
            journal_records=spans["records"], journal_fsyncs=spans["fsyncs"],
            snapshot_s=spans.get("snapshot_s", 0.0),
            other_s=spans["wall_s"] - admin_s - sum(spans.get(k, 0.0) for k in ("drain_s", "journal_s",
                                                                                 "snapshot_s")),
            requests=requests, replicas_on_dead=on_dead, partitions_not_their_proposal=wrong,
            throttle_configs_left=len(left))
        check(result.dead == 0 and result.aborted == 0 and not result.stopped,
              f"the fix's execution: {result.completed} completed, {result.aborted} aborted, {result.dead} dead")
        check(on_dead == 0, f"{on_dead} replicas left on dead brokers")
        check(wrong == 0, f"{wrong} partitions differ from their proposals")
        check(not left, f"throttle configs left: {left}")
        sync()
        t0 = time.monotonic()
        model_after = monitor3.cluster_model(req)
        healed = GoalViolationDetector(lambda: model_after, DEFAULT_CHAIN).detect()
        sync()
        hard_left = [] if healed is None else [
            n for n in healed.fixable_violations + healed.unfixable_violations if n in HARD_GOAL_NAMES]
        out["execute"].update(after_detect_s=time.monotonic() - t0, violated_after=None if healed is None else
                              healed.fixable_violations + healed.unfixable_violations)
        check(not hard_left, f"hard goals violated after the fix: {hard_left}")
        log(json.dumps({"phase": "kafka_execute", **out["execute"]}))
        final = {t: {p: (d["leader"], tuple(d["replicas"])) for p, d in parts.items()}
                 for t, parts in fake3.topics.items() if keep(t)}

        # (f) the outcome and a calibration record
        ledger.record_outcome(did, dict(completed=result.completed, aborted=result.aborted, dead=result.dead,
                                        ticks=result.ticks, wallSeconds=spans["wall_s"]))
        measured = ledger_mod.load_summary(compute_stats(model_after))
        error = ledger_mod.load_summary_error(record["predictedLoad"], measured)
        ledger.record_calibration(did, dict(predictedLoad=record["predictedLoad"], measuredLoad=measured,
                                            error=error))
        kinds = [r["t"] for r in ledger.replay()]
        out["ledger"] = dict(record_transfers=rec_transfers, record_syncs=len(rec_syncs),
                             moves=len(record["moves"]), max_abs_avg_error=error["maxAbsAvgError"],
                             records=kinds, pending=sorted(ledger.pending_outcomes()))
        check(kinds == ["decision", "outcome", "calibration"] and not ledger.pending_outcomes(),
              f"the ledger replays {kinds}, pending {ledger.pending_outcomes()}")
        ledger.close()
        log(json.dumps({"phase": "kafka_ledger", **out["ledger"]}))
        del model3, model_after, res

        # (e) crash and recover every RECOVERY_STRIDE-th proposal, on a
        # fresh fake of the same cluster
        fake_e = start(brokers3, topics3)
        place(fake_e)
        fake_e.auto_complete_after(1)
        fake_e.intra_copy_polls = 1
        for b in sorted(dead):
            fake_e.kill_broker(b)
        subset = proposals[::RECOVERY_STRIDE]
        sub_keys = {catalog.partition_key(p.partition) for p in subset}
        want = {t: {p: final[t][p] if (t, p) in sub_keys else (d["leader"], tuple(d["replicas"]))
                    for p, d in parts.items()}
                for t, parts in fake_e.topics.items() if keep(t)}
        submitted: dict = {}
        landed_again: list = []
        handle = fake_e.handle

        def counted(node_id, api, body):
            if api.name == "AlterPartitionReassignments":
                with fake_e._lock:
                    for t in body["topics"] or []:
                        for p in t["partitions"] or []:
                            key = (t["name"], p["partition_index"])
                            cur = fake_e.topics.get(key[0], {}).get(key[1])
                            if p["replicas"] is None or cur is None:
                                continue
                            if p["replicas"] == cur["replicas"]:
                                # a landed move submitted again (an election's
                                # reorder always changes the list)
                                landed_again.append(key)
                            elif set(p["replicas"]) != set(cur["replicas"]):
                                submitted[key] = submitted.get(key, 0) + 1
            return handle(node_id, api, body)

        fake_e.handle = counted
        crash_at = max(1, result.ticks // (3 * RECOVERY_STRIDE))
        journal_path = tmp / "crash" / "execution-journal.jsonl"
        _, crash_spans = execute(fake_e, journal_path, crash_at=crash_at, proposals=subset)
        check(crash_spans.get("crashed"), "the execution did not crash")
        clients[-1].close()  # the dead process's sockets
        t0 = time.monotonic()
        admin_r = KafkaClusterAdmin(connect(fake_e))
        journal_r = ExecutionJournal(str(journal_path))
        ex_r = Executor(admin_r, catalog=catalog, topic_names=catalog.topic_names_by_id(), journal=journal_r)
        replay_s = time.monotonic() - t0
        check(ex_r.state == ExecutorState.RECOVERING, f"the fresh executor is {ex_r.state}")
        recovery = ex_r.recovery_info()
        t0 = time.monotonic()
        res_r = ex_r.resume_recovered_execution()
        resume_s = time.monotonic() - t0
        journal_r.close()
        check(res_r is not None and res_r.dead == 0 and res_r.aborted == 0, f"the resumed execution: {res_r}")
        twice = sorted(k for k, n in submitted.items() if n > 1) + landed_again
        check(not twice, f"{len(twice)} partitions' reassignments were submitted twice, first {twice[:3]}")
        again = {t: {p: (d["leader"], tuple(d["replicas"])) for p, d in parts.items()}
                 for t, parts in fake_e.topics.items() if keep(t)}
        diff = [(t, p, want[t].get(p), again[t].get(p)) for t in want for p in want[t]
                if again.get(t, {}).get(p) != want[t][p]]
        check(again.keys() == want.keys() and not diff,
              f"the recovered execution's topology differs from the fix's in {len(diff)} partitions: {diff[:5]}")
        left = {k: c for k, c in fake_e.configs.items() if c}
        check(not left, f"throttle configs left: {sorted(left.items())[:3]}")
        out["recover"] = dict(proposals=len(subset), crash_tick=crash_at, crashed_after_s=crash_spans["wall_s"],
                              crashed_records=crash_spans["records"], replay_s=replay_s, resume_s=resume_s,
                              submissions=sum(submitted.values()), submitted_twice=len(twice),
                              completed=res_r.completed, ticks=res_r.ticks, recovery=recovery,
                              same_topology=True)
        log(json.dumps({"phase": "kafka_recover", **out["recover"]}, default=str))
    except BaseException as e:
        out["failed"] = repr(e)
        log(json.dumps(out, default=str))
        raise
    finally:
        for c in clients:
            c.close()
        for cluster in clusters:
            cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.monotonic() - t_phase
    log(json.dumps({k: v for k, v in out.items() if k not in ("detect_fix", "execute")} | dict(
        seconds=out["seconds"]), default=str))
    return out


#: phase 27's service config: phase 4's SEARCH as the service's keys,
#: phase 23's windows, the supervisor on with a breaker that opens at one
#: failure and a 30 s probe interval (the Retry-After of its 503)
SERVICE_PROBE_INTERVAL_S = 30.0


class IdleSampler:
    """The service's metric sampler in phase 27, never asked for samples:
    the phase fills the monitor's windows with phase 23's samples through
    add_samples_columnar."""

    def get_samples(self, *a, **kw):
        raise AssertionError("phase 27 fetches no samples")


def http_call(app, method: str, path: str, headers: dict | None = None, poll: bool = True):
    """(status, body, bytes, headers) of one request; a 202 is polled with
    its User-Task-ID until it answers, unless `poll` is False."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{app.port}{app.prefix}{path}"
    headers = dict(headers or {})
    deadline = time.monotonic() + 600
    while True:
        req = urllib.request.Request(url, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                status, raw, hdrs = r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            raw, hdrs = e.read(), dict(e.headers)
            return e.code, json.loads(raw), len(raw), hdrs
        body = json.loads(raw)
        if status != 202 or not poll or time.monotonic() > deadline:
            return status, body, len(raw), hdrs
        headers["User-Task-ID"] = hdrs["User-Task-ID"]
        time.sleep(0.02)


def check_service(cfg, mon: dict, smi: str) -> dict:
    """Phase 27: the port's REST service on the card, at the north star's
    width, over loopback HTTP.  (a) `build_service(device="cuda")` over phase
    23's topology (2,600 brokers, 200,000 partitions, nothing cut) with a
    SimulatedClusterAdmin (link 1e12 B/s), its capacity resolver, and the
    config keys of phase 4's SEARCH; the monitor's windows filled with
    phase 23's samples through add_samples_columnar (the columnar path:
    `build_simulated_service`'s fetch through a synthetic sampler would
    build a sample object a partition a window); the server on 127.0.0.1,
    an ephemeral port.  (b) GET /proposals cold (the model build, the
    capture and the anneal; every main-path kernel launched, counted from
    0 just before), cached, and with ignore_proposal_cache=true: the
    served result bit for bit `GoalOptimizer.optimize` of the same
    monitor's cluster_model with the same config and seed (placements,
    every proposal, the first 100 as served), every hard goal <= 1e-6.
    (c) /state, /load, /partition_load and /kafka_cluster_state, each wall
    and JSON size; POST /remove_broker?dryrun=true for 1% of the brokers
    (2,574-2,599, phase 5's): the facade's result bit for bit phase 5's
    decommission built the same way on the service's model (the monitored
    model renumbers topics and partitions and is bucket-padded, so phase
    5's own proposals are not this model's), no replica left on them, its
    summary the served one; POST /simulate with four what-ifs.  (e) A
    real device failure: the allocator's OOM on "engine.run" (phase 22's
    injection) under GET /proposals: 503 with failureClass "oom"; /state
    shows the breaker open; the detector records one OPTIMIZER_DEGRADED
    (and none in its next round); the next request 503 "breaker-open"
    with Retry-After 30 and no device call; once the probe is due, 200
    with (b)'s placements.  (f) `cccli proposals` and `cccli state` against
    the server: the served summary.  (d) POST /demote_broker?brokerid=0
    &dryrun=false, polled on /user_tasks until done: every leadership
    move completed, no leader left on broker 0.  (e) and (f) run before
    (d), whose execution changes the cluster.  Every wall is printed with
    the card's name and power limit."""
    import contextlib
    import io
    import shutil
    import tempfile
    import urllib.parse

    import torch

    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.goals import HARD_GOAL_NAMES
    from cruise_control_tpu_torch.client import cccli
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.executor import SimulatedClusterAdmin
    from cruise_control_tpu_torch.monitor import StaticMetadataProvider
    from cruise_control_tpu_torch.service.main import build_service
    from cruise_control_tpu_torch.service.progress import OperationProgress

    dev = torch.device(mon["device"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out: dict = {"phase": "service", "card": smi}
    t_phase = time.monotonic()
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-service-"))
    app = None
    try:
        # (a) the service on the card
        W, window_ms = MONITOR_WINDOWS, MONITOR_WINDOW_MS
        config = CruiseControlConfig({
            "tpu.num.candidates": SEARCH["num_candidates"],
            "tpu.leadership.candidates": SEARCH["leadership_candidates"],
            "tpu.steps.per.round": SEARCH["steps_per_round"],
            "tpu.num.rounds": SEARCH["num_rounds"],
            "analyzer.diagnostics.enabled": False,
            "partition.metrics.window.ms": window_ms,
            "num.partition.metrics.windows": W,
            "min.samples.per.partition.metrics.window": 1,
            "execution.progress.check.interval.ms": 100,
            "webserver.http.address": "127.0.0.1",
            "webserver.http.port": 0,
            "tpu.supervisor.enabled": True,
            "tpu.supervisor.max.retries": 0,
            "tpu.supervisor.breaker.failure.threshold": 1,
            "tpu.supervisor.probe.interval.s": SERVICE_PROBE_INTERVAL_S,
            "tpu.compile.cache.dir": str(tmp / "cache"),
        })
        t0 = time.monotonic()
        metadata = StaticMetadataProvider(mon["topology"])
        admin = SimulatedClusterAdmin(metadata, link_rate_bytes_per_s=1e12)
        app, _fetcher = build_service(config, metadata, admin, IdleSampler(),
                                      capacity_resolver=mon["capacity"], device=dev)
        cc = app.cc
        build_s = time.monotonic() - t0
        check(cc.optimizer.config == cfg, f"the service's config is not phase 4's: {cc.optimizer.config}")
        check(cc.device == dev and cc.monitor.device == dev and cc.scenario_evaluator.device == dev,
              "the service was not built on one device")
        agg = cc.monitor.partition_aggregator
        ents, vals, hot = mon["entities"], mon["values"], mon["hot_values"]
        t0 = time.monotonic()
        for w in range(W + 1):
            check(agg.add_samples_columnar(ents, w * window_ms + window_ms // 2, hot if w == W else vals),
                  f"the service's window {w} was refused")
        fill_s = time.monotonic() - t0
        t0 = time.monotonic()
        app.start()
        out["build"] = dict(build_service_s=build_s, fill_windows_s=fill_s, windows=W + 1,
                            fill="columnar (phase 23 (c))", start_s=time.monotonic() - t0,
                            partitions=len(ents), brokers=len(mon["topology"].brokers))

        # (b) proposals over HTTP
        walls: dict = {}

        def timed(name, method, path, **kw):
            sync()
            t0 = time.monotonic()
            r = http_call(app, method, path, **kw)
            walls[name] = time.monotonic() - t0
            return r

        kernels.reset_launches()
        st, cold, nb, _ = timed("proposals_cold_s", "GET", "/proposals")
        launches = dict(kernels.LAUNCHES)
        check(st == 200, f"cold /proposals answered {st}: {cold}")
        if cuda:
            missing = [k for k in PATH_KERNELS if launches[k] == 0]
            check(not missing, f"kernels never launched by the service's proposal: {missing}")
        st, cached, _, _ = timed("proposals_cached_s", "GET", "/proposals")
        check(st == 200 and cached["wallSeconds"] == cold["wallSeconds"], "the second /proposals was not cached")
        st, fresh, _, _ = timed("proposals_ignore_cache_s", "GET", "/proposals?ignore_proposal_cache=true")
        check(st == 200, f"/proposals?ignore_proposal_cache=true answered {st}")
        served = cc._valid_cache()
        check(served is not None, "no cached proposal after the request")
        model = cc._cluster_model(OperationProgress())
        direct_opt = GoalOptimizer(config=cfg, device=dev)
        t0 = time.monotonic()
        direct = direct_opt.optimize(model)
        sync()
        walls["direct_optimize_s"] = time.monotonic() - t0
        same = {f: bool(torch.equal(getattr(served.state_after, f), getattr(direct.state_after, f)))
                for f in PLACEMENT}
        served_json = [p.to_json() for p in served.proposals]
        direct_json = [p.to_json() for p in direct.proposals]
        check(all(same.values()), f"the service's placements differ from optimize's: {same}")
        check(served_json == direct_json, "the service's proposals differ from optimize's")
        check(fresh["proposals"] == direct_json[:100] and cold["proposals"] == direct_json[:100],
              "the served proposals are not optimize's")
        hard = {n: float(v) for n, v in zip(direct.goal_names, direct.violations_after) if n in HARD_GOAL_NAMES}
        check(all(v <= 1e-6 for v in hard.values()), f"hard goals violated by the served proposal: {hard}")
        check(not set(fresh["violatedGoalsAfter"]) & set(HARD_GOAL_NAMES), "the served summary violates hard goals")
        exact_b = {f: getattr(served.state_after, f).clone() for f in PLACEMENT}
        out["proposals"] = dict(
            proposals=len(direct_json), served=len(cold["proposals"]), bytes=nb,
            objective=[direct.objective_before, direct.objective_after], hard_goals_max=max(hard.values()),
            equal_to_optimize=True, launches=launches,
            engine_cache=dict(hits=cc.optimizer.engine_cache_hits, misses=cc.optimizer.engine_cache_misses),
            service_wall_seconds=[cold["wallSeconds"], fresh["wallSeconds"]])
        del served, direct, served_json, direct_json

        # (c) the read endpoints and the dry runs
        sizes: dict = {}
        for name, path in (("state", "/state"), ("load", "/load"), ("partition_load", "/partition_load"),
                           ("kafka_cluster_state", "/kafka_cluster_state")):
            st, body, nb, _ = timed(f"{name}_s", "GET", path)
            check(st == 200, f"{path} answered {st}: {str(body)[:300]}")
            sizes[name] = nb
        check(len(body["KafkaBrokerState"]) == out["build"]["brokers"], "/kafka_cluster_state lost brokers")
        B = out["build"]["brokers"]
        removed = list(range(B - max(2, B // 100), B))
        results: list = []
        orig_optimize = cc.optimizer.optimize

        def spy(*a, **kw):
            r = orig_optimize(*a, **kw)
            results.append(r)
            return r

        cc.optimizer.optimize = spy
        try:
            st, dec, _, _ = timed("remove_broker_dryrun_s", "POST",
                                  "/remove_broker?dryrun=true&brokerid=" + ",".join(map(str, removed)))
        finally:
            del cc.optimizer.optimize
        check(st == 200 and len(results) == 1, f"/remove_broker answered {st}: {str(dec)[:300]}")
        facade_res = results.pop()
        alive = model.broker_alive.clone()
        alive[removed] = False
        decom = dataclasses.replace(
            model, broker_alive=alive, disk_alive=alive[:, None] & model.disk_alive,
            replica_offline=(model.replica_offline | ~alive[model.replica_broker.long()]) & model.replica_valid)
        t0 = time.monotonic()
        direct_dec = direct_opt.optimize(decom)
        sync()
        walls["direct_decommission_s"] = time.monotonic() - t0
        same = {f: bool(torch.equal(getattr(facade_res.state_after, f), getattr(direct_dec.state_after, f)))
                for f in PLACEMENT}
        check(all(same.values()) and len(facade_res.proposals) == len(direct_dec.proposals),
              f"the service's decommission differs from phase 5's construction: {same}")
        after = direct_dec.state_after
        left = int((after.replica_valid & ~after.broker_alive[after.replica_broker.long()]).sum())
        check(left == 0, f"{left} replicas left on the removed brokers")
        for k in ("numReplicaMovements", "numLeaderMovements", "dataToMoveMB"):
            check(dec[k] == direct_dec.summary()[k], f"the served decommission's {k} is not optimize's")
        scenarios = [{"name": "lose-rack-0", "killRacks": ["r0"]}, {"name": "add-3", "addBrokers": [{"count": 3}]},
                     {"name": "remove-0", "removeBrokers": [0]},
                     {"name": "double-topic-0", "topicLoadFactors": {"topic-000": 2.0}}]
        st, sim, nb, _ = timed("simulate_s", "POST",
                               "/simulate?scenarios=" + urllib.parse.quote(json.dumps(scenarios)))
        check(st == 200 and [x["name"] for x in sim["scenarios"]] == [x["name"] for x in scenarios]
              and not sim["degraded"], f"/simulate answered {st}: {str(sim)[:300]}")
        sizes["simulate"] = nb
        out["reads"] = dict(bytes=sizes, remove_broker=dict(
            brokers=[removed[0], removed[-1]], proposals=len(direct_dec.proposals),
            moves=dec["numReplicaMovements"], equal_to_optimize=True, replicas_left=left),
            simulate=[dict(name=x["name"], objective=x["objective"], brokersAlive=x["brokersAlive"])
                      for x in sim["scenarios"]])
        for engine in direct_opt._engines.values():
            engine.release()
        del facade_res, direct_dec, decom, model, direct_opt, after

        # (e) a real device failure under a request (on the card only: a
        # service on the CPU answers a supervised failure with the flagged
        # greedy proposal, as the JAX package does)
        rec = fresh
        if cuda:
            out["failure"] = check_service_failure(app, exact_b, fresh, timed)

        # (f) the CLI
        cli: dict = {}
        for argv in (["proposals"], ["state", "--substates", "analyzer,executor"]):
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                rc = cccli.main(["-a", f"http://127.0.0.1:{app.port}", "--poll-interval", "0.05", *argv])
            walls[f"cli_{argv[0]}_s"] = time.monotonic() - t0
            check(rc == 0, f"cccli {argv} exited {rc}")
            cli[argv[0]] = json.loads(buf.getvalue())
        check(cli["proposals"]["proposals"] == rec["proposals"]
              and cli["proposals"]["numReplicaMovements"] == rec["numReplicaMovements"],
              "cccli proposals is not the served proposal")
        check(cli["state"]["AnalyzerState"]["supervisor"]["breaker"] == "closed", "cccli state lost the breaker")

        # (d) an executed demotion
        t0 = time.monotonic()
        st, started, _, hdrs = http_call(app, "POST", "/demote_broker?brokerid=0&dryrun=false", poll=False)
        check(st in (200, 202), f"/demote_broker answered {st}: {started}")
        tid = hdrs["User-Task-ID"]
        polls = 0
        while True:
            polls += 1
            st, tasks, _, _ = http_call(app, "GET", "/user_tasks?user_task_ids=" + tid)
            row = [t for t in tasks["userTasks"] if t["UserTaskId"] == tid]
            check(st == 200 and len(row) == 1, f"/user_tasks lost the demotion's task: {tasks}")
            if row[0]["Status"] != "Active":
                break
            check(time.monotonic() - t0 < 300, "the demotion did not finish in 300 s")
            time.sleep(0.1)
        walls["demote_execute_s"] = time.monotonic() - t0
        check(row[0]["Status"] == "Completed", f"the demotion's task ended {row[0]['Status']}")
        st, done, _, _ = http_call(app, "POST", "/demote_broker?brokerid=0&dryrun=false",
                                   headers={"User-Task-ID": tid})
        check(st == 200 and done["execution"]["completed"] == done["numLeaderMovements"] > 0
              and done["execution"]["dead"] == 0, f"the demotion's execution: {done.get('execution')}")
        led = sum(1 for p in admin.topology().partitions if p.leader == 0)
        check(led == 0, f"{led} partitions are still led by the demoted broker 0")
        out["demote"] = dict(leadership_moves=done["numLeaderMovements"], completed=done["execution"]["completed"],
                             polls=polls, leaders_left=led)
    except BaseException as e:
        out["failed"] = repr(e)
        log(json.dumps(out, default=str))
        raise
    finally:
        if app is not None:
            app.stop()
            app.cc.shutdown()
            for engine in app.cc.optimizer._engines.values():
                engine.release()
        shutil.rmtree(tmp, ignore_errors=True)
    out["walls"] = walls
    out["seconds"] = time.monotonic() - t_phase
    out["within_budget_150_s"] = out["seconds"] <= 150.0
    log(json.dumps(out, default=str))
    return out


def check_service_failure(app, exact_b: dict, fresh: dict, timed) -> dict:
    """Phase 27 (e): a real OOM under GET /proposals on the card (module
    docstring); `timed` is the phase's request timer, `exact_b` and
    `fresh` (b)'s placements and served answer."""
    import torch

    from cruise_control_tpu_torch.detector import AnomalyType
    from cruise_control_tpu_torch.testing import faults

    cc = app.cc
    sup = cc.supervisor
    with faults.device_fault(real_oom, schedule=faults.first(1)) as fl:
        st, err, _, _ = timed("oom_request_s", "GET", "/proposals?ignore_proposal_cache=true")
    check(fl.fired == {"engine.run": 1}, f"the OOM did not fire once on engine.run: {fl.fired}")
    check(st == 503 and err.get("failureClass") == "oom", f"the OOM request answered {st}: {err}")
    state_st = cc.state(["analyzer"])["AnalyzerState"]
    check(state_st["degraded"] is True and state_st["supervisor"]["breaker"] == "open",
          f"/state does not show the breaker open: {state_st.get('supervisor')}")
    t0 = time.monotonic()
    kinds = [r.anomaly.anomaly_type for r in cc.anomaly_detector.run_once()]
    round_s = time.monotonic() - t0
    again = [r.anomaly.anomaly_type for r in cc.anomaly_detector.run_once()]
    check(kinds.count(AnomalyType.OPTIMIZER_DEGRADED) == 1 and AnomalyType.OPTIMIZER_DEGRADED not in again,
          f"OPTIMIZER_DEGRADED recorded {kinds.count(AnomalyType.OPTIMIZER_DEGRADED)} then "
          f"{again.count(AnomalyType.OPTIMIZER_DEGRADED)} times")
    with faults.device_fault(real_oom) as fl2:
        st, refused, _, hdrs = timed("breaker_open_request_s", "GET", "/proposals?ignore_proposal_cache=true")
    check(st == 503 and refused.get("failureClass") == "breaker-open" and refused.get("openedBy") == "oom"
          and hdrs.get("Retry-After") == str(int(SERVICE_PROBE_INTERVAL_S)) and not fl2.fired,
          f"the open breaker answered {st} {refused} {hdrs.get('Retry-After')}, device calls {fl2.fired}")
    # the probe's due time brought forward: the phase does not wait the
    # 30 s interval out
    sup.breaker._next_probe_at = 0.0
    st, rec, _, _ = timed("recovered_request_s", "GET", "/proposals?ignore_proposal_cache=true")
    check(st == 200 and not rec["degraded"], f"the recovered request answered {st}: {str(rec)[:300]}")
    recovered = cc._valid_cache()
    check(all(torch.equal(getattr(recovered.state_after, f), exact_b[f]) for f in PLACEMENT)
          and rec["proposals"] == fresh["proposals"], "the recovered proposals are not (b)'s")
    check(sup.breaker.state.value == "closed", "the probe did not close the breaker")
    return dict(error=err["errorMessage"][:200], failure_class=err["failureClass"],
                retry_after=hdrs.get("Retry-After"), probes=sup.num_probes, detector_round_s=round_s,
                anomalies=[k.name for k in kinds], recovered_equal_to_b=True)


#: phase 28's controller: the loop thread's poll interval, the (d) and (e)
#: windows' partitions (200 each, in topology order) and the windows'
#: factors
CONTROLLER_POLL_MS = 50
CONTROLLER_DELTA_PARTITIONS = 200


def controller_window(seq: list, W: int, disk_col: int, mask=None, factor: float = 1.0):
    """The samples of the next window of phase 28's aggregator, which keeps
    `W` complete windows, so that when it completes the loads change only
    on `mask`'s rows (all rows when `mask` is None and `factor` is not 1):
    those rows get the newest window's samples x `factor`; every other row
    gets the samples of the window its completion drops (so each metric's
    mean over the kept windows holds) with the newest window's DISK (the
    reduction's latest value).  `seq` holds every window's samples so far."""
    import numpy as np

    new = seq[-W].copy()
    new[:, disk_col] = seq[-1][:, disk_col]
    if factor != 1.0:
        rows = slice(None) if mask is None else mask
        new[rows] = seq[-1][rows] * np.float32(factor)
    return new


def quantile_bound(hist, q: float):
    """The upper bound of the histogram bucket that holds quantile `q` (the
    exposition's resolution), or None for an empty histogram."""
    if hist is None:
        return None
    cum, _total, n = hist.cumulative()
    if n == 0:
        return None
    for bound, c in cum:
        if c >= q * n:
            return bound
    return float("inf")


def check_controller(cfg, mon: dict, smi: str) -> dict:
    """Phase 28: the streaming controller on the card through the service,
    from phase 23's topology and windows at the north star's width,
    nothing cut.  `build_service(device="cuda")` with phase 27's SEARCH
    keys, `controller.enabled=true` and the prior at its defaults; the
    monitor's windows filled with phase 23's samples, the x1.1 window in
    progress; cycles driven by `run_once()`.  Windows: (a) the initial
    reflatten; (b) phase 23's x1.1 window; (c) an empty window (plan-sized
    to K/8: staged); (d) and (e) 200 partitions x1.2 each (plan-sized to
    K/4: (d) staged with one capture, (e) fused); (f) every partition
    x1.03 (fused); (g) broker 0 dies through the metadata (a reflatten,
    "topology").  Checked after every cycle: every hard goal met, never a
    CPU answer; over (a)-(g) 2 reflattens (initial, topology) and 5 delta
    applies; each fused cycle at most 2 dispatches, one blocking sync, no
    capture and one scatter_loads launch; after each delta window the live
    loads are a fresh cluster_model's, byte for byte on the changed rows
    and within the delta's rtol 1e-6 elsewhere.  After (f), GET /proposals
    serves the controller's last result with no main-path kernel launched.
    (h) A real OOM in a fused cycle run by the loop thread: counted, the
    previous publish still served; (i) the next window reflattens
    ("failed-cycle") and publishes; (j) `start_up()` with the loop at a
    50 ms poll publishes after a window roll on its own and `shutdown()`
    joins it.  A second service in cold mode (warm starts, delta and the
    prior off) publishes a placement byte for byte a direct optimize of a
    freshly built model.  Printed: each stage's walls and the sensors'
    histograms, history_snapshot's wall, the cold cycles, the rounds of
    each cycle, the streaming-publish SLO and a cProfile of one steady
    window's host stages."""
    import cProfile
    import io
    import pstats
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer.goals import HARD_GOAL_NAMES
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.executor import SimulatedClusterAdmin
    from cruise_control_tpu_torch.monitor import KAFKA_METRIC_DEF, StaticMetadataProvider
    from cruise_control_tpu_torch.monitor.delta import extract_window_delta
    from cruise_control_tpu_torch.service.main import build_service
    from cruise_control_tpu_torch.testing import faults

    dev = torch.device(mon["device"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out: dict = {"phase": "controller", "card": smi}
    t_phase = time.monotonic()
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-controller-"))
    W, window_ms = MONITOR_WINDOWS, MONITOR_WINDOW_MS
    ents, vals, hot = mon["entities"], mon["values"], mon["hot_values"]
    disk_col = KAFKA_METRIC_DEF.metric_id("DISK_USAGE")
    base = {
        "tpu.num.candidates": SEARCH["num_candidates"],
        "tpu.leadership.candidates": SEARCH["leadership_candidates"],
        "tpu.steps.per.round": SEARCH["steps_per_round"],
        "tpu.num.rounds": SEARCH["num_rounds"],
        "analyzer.diagnostics.enabled": False,
        "partition.metrics.window.ms": window_ms,
        "num.partition.metrics.windows": W,
        "min.samples.per.partition.metrics.window": 1,
        "execution.progress.check.interval.ms": 100,
        "webserver.http.address": "127.0.0.1",
        "webserver.http.port": 0,
        "tpu.supervisor.enabled": True,
        "tpu.supervisor.max.retries": 0,
        "tpu.supervisor.breaker.failure.threshold": 1,
        "tpu.supervisor.probe.interval.s": SERVICE_PROBE_INTERVAL_S,
        "tpu.prewarm.enabled": False,
        "tpu.compile.cache.dir": str(tmp / "cache"),
        "controller.enabled": True,
        "controller.poll.interval.ms": CONTROLLER_POLL_MS,
    }

    def service(extra: dict):
        metadata = StaticMetadataProvider(mon["topology"])
        admin = SimulatedClusterAdmin(metadata, link_rate_bytes_per_s=1e12)
        app, _ = build_service(CruiseControlConfig({**base, **extra}), metadata, admin, IdleSampler(),
                               capacity_resolver=mon["capacity"], device=dev)
        agg = app.cc.monitor.partition_aggregator
        seq = [vals] * W + [hot]
        for w, v in enumerate(seq):
            check(agg.add_samples_columnar(ents, w * window_ms + window_ms // 2, v),
                  f"the controller service's window {w} was refused")
        return app, metadata, agg, seq

    def hard_violated(res) -> list:
        return [n for n, v in zip(res.goal_names, res.violations_after) if n in HARD_GOAL_NAMES and v > 1e-6]

    app = cold_app = None
    try:
        t0 = time.monotonic()
        app, metadata, agg, seq = service({})
        cc = app.cc
        ctl = cc.controller
        check(ctl is not None and ctl.optimizer.device == dev and cc.monitor.device == dev,
              "the service did not build its controller on the card")
        check(ctl.optimizer.config == cfg, f"the controller's base config is not phase 4's: {ctl.optimizer.config}")
        app.start()
        out["build"] = dict(seconds=time.monotonic() - t0, prior_mix=ctl.prior.mix,
                            plan_sizing=ctl.plan_sizing, fusion=ctl.fusion_enabled)
        # spies: the delta triples, each stage's wall, history_snapshot's wall
        triples, stage_walls, snapshot_walls = [], [], []
        current = ["a"]  # the cycle the stage walls belong to
        orig_rows, orig_observe, orig_snapshot = ctl._delta_rows, ctl._stage_observe, agg.history_snapshot

        def rows_spy(delta):
            r = orig_rows(delta)
            triples.append(r)
            return r

        def observe_spy(name, wall_s, sp):
            stage_walls.append((current[0], name, wall_s))
            orig_observe(name, wall_s, sp)

        def snapshot_spy():
            t = time.monotonic()
            r = orig_snapshot()
            snapshot_walls.append((current[0], time.monotonic() - t))
            return r

        ctl._delta_rows, ctl._stage_observe, agg.history_snapshot = rows_spy, observe_spy, snapshot_spy
        cycles: list = []
        results: dict = {}

        def roll(label, mask=None, factor=1.0):
            """Add the next window's samples (phase 28's `controller_window`
            for the window after it), completing the window before."""
            nxt = controller_window(seq, W, disk_col, mask, factor)
            w = len(seq)
            check(agg.add_samples_columnar(ents, w * window_ms + window_ms // 2, nxt),
                  f"window {w} ({label}) was refused")
            seq.append(nxt)

        def cycle(label, expect: dict):
            current[0] = label
            n_rows = len(triples)
            sync()
            kernels.reset_launches()
            t0 = time.monotonic()
            info = ctl.run_once()
            sync()
            wall = time.monotonic() - t0
            launches = dict(kernels.LAUNCHES)
            check(info is not None, f"cycle {label}: no window roll seen")
            res = info["result"]
            timing = next(h for h in res.history if h.get("timing"))
            stats = ctl.state_json()
            plan = ctl._opt_config.num_candidates
            if not info["reflattened"] and ctl.plan_sizing:
                plan = ctl._plan_config(ctl._opt_config, info["delta_partitions"]).num_candidates
            rec = dict(cycle=label, wall_s=wall, controller_wall_s=stats["lastWallSeconds"],
                       reflattened=info["reflattened"], reason=info.get("reflatten_reason"),
                       delta_partitions=info["delta_partitions"], fused=info["fused"],
                       published=info["published"], warm_start=info["warm_start"], rounds=info["rounds"],
                       plan_candidates=plan, dispatches=info["dispatches"],
                       blocking_syncs=timing.get("blocking_syncs"), captured=len(timing.get("captured") or []),
                       scatter_launches=launches.get("scatter_loads", 0), proposals=len(res.proposals),
                       objective=res.objective_after, degraded=res.degraded)
            cycles.append(rec)
            results[label] = res
            for k, v in expect.items():
                check(rec[k] == v, f"cycle {label}: {k} is {rec[k]!r}, expected {v!r}: {rec}")
            check(info["published"] and not res.degraded and res.state_after.replica_broker.device == dev,
                  f"cycle {label} did not publish a card answer: {rec}")
            bad = hard_violated(res)
            check(not bad, f"cycle {label}: hard goals violated: {bad}")
            if info["fused"]:
                check(stats["lastCycleDispatches"] <= 2 and rec["blocking_syncs"] == 1 and rec["captured"] == 0
                      and (not cuda or rec["scatter_launches"] == 1),
                      f"fused cycle {label} broke its contract: {rec}")
            if not info["reflattened"]:
                # the live loads against a fresh model of the same windows
                new = triples[n_rows:]
                check(len(new) == 1, f"cycle {label}: {len(new)} delta triples")
                rows = new[0][0]
                fresh = cc.monitor.cluster_model(ctl._requirements)
                live = ctl._live.state
                for f in ("replica_load_leader", "replica_load_follower"):
                    a, b = getattr(live, f).cpu().numpy(), getattr(fresh, f).cpu().numpy()
                    if rows is not None:
                        check(a[rows].tobytes() == b[rows].tobytes(),
                              f"cycle {label}: the changed rows' {f} differ from a fresh model's")
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                               err_msg=f"cycle {label}: {f} against a fresh model")
                rec["live_equals_fresh"] = True
                del fresh
            log(json.dumps({"phase": "controller_cycle", **rec}, default=str))
            return info

        order = np.asarray(mon["topology_rows"])
        step = max(4, len(order) // (2 * CONTROLLER_DELTA_PARTITIONS))
        set_d = np.zeros(len(ents), bool)
        set_d[order[1::step][:CONTROLLER_DELTA_PARTITIONS]] = True
        set_e = np.zeros(len(ents), bool)
        set_e[order[3::step][:CONTROLLER_DELTA_PARTITIONS]] = True
        K = cfg.num_candidates

        # (a) the reflatten; each roll adds the samples of the window that
        # completes at the roll after it
        cycle("a", dict(reflattened=True, reason="initial", fused=False, plan_candidates=K))
        # (b) phase 23's x1.1 window completes
        roll("b")
        info_b = cycle("b", dict(reflattened=False, fused=True, plan_candidates=K,
                                 delta_partitions=int(mon["hot"].sum())))
        # (c) an empty window: plan-sized to K/8, a new width, so staged
        roll("c", set_d, 1.2)
        cycle("c", dict(reflattened=False, fused=False, delta_partitions=0, plan_candidates=K // 8))
        # (d) and (e): 200 partitions x1.2 each, K/4: staged once, then fused
        roll("d", set_e, 1.2)
        cycle("d", dict(reflattened=False, fused=False, delta_partitions=CONTROLLER_DELTA_PARTITIONS,
                        plan_candidates=K // 4))
        if cuda:
            check(all(c["captured"] > 0 for c in cycles if c["cycle"] in ("a", "c", "d")),
                  "a new plan width did not capture its engine")
        roll("e", None, 1.03)
        cycle("e", dict(reflattened=False, fused=True, delta_partitions=CONTROLLER_DELTA_PARTITIONS,
                        plan_candidates=K // 4))
        # (f) every partition x1.03: full width, fused
        roll("f")
        prev_f, prev_f_red = ctl._index.history, ctl._index.reduced
        info_f = cycle("f", dict(reflattened=False, fused=True, plan_candidates=K,
                                 delta_partitions=len(mon["topology"].partitions)))
        # GET /proposals serves (f)'s result with no main-path kernel launched
        sync()
        kernels.reset_launches()
        st, body, _, _ = http_call(app, "GET", "/proposals")
        sync()
        req_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        served_state = cc.state(["analyzer", "controller"])
        check(st == 200 and served_state["AnalyzerState"]["proposalSource"] == "controller",
              f"/proposals after (f) answered {st}, source {served_state['AnalyzerState'].get('proposalSource')}")
        check(cc._valid_cache() is info_f["result"]
              and body["proposals"] == [p.to_json() for p in info_f["result"].proposals[:100]]
              and body["numReplicaMovements"] == info_f["result"].summary()["numReplicaMovements"],
              "the served proposals are not the controller's last result")
        check(not req_launches, f"/proposals launched kernels: {req_launches}")
        out["served"] = dict(status=st, proposals=len(info_f["result"].proposals), launches=req_launches,
                             source="controller")
        # the host stages of window (f), profiled: history_snapshot,
        # extract_window_delta and _delta_rows on the same snapshots
        t0 = time.monotonic()
        cur = orig_snapshot()
        t1 = time.monotonic()
        delta = extract_window_delta(prev_f, cur, KAFKA_METRIC_DEF, prev_reduced=prev_f_red)
        t2 = time.monotonic()
        orig_rows(delta)
        out["host_stages_f"] = dict(history_snapshot_s=t1 - t0, extract_window_delta_s=t2 - t1,
                                    delta_rows_s=time.monotonic() - t2)
        prof = cProfile.Profile()
        t0 = time.monotonic()
        prof.enable()
        cur = orig_snapshot()
        delta = extract_window_delta(prev_f, cur, KAFKA_METRIC_DEF, prev_reduced=prev_f_red)
        orig_rows(delta)
        prof.disable()
        profiled_s = time.monotonic() - t0
        buf = io.StringIO()
        # Python 3.12's profiler also records calls of the service's other
        # threads (the HTTP server's selector, the SLO ticker): left out
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(
            r"^(?!.*(selectors|select\.poll|threading|socket|sleep|\bwait\b)).*$", 15)
        log(f"phase 28 host stages of window (f) under cProfile ({profiled_s:.3f} s):\n{buf.getvalue()}")
        out["host_profile_s"] = profiled_s
        # (g) broker 0 dies through the metadata: a reflatten
        topo = metadata.topology()
        metadata.set_topology(dataclasses.replace(topo, brokers=tuple(
            dataclasses.replace(b, alive=b.broker_id != 0) for b in topo.brokers)))
        roll("g", None, 1.03)
        info_g = cycle("g", dict(reflattened=True, reason="topology", fused=False, warm_start=False))
        after = info_g["result"].state_after
        left = int((after.replica_valid & (after.replica_broker == 0)).sum())
        check(left == 0, f"{left} replicas left on the dead broker after (g)")
        stats = ctl.state_json()
        check(stats["fullReflattens"] == 2 and stats["fullReflattensByReason"] == {"initial": 1, "topology": 1}
              and stats["deltaApplies"] == 5,
              f"over (a)-(g): {stats['fullReflattens']} reflattens {stats['fullReflattensByReason']}, "
              f"{stats['deltaApplies']} delta applies")
        # (h) a real OOM in a fused cycle (every partition x1.03, full
        # width), run by the loop thread
        roll("h")
        current[0] = "h (loop thread)"
        served_g = cc._valid_cache()
        t0 = time.monotonic()

        def stop_then_oom(op, fn, args, kwargs):
            # the loop ends after this cycle: the next window is (i)'s, run by run_once
            ctl._stop.set()
            return real_oom(op, fn, args, kwargs)

        with faults.device_fault(stop_then_oom, ops=("engine.cycle",), schedule=faults.first(1)) as fl:
            ctl.start()
            ctl._thread.join(120)
            ctl.stop(timeout_s=60)
        stats = ctl.state_json()
        check(fl.fired == {"engine.cycle": 1} and stats["loopFailures"] == 1
              and "out of memory" in (stats["lastError"] or "").lower(),
              f"the OOM in the fused cycle: fired {fl.fired}, {stats['loopFailures']} failures, {stats['lastError']}")
        st, body, _, _ = http_call(app, "GET", "/proposals")
        check(st == 200 and cc._valid_cache() is served_g is info_g["result"]
              and body["proposals"] == [p.to_json() for p in served_g.proposals[:100]],
              "after the OOM /proposals does not serve (g)'s publish")
        out["oom"] = dict(seconds=time.monotonic() - t0, error=stats["lastError"][:200],
                          loop_failures=stats["loopFailures"], served="g")
        # (i) the next window reflattens and publishes
        roll("i")
        info_i = cycle("i", dict(reflattened=True, reason="failed-cycle", fused=False))
        fresh = cc.monitor.cluster_model(ctl._requirements)
        check(all(torch.equal(getattr(ctl._live.state, f), getattr(fresh, f))
                  for f in ("replica_load_leader", "replica_load_follower")),
              "the reflatten after the OOM does not hold a fresh model's loads")
        del fresh, info_i
        # (j) the loop thread on its own, through start_up and shutdown
        rolls, published = ctl.state_json()["windowRolls"], ctl.state_json()["proposalsPublished"]
        cc.start_up(detection_interval_s=3600)
        check(ctl.running, "start_up did not start the controller")
        thread = ctl._thread
        current[0] = "j (loop thread)"
        roll("j")
        t0 = time.monotonic()
        while ctl.state_json()["proposalsPublished"] == published and time.monotonic() - t0 < 120:
            time.sleep(0.01)
        publish_wall = time.monotonic() - t0
        cc.shutdown()
        thread.join(60)
        stats = ctl.state_json()
        check(stats["windowRolls"] == rolls + 1 and stats["proposalsPublished"] == published + 1
              and not ctl.running and not thread.is_alive(),
              f"the loop thread: {stats['windowRolls'] - rolls} rolls, "
              f"{stats['proposalsPublished'] - published} publishes, running {ctl.running}")
        out["loop_thread"] = dict(publish_after_roll_s=publish_wall, poll_ms=CONTROLLER_POLL_MS,
                                  joined=True)
        ctl._delta_rows, ctl._stage_observe, agg.history_snapshot = orig_rows, orig_observe, orig_snapshot

        # what the run measured
        stages = {}
        for stage in ("window-roll-to-publish", "delta-extract", "scatter", "anneal", "host-extract",
                      "publish"):
            h = cc.sensors.get(f"controller.{stage}-seconds")
            stages[stage] = dict(count=h.count if h else 0, p50_le=quantile_bound(h, 0.5),
                                 p99_le=quantile_bound(h, 0.99),
                                 walls={c: w for c, n, w in stage_walls if n == f"controller.{stage}-seconds"}
                                 if stage != "window-roll-to-publish" else
                                 {c["cycle"]: c["controller_wall_s"] for c in cycles})
        stats = ctl.state_json()
        slo = [s for s in cc.slo_registry.state_json()["slos"] if s.get("name") == "streaming-publish"] \
            if cc.slo_registry is not None else []
        out["stages"] = stages
        out["history_snapshot_s"] = dict(snapshot_walls)
        out["cold"] = dict(coldCycleSeconds=stats["coldCycleSeconds"],
                           fusedColdCycleSeconds=stats["fusedColdCycleSeconds"])
        out["rounds"] = {c["cycle"]: c["rounds"] for c in cycles}
        out["slo_streaming_publish"] = slo
        out["stats"] = {k: v for k, v in stats.items() if k != "prior"}
        out["prior"] = stats["prior"]
        app.stop()
        for engine in cc.optimizer._engines.values():
            engine.release()
        app = None
        del results, info_b, info_f, info_g, served_g
        torch.cuda.empty_cache() if cuda else None

        # cold mode: one window, byte for byte a direct optimize
        cold_app, _, _, _ = service({"controller.warm.start.enabled": False, "controller.delta.enabled": False,
                                     "controller.prior.mix": 0.0})
        ccc = cold_app.cc
        t0 = time.monotonic()
        info = ccc.controller.run_once()
        sync()
        cold_wall = time.monotonic() - t0
        check(info is not None and info["reflattened"] and info["published"], "the cold cycle did not publish")
        fresh = ccc.monitor.cluster_model(ccc.controller._requirements)
        t0 = time.monotonic()
        direct = ccc.optimizer.optimize(fresh, options=ccc._build_options(fresh))
        sync()
        direct_wall = time.monotonic() - t0
        same = {f: bool(torch.equal(getattr(info["result"].state_after, f), getattr(direct.state_after, f)))
                for f in PLACEMENT}
        check(all(same.values()), f"the cold cycle's placement is not a direct optimize's: {same}")
        check(not hard_violated(info["result"]), "the cold cycle violates hard goals")
        out["cold_mode"] = dict(cycle_s=cold_wall, direct_optimize_s=direct_wall, equal_to_optimize=True,
                                rounds=info["rounds"], proposals=len(info["result"].proposals))
        del info, fresh, direct
    except BaseException as e:
        out["failed"] = repr(e)
        out["cycles"] = cycles if "cycles" in locals() else []
        log(json.dumps(out, default=str))
        raise
    finally:
        for a in (app, cold_app):
            if a is not None:
                a.stop()
                a.cc.shutdown()
                for engine in a.cc.optimizer._engines.values():
                    engine.release()
        shutil.rmtree(tmp, ignore_errors=True)
    out["cycles"] = cycles
    out["seconds"] = time.monotonic() - t_phase
    out["within_budget_150_s"] = out["seconds"] <= 150.0
    log(json.dumps(out, default=str))
    return out


def config2_fingerprint(state, chain) -> str:
    """bench.py's _baseline_fingerprint: the identity of the (cluster,
    goal chain) a committed greedy baseline was built for, on the host
    copy of the state (4 significant digits of the leader load, so the
    card's last f32 bits do not move it)."""
    import hashlib

    import numpy as np

    host = {f: getattr(state, f).cpu().numpy() for f in
            ("replica_valid", "broker_valid", "broker_alive", "replica_load_leader")}
    s = state.shape
    alive = host["broker_valid"] & host["broker_alive"]
    load_sig = float(np.asarray(host["replica_load_leader"], np.float64).sum())
    names = ",".join(g.name for g in chain.goals)
    raw = (f"{s.B}x{s.P}x{int(host['replica_valid'].sum())}|{int(alive.sum())}|"
           f"{int(np.nonzero(~alive)[0].sum())}|{load_sig:.4g}|{names}")
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def check_config2() -> dict:
    """Phase 26: BASELINE configuration 2 on the card (bench.py config_2:
    SMALL_SPEC, seed 42, its five goals, SEARCH_SMALL; a warm-up run, then
    the timed one, as bench.py's _run_tpu): every hard goal met.  The
    greedy bar is the one bench.py prefers, the committed converged
    baseline (BASELINE_GREEDY.json config2, after its fingerprint
    matches); a budget-truncated greedy would understate it.  Only when
    the fingerprint is stale does the port's greedy oracle run on the card
    with bench.py's settings (400 moves a goal, 8 destinations, seed 0, a
    60 s budget), labelled unconverged when cut off.  tpu_beats_greedy as
    bench.py decides it: objective <= greedy's x (1 + 1e-4) + 1e-9."""
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.analyzer.objective import GoalChain
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    chain = GoalChain.from_names(list(CONFIG2_CHAIN))
    state = random_cluster_fast(RandomClusterSpec(**SMALL_SPEC), seed=42, device="cuda")
    opt = GoalOptimizer(chain=chain, config=OptimizerConfig(**SEARCH_SMALL), device="cuda")
    warm = opt.optimize(state)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = opt.optimize(state)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for engine in opt._engines.values():
        engine.release()
    with open(ROOT / "BASELINE_GREEDY.json") as f:
        entry = json.load(f)["config2"]
    fingerprint = config2_fingerprint(state, chain)
    if entry.get("fingerprint") == fingerprint:
        greedy = dict(greedy_source="BASELINE_GREEDY.json config2", greedy_objective=entry["objective"],
                      greedy_converged=entry["converged"], greedy_moves=entry["moves"],
                      baseline_greedy_s=entry["seconds"])
    else:
        from cruise_control_tpu_torch.analyzer.greedy import greedy_optimize

        log(f"phase 26: greedy baseline config2 is stale (fingerprint {entry.get('fingerprint')} "
            f"!= {fingerprint}); running the port's greedy oracle on the card")
        t0 = time.monotonic()
        final, info = greedy_optimize(state, chain, max_moves_per_goal=400, candidate_dests=8, seed=0,
                                      time_budget_s=60.0, return_info=True, device="cuda")
        greedy = dict(greedy_source="greedy oracle on the card", greedy_objective=float(chain.evaluate(final)[0]),
                      greedy_converged=info["converged"], greedy_moves=info["moves"],
                      greedy_s=time.monotonic() - t0)
    hard = chain.hard_mask()
    out = dict(phase="config2", brokers=state.shape.B, partitions=state.shape.P, wall_s=wall,
               warm_s=warm.wall_seconds, objective=[res.objective_before, res.objective_after],
               violated_after=res.violated_goals_after(), moves=res.num_inter_broker_moves,
               fingerprint=fingerprint, **greedy,
               tpu_beats_greedy=bool(res.objective_after <= greedy["greedy_objective"] * (1 + 1e-4) + 1e-9))
    log(json.dumps(out))
    check(all(v <= 1e-6 for v, h in zip(res.violations_after, hard) if h),
          f"configuration 2 violates a hard goal: {res.violations_after}")
    return out


def slice_kinds(eng, ln) -> tuple:
    """The valid lanes of a slice's outputs (a lane below its kind's K):
    bool masks over the bundle, the relocation rows, the leadership rows
    and the took-the-prior mask."""
    import torch

    def valid(base, n, k):
        return torch.arange(base, base + n) < k

    vr, vs, vl = valid(ln.base_r, ln.n_r, eng.K_r), valid(ln.base_s, ln.n_s, eng.K_s), valid(
        ln.base_l, ln.n_l, eng.K_l)
    return torch.cat([vr, vs, vl]), torch.cat([vr, vs, vs]), vl, vr


def concat_slices(eng, parts) -> dict:
    """The full-K outputs from n slices' (lanes, outputs): each kind's lanes
    of every slice in order, the lanes past K dropped."""
    import torch

    def kinds(x, ln, rows):
        a, b = ln.n_r, ln.n_r + ln.n_s
        if rows == "payl":
            return (x,)
        if rows == "payr":
            return x[:a], x[a:b], x[b:]
        return x[:a], x[a:b], x[b:]

    sizes = {"out": (eng.K_r, eng.K_s, eng.K_l), "payr": (eng.K_r, eng.K_s, eng.K_s),
             "payl": (eng.K_l,)}
    out: dict = {}
    for grp, fields in (("out", ("delta", "feas", "accept", "src", "dst", "part1", "part2")),
                        ("payr", tuple(parts[0][1]["payr"])), ("payl", tuple(parts[0][1]["payl"]))):
        for f in fields:
            segs = [kinds(p[f] if grp == "out" else p[grp][f], ln, grp) for ln, p in parts]
            out[(grp, f)] = torch.cat([torch.cat([s[k] for s in segs])[:sizes[grp][k]]
                                       for k in range(len(sizes[grp]))])
    if parts[0][1]["from_prior"] is not None:
        out[("out", "from_prior")] = torch.cat([p["from_prior"] for _, p in parts])[:eng.K_r]
    return out


def bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def check_slice_variant(eng, cap, label: str) -> dict:
    """Phase 29 (a) for one kind: the candidates kernel at n = 2, 4 and 8
    slices, concatenated, bit for bit the full-K launch on one real step;
    each slice against its plain version's slice (ids, masks, payload and
    acceptance exact; deltas bit for bit wherever the full-K launch's are,
    the rest within the delta bar); the slice launches timed at K/2 and K/4."""
    import torch

    from cruise_control_tpu_torch.kernels import candidates as cand_k

    (c_args, c_kw), = cap.calls["candidates"]
    cp = c_args[0]
    full = cand_k.candidates(*c_args, **c_kw)
    full = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in full.items()}
    plain = cand_k.candidates_plain(*c_args, **c_kw)
    same_full = int((bits(full["delta"]) == bits(plain["delta"])).sum())
    rec = dict(name=label, K=[cp.K_r, cp.K_s, cp.K_l], full_delta_bits_equal=same_full, n={})
    flat = {("out", k): full[k] for k in ("delta", "feas", "accept", "src", "dst", "part1", "part2")}
    flat.update({("payr", k): v for k, v in full["payr"].items()})
    flat.update({("payl", k): v for k, v in full["payl"].items()})
    if full["from_prior"] is not None:
        flat[("out", "from_prior")] = full["from_prior"]
    for n in (2, 4, 8):
        parts, same, worst = [], 0, 0.0
        for j in range(n):
            ln = cand_k.Lanes.shard(cp, j, n)
            ks = cand_k.candidates(*c_args, **c_kw, lanes=ln)
            ks = dict(ks, payr=dict(ks["payr"]), payl=dict(ks["payl"]))
            ks = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in ks.items()}
            ps = cand_k.candidates_plain(*c_args, **c_kw, lanes=ln)
            vb, vr, vl, vp = (m.to(ks["delta"].device) for m in slice_kinds(eng, ln))
            for f in ("feas", "accept", "src", "dst", "part1", "part2"):
                check(torch.equal(ks[f][vb], ps[f][vb]), f"{label} n={n} j={j}: slice {f} differs from plain")
            for grp, m in (("payr", vr), ("payl", vl)):
                for f, want in ps[grp].items():
                    check(torch.equal(ks[grp][f][m], want[m]),
                          f"{label} n={n} j={j}: slice {grp}.{f} differs from plain")
            if ps["from_prior"] is not None:
                check(torch.equal(ks["from_prior"][vp], ps["from_prior"][vp]),
                      f"{label} n={n} j={j}: slice from_prior differs from plain")
            same += int((bits(ks["delta"][vb]) == bits(ps["delta"][vb])).sum())
            d = (ks["delta"][vb] - ps["delta"][vb]).abs()
            bar = 1e-4 * (ps["delta"][vb].abs() + 1e-2 * float(plain["delta"].abs().max())) + 1e-12
            check(bool((d <= bar).all()), f"{label} n={n} j={j}: slice deltas outside the delta bar")
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
            parts.append((ln, ks))
        cat = concat_slices(eng, parts)
        for key, want in flat.items():
            check(torch.equal(bits(cat[key]), bits(want)),
                  f"{label}: {n} slices concatenated differ from the full-K launch in {key}")
        check(same == same_full, f"{label} n={n}: {same} slice deltas bit for bit their plain "
                                 f"version's, the full-K launch {same_full}")
        rec["n"][n] = dict(bit_for_bit_full=True, plain_delta_bits_equal=same, max_abs_err=worst)
    rec["full_ms"] = measure(lambda: cand_k.candidates(*c_args, **c_kw))["ms"]
    for n in (2, 4):
        ln = cand_k.Lanes.shard(cp, 0, n)
        rec[f"slice_1_of_{n}_ms"] = measure(lambda: cand_k.candidates(*c_args, **c_kw, lanes=ln))["ms"]
    log(json.dumps({"phase": "candidate_slice", **rec}))
    return rec


def check_mesh_slices(state, cfg) -> dict:
    """Phase 29 (a): the candidate slice on the default, prior, bf16 and
    intra kinds (the intra kind on BASELINE configuration 3's JBOD
    cluster), one real step each."""
    import torch

    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, prior_table, random_cluster_fast

    s = state.shape
    out = {}
    for label, c, prior in (("default", cfg, None),
                            ("prior", dataclasses.replace(cfg, prior_enabled=True), prior_table(s, 7, 0.25)),
                            ("bf16", dataclasses.replace(cfg, score_dtype="bfloat16"), None)):
        eng, cap = capture_step(state, c, prior)
        out[label] = check_slice_variant(eng, cap, label)
        eng.release()
        del eng, cap
    jbod = random_cluster_fast(RandomClusterSpec(**{**MID_SPEC, "disks_per_broker": 4}), seed=42,
                               device="cuda")
    eng, cap = capture_step(jbod, dataclasses.replace(cfg, intra_broker=True))
    out["intra"] = check_slice_variant(eng, cap, "intra")
    eng.release()
    torch.cuda.empty_cache()
    return out


def mesh_run(me, reports: bool = True):
    """A mesh engine's run and its driver wall."""
    t0 = time.monotonic()
    out = me.run_reported() if reports else (*me.run(), None)
    return out, time.monotonic() - t0


def check_mesh_one_card(state, cfg, exact: dict, smi: str) -> dict:
    """Phase 29 (b): a 1x1 rank group over NCCL at the north star: its
    placements, objective and history bit for bit the single-device
    engine's (a plain engine here, and phase 4's run, `exact`, where the
    script ran it; an empty `exact` is filled from the plain engine's run), 0 collectives in the
    loop; the group's start-up (spawn, import, NCCL join, build, first run
    with its capture) and a repeated run's wall against the plain engine's
    repeated wall, the process boundary's cost."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.parallel import ShardedEngine, close_rank_groups, model_mesh

    plain = Engine(state, DEFAULT_CHAIN, config=cfg)
    walls_plain = []
    for _ in range(2):
        t0 = time.monotonic()
        p_final, p_hist, p_out = plain.run_reported()
        walls_plain.append(time.monotonic() - t0)
    if not exact:
        exact.update({f: getattr(p_final, f).clone() for f in PLACEMENT})
        exact["objective_after"] = float(p_out["obj_after"])
    t0 = time.monotonic()
    me = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(["cuda:0"]), config=cfg, timeout_s=600)
    build_s = time.monotonic() - t0
    (m_final, m_hist, m_out), first_s = mesh_run(me)
    (m_final2, m_hist2, m_out2), repeat_s = mesh_run(me)
    same = {f: bool(torch.equal(getattr(m_final, f), getattr(p_final, f))) and
            bool(torch.equal(getattr(m_final, f), exact[f])) for f in PLACEMENT}
    rounds_m = [{k: v for k, v in h.items()} for h in m_hist if "round" in h]
    rounds_p = [{k: v for k, v in h.items()} for h in p_hist if "round" in h]
    timing = m_hist[-1]
    rec = dict(
        phase="mesh_1x1", card=smi, ranks=1, backend=timing["backend"], cards=1,
        placements_equal=same, history_equal=rounds_m == rounds_p,
        objective_equal=bool(np.float32(m_out["obj_after"]) == np.float32(p_out["obj_after"])
                             == np.float32(exact["objective_after"])),
        collectives=timing["collectives"], gather_calls=me.last_info["gather_calls"],
        collective_bytes_per_step=me.collective_bytes_per_step, loop_route=timing["loop_route"],
        start=dict(me.build_info, first_run_s=first_s), repeat_wall_s=repeat_s,
        plain_repeat_wall_s=walls_plain[1], plain_first_wall_s=walls_plain[0],
        process_boundary_s=repeat_s - walls_plain[1], rank_repeat_wall_s=me.last_info["rank_walls"],
        blocking_syncs=timing["blocking_syncs"],
        rank_device_s=timing["device_s"], digests=me.carry_digests(),
    )
    log(json.dumps(rec))
    check(all(same.values()), f"1x1 mesh placements differ from the single-device engine: {same}")
    check(rec["history_equal"], "1x1 mesh history differs from the single-device engine's")
    check(rec["objective_equal"], "1x1 mesh objective differs from the single-device engine's")
    check(rec["collectives"] == 0 and rec["gather_calls"] == [0], "a 1x1 mesh gathered")
    me.release()
    plain.release()
    close_rank_groups()
    torch.cuda.empty_cache()
    return rec


def check_mesh_cards(state, cfg, exact: dict, smi: str, devs=None) -> dict:
    """Phase 29 (c), four cards or more: 1x4, 2x2 and 4x1 at the north
    star over NCCL.  1x4 bit for bit the single-device engine; every chain
    of the portfolio and the grid bit for bit a one-card run from the
    chain's key (its final carry's digest and carry objective); the carries
    of each model row bitwise equal; collective bytes and count a step,
    walls and syncs.  `devs` (cuda:0-3 when None) lets the CPU rehearse it
    over gloo ranks, the one-card references on the state's device."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, DEFAULT_OPTIONS
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT
    from cruise_control_tpu_torch.parallel import GridEngine, ShardedEngine, close_rank_groups, grid_mesh, model_mesh
    from cruise_control_tpu_torch.parallel.mesh import RankEngine, _carry_digest

    devs = devs or [f"cuda:{i}" for i in range(4)]
    out = {}
    # one-card chains from each portfolio key, on cuda:0 in this process
    chain_ref = {}
    for R in (2, 4):
        for r, key in enumerate(Key.from_seed(cfg.seed).split(R)):
            eng = RankEngine(state, DEFAULT_CHAIN, DEFAULT_CONSTRAINT, DEFAULT_OPTIONS, cfg,
                             key=key, shard=(0, 1))
            eng.run()
            chain_ref[(R, r)] = dict(digest=_carry_digest(eng._ws.carry),
                                     objective=float(eng.carry_objective(eng._ws.carry)))
            eng.release()
    torch.cuda.empty_cache()
    for label, (R, M) in (("1x4", (1, 4)), ("2x2", (2, 2)), ("4x1", (4, 1))):
        t0 = time.monotonic()
        mesh = model_mesh(devs) if R == 1 else grid_mesh(R, M, devs)
        me = (ShardedEngine if R == 1 else GridEngine)(state, DEFAULT_CHAIN, mesh=mesh, config=cfg,
                                                        timeout_s=600)
        build_s = time.monotonic() - t0
        (f1, h1, o1), first_s = mesh_run(me)
        (f2, h2, o2), repeat_s = mesh_run(me)
        digests = me.carry_digests()
        info = me.last_info
        timing = h2[-1]
        rows_equal = all(len(set(digests[r * M:(r + 1) * M])) == 1 for r in range(R))
        rec = dict(phase="mesh_cards", layout=label, card=smi, ranks=R * M, backend=timing["backend"],
                   cards=R * M, build_s=build_s, first_run_s=first_s, repeat_wall_s=repeat_s,
                   rank_repeat_walls_s=info["rank_walls"], rank_syncs=timing["blocking_syncs"],
                   rank_device_s=timing["device_s"], blocking_syncs=timing["blocking_syncs"],
                   collectives_per_run=timing["collectives"],
                   collectives_per_step=(1 if M > 1 else 0),
                   collective_bytes_per_step=me.collective_bytes_per_step,
                   loop_route=info["loop_route"], loop_error=info["loop_error"],
                   rows_bitwise_equal=rows_equal, objectives=[float(x) for x in info["objectives"]],
                   winner=info["winner"], group_start=me.build_info)
        if R == 1:
            same = {f: bool(torch.equal(getattr(f2, f), exact[f])) for f in PLACEMENT}
            rec["placements_equal_single"] = same
            check(all(same.values()), f"1x4 placements differ from the single-device engine: {same}")
        else:
            chains = []
            for r in range(R):
                ref = chain_ref[(R, r)]
                chains.append(dict(
                    digest_equal=digests[r * M] == ref["digest"],
                    objective_equal=bool(np.float32(info["objectives"][r]) == np.float32(ref["objective"]))))
            rec["chains_equal_one_card"] = chains
            check(all(c["digest_equal"] and c["objective_equal"] for c in chains),
                  f"{label}: a chain differs from its one-card run: {chains}")
        log(json.dumps(rec))
        check(rows_equal, f"{label}: the carries of a model row differ: {digests}")
        out[label] = rec
        me.release()
    close_rank_groups()
    torch.cuda.empty_cache()
    return out


def bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (floats by their bits)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))
    return bool(torch.equal(a, b))


#: phase 30's kernels, as rows of their own in the kernels line
SHARD_CASES = {
    "candidates_shard": ("candidates.cu", "cruise_control_tpu/parallel/model_shard.py:222"),
    "shard_sources": ("model_shard.cu", "cruise_control_tpu/parallel/model_shard.py:285"),
    "own_rows": ("model_shard.cu", "cruise_control_tpu/parallel/model_shard.py:196"),
    "own_member_rows": ("model_shard.cu", "cruise_control_tpu/parallel/model_shard.py:231"),
    "own_parts": ("model_shard.cu", "cruise_control_tpu/parallel/model_shard.py:226"),
    "shard_prc": ("model_shard.cu", "cruise_control_tpu/models/aggregates.py:93"),
    "apply_moves_offsets": ("apply.cu", "cruise_control_tpu/parallel/model_shard.py:323"),
    "refresh_aggregates_local": ("refresh.cu", "cruise_control_tpu/models/aggregates.py:58"),
}


class ShardEmulation:
    """The sharded-model step of n shards on one device (phase 30 (a)):
    each shard's kernels on its own row blocks (`shard_views`), and a torch
    sum of the shard bundles in place of the all_reduce (NCCL takes one
    rank a card)."""

    def __init__(self, eng, carry, plan, n: int):
        import torch

        from cruise_control_tpu_torch.kernels import model_shard as ms_k
        from cruise_control_tpu_torch.kernels.group import group_placement
        from cruise_control_tpu_torch.parallel.model_shard import ShardPlan, shard_views

        s = eng.shape
        self.eng, self.n = eng, n
        self.blks = [ms_k.Block.of(s.R, s.P, j, n) for j in range(n)]
        self.views = [shard_views(eng.statics, carry, b) for b in self.blks]
        groups = [group_placement(c.replica_broker, sx.state.replica_valid, s.B)
                  for sx, c in self.views]
        counts = torch.stack([gp.count for gp in groups])
        self.plans = [ShardPlan(
            broker_cdf=plan.broker_cdf, order=gp.order, start=gp.start, count=plan.count,
            count_local=gp.count, below=counts[:j].sum(0).to(torch.int32), start_global=plan.start,
            replica_cost=plan.replica_cost, lead_cost=plan.lead_cost) for j, gp in enumerate(groups)]
        self.groups = groups

    def hop(self, fn):
        """One hop: every shard's own-or-zero bundle, summed."""
        parts = [fn(j, sx, c) for j, ((sx, c), _b) in enumerate(zip(self.views, self.blks))]
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def bundles(self, cursor):
        import torch

        from cruise_control_tpu_torch.kernels import candidates as cand_k
        from cruise_control_tpu_torch.kernels import model_shard as ms_k

        eng = self.eng
        cp = eng.cand
        max_rf = eng.max_rf
        n_rs = cp.K_r + 2 * cp.K_s
        ids = self.hop(lambda j, sx, c: ms_k.shard_sources(cp, cursor, self.plans[j], sx.gen,
                                                           self.blks[j], True))
        rows = self.hop(lambda j, sx, c: ms_k.own_rows(ids, ms_k.ROW_WORDS,
                                                       ms_k.row_columns(sx.state, c), self.blks[j]))
        parts = self.hop(lambda j, sx, c: ms_k.own_parts(rows.view(-1)[1:], int(ids.shape[0]),
                                                         ms_k.ROW_WORDS, sx.part_replicas,
                                                         c.part_rack_count, self.blks[j]))
        mrows = self.hop(lambda j, sx, c: ms_k.own_member_rows(parts, n_rs, max_rf,
                                                               ms_k.row_columns(sx.state, c),
                                                               self.blks[j]))
        mb, ml = mrows[: n_rs * max_rf].view(-1, 1), mrows[n_rs * max_rf:].view(-1, ms_k.ROW_WORDS)
        return cand_k.ShardBundles(ids=ids, rows=rows, parts=parts, mb=mb, ml=ml,
                                   shape=eng.shape, row_words=ms_k.ROW_WORDS)


def owned_rows(ids, blk) -> int:
    """The distinct replica rows among `ids` that shard `blk` owns: the
    rows an own-or-zero gather reads."""
    import torch

    li = ids.reshape(-1).long() - blk.r_off
    return int(torch.unique(li[(li >= 0) & (li < blk.r_local)]).numel())


def check_model_shard_step(state, cfg, smi: str) -> dict:
    """Phase 30 (a): the sharded-model step emulated on one card at the
    north star, for n = 2 and n = 4 shards (`ShardEmulation`), on loads
    rounded to integers (every partial sum exact).  The assembled bundles
    are the whole model's gathers at the same ids, bit for bit; the
    candidates kernel's SHARD body gives the full-model fused launch's
    deltas, acceptance and payload bit for bit; `apply_moves` with each
    shard's row offsets writes the whole apply's rows of its block and
    the same aggregates; the local refresh's sums over the shards are the
    whole refresh's; the local groupings rebuild the global grouped order.
    Each new or changed kernel is held against its plain version and
    timed.  The path's launches are counted over one emulated step at
    n = 4 (`launches`)."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch import kernels as kernels_mod
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import apply as apply_k
    from cruise_control_tpu_torch.kernels import candidates as cand_k
    from cruise_control_tpu_torch.kernels import model_shard as ms_k
    from cruise_control_tpu_torch.kernels import select as select_k
    from cruise_control_tpu_torch.kernels.refresh import refresh_aggregates, refresh_plain
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.parallel.model_shard import loads_quantized

    t_phase = time.monotonic()
    dev = state.device
    st = loads_quantized(pad_state(state, shard_multiple_shape(state.shape, 4)), scale=1.0)
    eng = Engine(st, DEFAULT_CHAIN, config=cfg)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    g = eng._globals(carry)
    cp = eng.cand
    s = eng.shape
    keys = cand_k.StepKeys.of(carry.key, intra=False, prior=False)
    cursor = cand_k.KeyCursor.of(keys, dev)
    temp = torch.full((1,), float(eng.evaluate(carry)[0]) * cfg.init_temperature_scale,
                      dtype=torch.float32, device=dev)
    full = cand_k.candidates(cp, eng.statics, carry, cursor, g, plan, temp)
    full_blk = ms_k.Block(0, s.R, 0, s.P, 0, 1)
    cols = ms_k.row_columns(eng.statics.state, carry)
    max_rf, racks = eng.max_rf, s.num_racks
    n_rs, pw = cp.K_r + 2 * cp.K_s, max_rf + racks
    want_ids = torch.cat([full["payr"]["r"], full["payl"]["rt"]]).to(torch.int32)
    out: dict = dict(phase="model_shard_step", card=smi, R=s.R, P=s.P, B=s.B, K=cp.K_r + cp.K_s + cp.K_l)
    prop_fields = ("delta", "feas", "accept", "src", "dst", "part1", "part2")
    em4 = None
    for n in (2, 4):
        em = ShardEmulation(eng, carry, plan, n)
        sh = em.bundles(cursor)
        rows_want = ms_k.own_rows_plain(sh.ids, ms_k.ROW_WORDS, cols, full_blk)
        parts_want = ms_k.own_parts_plain(sh.rows[:, 1], eng.statics.part_replicas,
                                          carry.part_rack_count, full_blk)
        mb_want = ms_k.own_rows_plain(sh.parts[:n_rs, :max_rf], 1, cols, full_blk)
        ml_want = ms_k.own_rows_plain(sh.parts[n_rs:, :max_rf], ms_k.ROW_WORDS, cols, full_blk)
        body = cand_k.candidates_shard(cp, em.views[0][0], em.views[0][1], cursor, g, em.plans[0],
                                       temp, sh)
        same = dict(
            ids=bits_equal(sh.ids, want_ids), rows=bits_equal(sh.rows, rows_want),
            parts=bits_equal(sh.parts, parts_want), mb=bits_equal(sh.mb, mb_want),
            ml=bits_equal(sh.ml, ml_want),
            **{f: bits_equal(body[f], full[f]) for f in prop_fields},
            payr=all(bits_equal(body["payr"][f], full["payr"][f]) for f in full["payr"]),
            payl=all(bits_equal(body["payl"][f], full["payl"][f]) for f in full["payl"]),
        )
        out[f"n{n}_bit_equal_full"] = same
        check(all(same.values()), f"model shard n={n}: the emulated step differs from the full "
                                  f"launch: {same}")
        if n == 4:
            em4 = (em, sh, body)
    em, sh, body = em4
    # apply_moves with row offsets: each shard's block of the whole apply
    survive, sv_r, _ = select_k.select_survivors(
        full["accept"], full["delta"], full["src"], full["dst"], full["part1"], full["part2"],
        num_brokers=s.B, num_parts=s.P, n_r=full["nr"], n_s=full["ns"])
    sv_l = survive[full["nr"] + full["ns"]:]
    whole = carry.clone()
    apply_k.apply_moves(eng.statics, whole, sv_r, full["payr"], sv_l, full["payl"])
    agg_names = ("broker_load", "broker_replica_count", "broker_leader_count",
                 "broker_potential_nw_out", "broker_leader_bytes_in", "broker_topic_count",
                 "disk_load", "host_load")
    applied = {}
    for j, b in enumerate(em.blks):
        sx_j, c_j = em.views[j]
        c = dataclasses.replace(carry.clone(), **{
            f: getattr(c_j, f).clone() for f in ("replica_broker", "replica_is_leader",
                                                 "replica_disk", "part_rack_count")})
        apply_k.apply_moves(sx_j, c, sv_r, full["payr"], sv_l, full["payl"], r_off=b.r_off,
                            p_off=b.p_off)
        r0, r1, p0, p1 = b.r_off, b.r_off + b.r_local, b.p_off, b.p_off + b.p_local
        applied[j] = all([
            bits_equal(c.replica_broker, whole.replica_broker[r0:r1]),
            bits_equal(c.replica_is_leader, whole.replica_is_leader[r0:r1]),
            bits_equal(c.replica_disk, whole.replica_disk[r0:r1]),
            bits_equal(c.part_rack_count, whole.part_rack_count[p0:p1]),
            *(bits_equal(getattr(c, f), getattr(whole, f)) for f in agg_names)])
        if j == 0:
            pc = dataclasses.replace(carry.clone(), **{
                f: getattr(c_j, f).clone() for f in ("replica_broker", "replica_is_leader",
                                                     "replica_disk", "part_rack_count")})
            apply_k.apply_plain(sx_j, pc, sv_r, full["payr"], sv_l, full["payl"], b.r_off, b.p_off)
            out["apply_offsets_kernel_equals_plain"] = all(
                bits_equal(getattr(pc, f), getattr(c, f))
                for f in ("replica_broker", "replica_is_leader", "replica_disk", "part_rack_count",
                          *agg_names))
    out["apply_offsets_block_equal_whole"] = applied
    check(all(applied.values()) and out["apply_offsets_kernel_equals_plain"],
          f"apply_moves with row offsets differs: {applied}")
    # the local refresh: sums over the shards are the whole refresh's
    fresh = eng.init_carry(Key.from_seed(cfg.seed))
    sums, prc = None, None
    for j, b in enumerate(em.blks):
        sx_j, c_j = em.views[j]
        view = dataclasses.replace(sx_j.state, replica_partition=torch.zeros_like(
            sx_j.state.replica_partition))
        part = {k: torch.zeros_like(getattr(fresh, k)) for k in agg_names if k != "host_load"}
        part["part_rack_count"] = torch.zeros((b.p_local, racks), dtype=torch.int32, device=dev)
        refresh_aggregates(view, c_j.replica_broker, c_j.replica_is_leader, c_j.replica_disk, part,
                           members=torch.full((b.p_local, 1), -1, dtype=torch.int32, device=dev))
        contrib = ms_k.shard_prc(sx_j.state, c_j.replica_broker, s.P)
        if j == 0:
            out["shard_prc_kernel_equals_plain"] = bits_equal(
                contrib, ms_k.shard_prc_plain(sx_j.state, c_j.replica_broker, s.P))
        sums = part if sums is None else {k: sums[k] + part[k] for k in sums}
        prc = contrib if prc is None else prc + contrib
    refreshed = {k: bits_equal(sums[k], getattr(fresh, k)) for k in agg_names if k != "host_load"}
    refreshed["part_rack_count"] = bits_equal(prc, fresh.part_rack_count)
    out["refresh_local_sum_equal_whole"] = refreshed
    check(all(refreshed.values()) and out["shard_prc_kernel_equals_plain"],
          f"the local refresh differs from the whole: {refreshed}")
    # the local groupings rebuild the global grouped order
    rebuilt = torch.full((s.R,), -1, dtype=torch.int64, device=dev)
    for j, (b, gp) in enumerate(zip(em.blks, em.groups)):
        c_j = em.views[j][1]
        k = torch.arange(int(gp.count.sum()), device=dev)
        bro = c_j.replica_broker[gp.order[k].long()].long()
        pos = plan.start[bro] + em.plans[j].below[bro] + (k - gp.start[bro])
        rebuilt[pos] = gp.order[k].long() + b.r_off
    n_grouped = int(plan.count.sum())
    out["grouped_order_rebuilt"] = bool(torch.equal(rebuilt[:n_grouped], plan.order[:n_grouped].long()))
    check(out["grouped_order_rebuilt"], "the shards' local groupings do not rebuild the global order")
    # kernels against their plain versions, on the same inputs (n = 4, shard 0)
    sx0, c0 = em.views[0]
    b0, sp0 = em.blks[0], em.plans[0]
    cols0 = ms_k.row_columns(sx0.state, c0)
    # (the plain versions are PyTorch ops: they run on the card's tensors)
    # the body against its plain version: phase 2's bar for candidates (the
    # plain version's CUDA ops multiply by reciprocals where the kernel
    # divides): every integer and boolean output equal, deltas within
    # `delta_bar`
    plain_body = cand_k.candidates_shard_plain(cp, sx0, c0, keys, g, sp0, temp, sh)
    body_err = (body["delta"] - plain_body["delta"]).abs()
    out["candidates_shard_max_abs_err"] = float(body_err.max())
    out["candidates_shard_kernel_equals_plain"] = bool(
        (body_err <= delta_bar(plain_body["delta"])).all()) and all(
        bits_equal(body[f], plain_body[f]) for f in prop_fields if f != "delta")
    pairs = dict(
        shard_sources=(ms_k.shard_sources(cp, cursor, sp0, sx0.gen, b0, True),
                       ms_k.shard_sources_plain(cp, keys, sp0, sx0.gen, b0, True)),
        own_rows=(ms_k.own_rows(sh.ids, ms_k.ROW_WORDS, cols0, b0),
                  ms_k.own_rows_plain(sh.ids, ms_k.ROW_WORDS, cols0, b0)),
        own_parts=(ms_k.own_parts(sh.rows.view(-1)[1:], int(sh.ids.shape[0]), ms_k.ROW_WORDS,
                                  sx0.part_replicas, c0.part_rack_count, b0),
                   ms_k.own_parts_plain(sh.rows[:, 1], sx0.part_replicas, c0.part_rack_count, b0)),
        own_member_rows=(ms_k.own_member_rows(sh.parts, n_rs, max_rf, cols0, b0),
                         ms_k.own_member_rows_plain(sh.parts, n_rs, max_rf, cols0, b0)),
    )
    # shard_sources with the CDF probed from global memory (a CDF past the
    # shared-memory budget), on every shard
    kept, ms_k.SOURCES_CDF_SMEM_MAX = ms_k.SOURCES_CDF_SMEM_MAX, 0
    try:
        for j in range(em.n):
            pairs[f"shard_sources_global_cdf_j{j}"] = (
                ms_k.shard_sources(cp, cursor, em.plans[j], em.views[j][0].gen, em.blks[j], True),
                ms_k.shard_sources_plain(cp, keys, em.plans[j], em.views[j][0].gen, em.blks[j], True))
    finally:
        ms_k.SOURCES_CDF_SMEM_MAX = kept
    for name, (k, p) in pairs.items():
        out[f"{name}_kernel_equals_plain"] = bits_equal(k, p)
    bad = [k for k, v in out.items() if k.endswith("kernel_equals_plain") and not v]
    check(not bad, f"model shard kernels differ from their plain versions: {bad}")
    # float loads: the emulated step at n = 4 twice on the unquantized loads;
    # the second's bundles, deltas and acceptance are the first's, and the
    # full launch's, bit for bit
    eng_f = Engine(pad_state(state, shard_multiple_shape(state.shape, 4)), DEFAULT_CHAIN, config=cfg)
    carry_f = eng_f.init_carry(Key.from_seed(cfg.seed))
    plan_f = eng_f.plan(carry_f)
    g_f = eng_f._globals(carry_f)
    temp_f = torch.full((1,), float(eng_f.evaluate(carry_f)[0]) * cfg.init_temperature_scale,
                        dtype=torch.float32, device=dev)
    full_f = cand_k.candidates(eng_f.cand, eng_f.statics, carry_f, cursor, g_f, plan_f, temp_f)
    emulated = []
    for _ in range(2):
        em_f = ShardEmulation(eng_f, carry_f, plan_f, 4)
        sh_f = em_f.bundles(cursor)
        emulated.append((sh_f, cand_k.candidates_shard(eng_f.cand, em_f.views[0][0], em_f.views[0][1],
                                                       cursor, g_f, em_f.plans[0], temp_f, sh_f)))
    (sh_a, body_a), (sh_b, body_b) = emulated
    same = {f: bits_equal(getattr(sh_a, f), getattr(sh_b, f)) for f in ("ids", "rows", "parts", "mb", "ml")}
    same.update({f: bits_equal(body_a[f], body_b[f]) for f in prop_fields})
    same["full_launch"] = all(bits_equal(body_a[f], full_f[f]) for f in prop_fields)
    out["float_loads_repeat_bit_equal"] = same
    check(all(same.values()), f"model shard float loads: the emulated step differs between two "
                              f"emulations or from the full launch: {same}")
    eng_f.release()
    del eng_f, carry_f, plan_f, full_f, emulated
    # the broker CDF's scan at the target's 25,000 brokers: the card's bits
    # are the CPU's (elementwise adds in one order) in every repeat, where
    # PyTorch's CUDA cumsum varies
    from cruise_control_tpu_torch.analyzer.engine import scan_fixed_order

    probs = torch.from_numpy(np.random.default_rng(42).lognormal(0.0, 2.0, 25_000).astype(np.float32))
    want = scan_fixed_order(probs)
    on_card = probs.to(dev)
    seen = {bytes(scan_fixed_order(on_card).cpu().numpy().tobytes()) for _ in range(50)}
    seen_cumsum = {bytes(torch.cumsum(on_card, 0).cpu().numpy().tobytes()) for _ in range(50)}
    out["cdf_scan"] = dict(n=25_000, repeats=50, results=len(seen), equal_cpu=seen == {
        bytes(want.numpy().tobytes())}, torch_cumsum_results=len(seen_cumsum))
    check(out["cdf_scan"]["equal_cpu"], f"the fixed-order scan differs on the card: {out['cdf_scan']}")
    # the path's launches: one emulated step at n = 4 from a reset count
    kernels_mod.reset_launches()
    em_l = ShardEmulation(eng, carry, plan, 4)
    sh_l = em_l.bundles(cursor)
    prop = cand_k.candidates_shard(cp, em_l.views[0][0], em_l.views[0][1], cursor, g, em_l.plans[0],
                                   temp, sh_l)
    sv2, svr2, _ = select_k.select_survivors(
        prop["accept"], prop["delta"], prop["src"], prop["dst"], prop["part1"], prop["part2"],
        num_brokers=s.B, num_parts=s.P, n_r=prop["nr"], n_s=prop["ns"])
    scratch = carry.clone()
    for j, b in enumerate(em_l.blks):
        sx_j, c_j = em_l.views[j]
        c = dataclasses.replace(scratch, replica_broker=c_j.replica_broker.clone(),
                                replica_is_leader=c_j.replica_is_leader.clone(),
                                replica_disk=c_j.replica_disk.clone(),
                                part_rack_count=c_j.part_rack_count.clone())
        apply_k.apply_moves(sx_j, c, svr2, prop["payr"], sv2[prop["nr"] + prop["ns"]:],
                            prop["payl"], r_off=b.r_off, p_off=b.p_off)
        ms_k.shard_prc(sx_j.state, c.replica_broker, s.P)
        view = dataclasses.replace(sx_j.state, replica_partition=torch.zeros_like(
            sx_j.state.replica_partition))
        part = {k: torch.zeros_like(getattr(scratch, k)) for k in agg_names if k != "host_load"}
        part["part_rack_count"] = torch.zeros((b.p_local, racks), dtype=torch.int32, device=dev)
        refresh_aggregates(view, c.replica_broker, c.replica_is_leader, c.replica_disk, part,
                           members=torch.full((b.p_local, 1), -1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels_mod.LAUNCHES.items() if v}
    out["launches"] = launched
    launches = dict(candidates_shard=launched.get("candidates_shard", 0),
                    shard_sources=launched.get("shard_sources", 0),
                    own_rows=launched.get("own_rows", 0),
                    own_member_rows=launched.get("own_member_rows", 0),
                    own_parts=launched.get("own_parts", 0), shard_prc=launched.get("shard_prc", 0),
                    apply_moves_offsets=launched.get("apply_moves", 0),
                    refresh_aggregates_local=launched.get("refresh_aggregates", 0))
    check(all(v > 0 for v in launches.values()), f"a model-shard kernel did not launch: {launches}")
    # the own_rows kernel: hop 2 and hop 4's one launch, a shard a step
    out["own_rows_kernel_launches_per_shard_step"] = (
        launches["own_rows"] + launches["own_member_rows"]) / len(em_l.blks)
    check(out["own_rows_kernel_launches_per_shard_step"] == 2,
          f"own_rows' kernel ran {out['own_rows_kernel_launches_per_shard_step']} launches a shard "
          "a step, not 2")
    # times: a launch each (n = 4, shard 0), the plain version on the same
    # device inputs, the bound from the bytes each moves
    n_slots = int(sh.ids.shape[0])
    rows = {}

    def row(name, kfn, pfn, nb, ops, lib=None, err=0.0):
        # the kernel's device time by the profiler, and by a CUDA graph of
        # its launches whether or not the profiler sees the card; the plain
        # version's and the library call's by CUDA events (a profiler
        # session costs seconds of set-up, and they are yardsticks)
        k = measure(kfn)
        b_ms, b_by = bound(nb, ops)
        rows[name] = dict(launches=launches[name], max_abs_err=err, ms=k["ms"], ms_source=k["ms_source"],
                          profiler_attempts=k.get("profiler_attempts"),
                          graph_ms=k["ms"] if k["ms_source"] == "cuda graph" else graph_ms(kfn),
                          call_ms=k["call_ms"], plain_ms=time_ms(pfn, 10), bound_ms=b_ms, bound_by=b_by,
                          library_ms=None if lib is None else time_ms(lib, 10))

    row_b = 4 * ms_k.ROW_WORDS
    # shard_sources: every slot's id written, an importance-sampled slot's
    # four plan words and order row read, the CDF and the key row once;
    # ~80 integer operations a threefry hash, ~70 for the CDF search
    n_imp = cp.n_imp(cp.K_r, sp0) + cp.n_imp(cp.K_s, sp0)
    row("shard_sources", lambda: ms_k.shard_sources(cp, cursor, sp0, sx0.gen, b0, True),
        lambda: ms_k.shard_sources_plain(cp, keys, sp0, sx0.gen, b0, True),
        4 * n_slots + 20 * n_imp + 4 * s.B + 4 * 48, 90.0 * (n_slots - n_imp) + 330.0 * n_imp)
    # own_rows and own_member_rows: each id read, each owned row read once
    # (its 18 words, or its broker), every word written
    row("own_rows", lambda: ms_k.own_rows(sh.ids, ms_k.ROW_WORDS, cols0, b0),
        lambda: ms_k.own_rows_plain(sh.ids, ms_k.ROW_WORDS, cols0, b0),
        4 * n_slots + row_b * owned_rows(sh.ids, b0) + row_b * n_slots, float(n_slots))
    mids_b, mids_l = sh.parts[:n_rs, :max_rf], sh.parts[n_rs:, :max_rf]
    row("own_member_rows", lambda: ms_k.own_member_rows(sh.parts, n_rs, max_rf, cols0, b0),
        lambda: ms_k.own_member_rows_plain(sh.parts, n_rs, max_rf, cols0, b0),
        4 * (mids_b.numel() + mids_l.numel()) + 4 * owned_rows(mids_b, b0)
        + row_b * owned_rows(mids_l, b0) + 4 * mids_b.numel() + row_b * mids_l.numel(),
        float(mids_b.numel() + mids_l.numel()))
    row("own_parts", lambda: ms_k.own_parts(sh.rows.view(-1)[1:], n_slots, ms_k.ROW_WORDS,
                                            sx0.part_replicas, c0.part_rack_count, b0),
        lambda: ms_k.own_parts_plain(sh.rows[:, 1], sx0.part_replicas, c0.part_rack_count, b0),
        4 * n_slots + 2 * 4 * n_slots * pw, float(n_slots * pw))
    seg = torch.where(sx0.state.replica_valid, sx0.state.replica_partition.long() * racks
                      + sx0.state.broker_rack[c0.replica_broker.long()].long(), s.P * racks)
    row("shard_prc", lambda: ms_k.shard_prc(sx0.state, c0.replica_broker, s.P),
        lambda: ms_k.shard_prc_plain(sx0.state, c0.replica_broker, s.P),
        9 * b0.r_local + 4 * s.P * racks, float(b0.r_local),
        lib=lambda: torch.bincount(seg, minlength=s.P * racks + 1))
    row("candidates_shard", lambda: cand_k.candidates_shard(cp, sx0, c0, cursor, g, sp0, temp, sh),
        lambda: cand_k.candidates_shard_plain(cp, sx0, c0, keys, g, sp0, temp, sh),
        nbytes(sh.ids, sh.rows, sh.parts, sh.mb, sh.ml) + 22 * out["K"], 600.0 * out["K"],
        err=out["candidates_shard_max_abs_err"])
    scratch4 = dataclasses.replace(carry.clone(), replica_broker=c0.replica_broker.clone(),
                                   replica_is_leader=c0.replica_is_leader.clone(),
                                   replica_disk=c0.replica_disk.clone(),
                                   part_rack_count=c0.part_rack_count.clone())
    n_surv = int(survive.sum())
    row("apply_moves_offsets",
        lambda: apply_k.apply_moves(sx0, scratch4, sv_r, full["payr"], sv_l, full["payl"],
                                    r_off=b0.r_off, p_off=b0.p_off),
        lambda: apply_k.apply_plain(sx0, scratch4, sv_r, full["payr"], sv_l, full["payl"],
                                    b0.r_off, b0.p_off),
        int(survive.numel()) + 64 * n_surv + 120 * n_surv, 30.0 * n_surv)
    view0 = dataclasses.replace(sx0.state, replica_partition=torch.zeros_like(sx0.state.replica_partition))
    pad0 = torch.full((b0.p_local, 1), -1, dtype=torch.int32, device=dev)
    part0 = {k: torch.zeros_like(getattr(fresh, k)) for k in agg_names if k != "host_load"}
    part0["part_rack_count"] = torch.zeros((b0.p_local, racks), dtype=torch.int32, device=dev)
    grp0 = em.groups[0]
    row("refresh_aggregates_local",
        lambda: refresh_aggregates(view0, c0.replica_broker, c0.replica_is_leader, c0.replica_disk,
                                   part0, members=pad0, group=grp0),
        lambda: refresh_plain(view0, c0.replica_broker, c0.replica_is_leader, c0.replica_disk,
                              part0, None),
        int(b0.r_local) * 33 + nbytes(*part0.values()), float(b0.r_local) * 12)
    out["kernels"] = rows
    out["bundle_bytes_per_step"] = nbytes(sh.ids, sh.rows, sh.parts, sh.mb, sh.ml)
    out["all_reduces_per_step"] = 4
    out["seconds"] = time.monotonic() - t_phase
    log(json.dumps({k: v for k, v in out.items() if k != "kernels"}))
    log(json.dumps({"phase": "model_shard_kernels", "card": smi, "kernels": rows}))
    eng.release()
    torch.cuda.empty_cache()
    return out


def kill_at_boundary(devices, rank: int, at: int, marks: dict, sig=None):
    """A scheduler checkpoint callback that, at slice boundary `at`, kills
    (SIGKILL, or `sig`) the process of `rank` of the live rank group of
    `devices`; the wall clock of the kill goes to marks["t_kill"]."""
    import signal

    from cruise_control_tpu_torch.parallel.ranks import live_group

    seen = {"n": 0}

    def chk():
        seen["n"] += 1
        if seen["n"] == at:
            g = live_group(devices)
            marks["pid"] = g.pids[rank]
            marks["t_kill"] = time.time()
            os.kill(g.pids[rank], sig if sig is not None else signal.SIGKILL)

    return chk


def check_mesh_ft_one_card(state, cfg, exact: dict, smi: str, devs=("cuda:0",)) -> dict:
    """Phase 30 (b): a 1x1 rank group over NCCL with mesh fault tolerance.
    A segmented run with a checkpoint every slice, and a resume from a
    mid-run checkpoint, are bit for bit phase 4's placements (`exact`;
    filled from a plain optimizer where empty).  Then a supervised
    "grid:1x1" optimizer with a controller checkpointing every slice,
    whose rank is SIGKILLed at the second slice boundary: the supervisor
    names DEVICE_LOST on cuda:0 (its device health and the controller's
    event), no mesh width is left, and the plain engine on the card
    answers, bit for bit phase 4, never the CPU.  The seconds from the
    kill to the typed error and to the answer are recorded.  `devs` lets
    the CPU rehearse it over a gloo rank."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, GoalOptimizer
    from cruise_control_tpu_torch.analyzer.engine import SegmentContext, segmented_execution
    from cruise_control_tpu_torch.common.device_watchdog import DeviceSupervisor
    from cruise_control_tpu_torch.parallel import GridEngine, MeshFtController, close_rank_groups, grid_mesh

    t_phase = time.monotonic()
    dev = str(state.device)
    devs = list(devs)
    if not exact:
        plain = GoalOptimizer(config=cfg, device=dev).optimize(state)
        exact.update({f: getattr(plain.state_after, f).clone() for f in PLACEMENT})
        exact["objective_after"] = plain.objective_after
    me = GridEngine(state, DEFAULT_CHAIN, mesh=grid_mesh(1, 1, devs), config=cfg, timeout_s=600)
    snaps = []
    ctx = SegmentContext(0.0, snapshot_every=1, snapshot_sink=snaps.append)
    t0 = time.monotonic()
    with segmented_execution(ctx):
        f_seg, h_seg, o_seg = me.run_reported()
    ctx.wait_snapshot()
    seg_s = time.monotonic() - t0
    ck = snaps[len(snaps) // 2]
    t0 = time.monotonic()
    f_res, h_res, _ = me.run_reported(resume=ck)
    res_s = time.monotonic() - t0
    out = dict(
        phase="mesh_ft_1x1", card=smi,
        segmented=dict(equal_phase4={f: bool(torch.equal(getattr(f_seg, f), exact[f])) for f in PLACEMENT},
                       segments=h_seg[-1]["segments"], snapshots=h_seg[-1].get("snapshots"),
                       snapshot_s=h_seg[-1].get("snapshot_s"), wall_s=seg_s,
                       objective_equal=bool(float(o_seg["obj_after"]) == float(exact["objective_after"]))),
        resumed=dict(from_round=h_res[-1].get("resumed_from_round"),
                     equal_phase4={f: bool(torch.equal(getattr(f_res, f), exact[f])) for f in PLACEMENT},
                     wall_s=res_s, checkpoints=len(snaps)))
    me.release()
    check(all(out["segmented"]["equal_phase4"].values()) and out["segmented"]["objective_equal"],
          f"the segmented 1x1 mesh run differs from phase 4: {out['segmented']}")
    check(all(out["resumed"]["equal_phase4"].values()),
          f"the resumed 1x1 mesh run differs from phase 4: {out['resumed']}")
    sup = DeviceSupervisor(op_timeout_s=300.0, max_retries=0, probe_timeout_s=10.0, device=dev)
    ft = MeshFtController(checkpoint_every_slices=1)
    opt = GoalOptimizer(config=cfg, device=dev, parallel_mode="grid:1x1", supervisor=sup,
                        mesh_ft=ft, mesh_max_devices=1)
    marks: dict = {}
    with segmented_execution(SegmentContext(0.0, kill_at_boundary(devs, 0, 2, marks))):
        res = opt.optimize(state)
    t_answer = time.time()
    event = ft.last_event or {}
    rec = next((h for h in res.history if h.get("mesh_ft")), {})
    health = sup.device_health()
    killed = dict(
        degraded=res.degraded, failure_class=event.get("failure_class"),
        lost_devices=rec.get("lost_devices"), width=rec.get("width"),
        device_health={k: v["healthy"] for k, v in health.items()},
        main_breaker=sup.breaker.state.value, width_breakers=ft.state_json()["breakers"],
        equal_phase4={f: bool(torch.equal(getattr(res.state_after, f), exact[f])) for f in PLACEMENT},
        kill_to_error_s=(event.get("ms", 0) / 1e3 - marks["t_kill"]) if "t_kill" in marks else None,
        kill_to_answer_s=t_answer - marks["t_kill"] if "t_kill" in marks else None,
        answer_on=str(res.state_after.replica_broker.device))
    out["killed"] = killed
    out["seconds"] = time.monotonic() - t_phase
    log(json.dumps(out))
    check("t_kill" in marks, "the rank was never killed")
    check(killed["failure_class"] == "device_lost" and killed["lost_devices"] == [0],
          f"the killed rank was not named DEVICE_LOST on cuda:0: {killed}")
    check(health.get(0, {}).get("healthy") is False, f"cuda:0's health does not show the loss: {health}")
    check(not res.degraded and killed["answer_on"] == dev,
          f"the ladder's floor did not answer from the card: {killed}")
    check(all(killed["equal_phase4"].values()), f"the floor's answer differs from phase 4: {killed}")
    check(sup.breaker.state.value == "closed", "the mesh failure opened the single-device breaker")
    for e in opt._engines.values():
        e.release()
    close_rank_groups()
    torch.cuda.empty_cache()
    return out


def goal_quality(chain, a, b) -> dict:
    """The float-load bar: every hard goal of both results at or below
    1e-6, the same violated set, and the objectives within 1e-6 of each
    other (the broker sums add in another order; a converged north-star
    objective is ~5e-9, at the f32 noise of its terms, so the bar is the
    violation threshold's, not relative)."""
    import numpy as np

    oa, va, _ = chain.evaluate(a)
    ob, vb, _ = chain.evaluate(b)
    hard = chain.hard_mask()
    va, vb = va.cpu().numpy(), vb.cpu().numpy()
    return dict(hard_max=[float(va[hard].max()), float(vb[hard].max())],
                violated_same=bool(((va > 1e-6) == (vb > 1e-6)).all()),
                objective=[float(oa), float(ob)],
                objective_rel_diff=float(abs(float(oa) - float(ob)) / max(abs(float(ob)), 1e-12)),
                ok=bool(float(va[hard].max()) <= 1e-6 and float(vb[hard].max()) <= 1e-6
                        and ((va > 1e-6) == (vb > 1e-6)).all()
                        and abs(float(oa) - float(ob)) <= 1e-6))


def placement_digest(final) -> str:
    """SHA-256 of a final state's placement columns."""
    import hashlib

    h = hashlib.sha256()
    for f in PLACEMENT:
        h.update(getattr(final, f).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def check_model_shard_cards(state, cfg, smi: str, devs, label: str = "north_star",
                            compare: bool = True) -> dict:
    """--mesh (c), and (d) at the mode's own target: the sharded-model mode
    1x4 over NCCL.  With loads rounded to integers its placements and
    objective are bit for bit the replicated 1x4's and the single-device
    engine's (`compare`); with the float loads, goal quality against the
    single-device engine (`compare`), and reproducibility: a repeated run
    of one engine and a run of a fresh engine on a fresh rank group give
    the same placements and objective, bit for bit, and after each run the
    four ranks hold the same replicated carry (`carry_digests`).  Per-card
    state bytes against the replicated mode, the all_reduces and bytes a
    step (measured by the ranks' own collective counts, and the analytic
    count), the refresh's float sum a round (the words each rank gathers
    and the device ms of the gather and fold) and the walls."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.parallel import ShardedEngine, close_rank_groups, model_mesh
    from cruise_control_tpu_torch.parallel.model_shard import loads_quantized, refresh_sum_words

    n = len(devs)
    padded = pad_state(state, shard_multiple_shape(state.shape, n))
    out = dict(phase=f"model_shard_cards_{label}", card=smi, cards=n, R=padded.shape.R,
               P=padded.shape.P, B=padded.shape.B)
    runs = {}
    for loads, st in (("integer", loads_quantized(padded, scale=1.0)), ("float", padded)):
        if loads == "integer" and not compare:
            continue
        t0 = time.monotonic()
        me = ShardedEngine(st, DEFAULT_CHAIN, mesh=model_mesh(devs), config=cfg, timeout_s=900,
                           model_shard_min_partitions=1)
        build_s = time.monotonic() - t0
        (f1, h1, o1), first_s = mesh_run(me)
        digests = [me.carry_digests()]
        (f2, h2, o2), repeat_s = mesh_run(me)
        digests.append(me.carry_digests())
        t = h2[-1]
        steps = sum(1 for h in h2 if "round" in h) * cfg.steps_per_round
        coll = t["model_collectives"]
        float_words = refresh_sum_words(st.shape)[0]
        sum_ms = [float(np.mean(ms)) for ms in me.last_info["float_sum_ms"]]
        rec = dict(build_s=build_s, first_run_s=first_s, repeat_wall_s=repeat_s,
                   model_sharded=t.get("model_sharded"), rank_state_bytes=me.build_info["rank_state_bytes"],
                   collectives_per_run=coll, steps=steps,
                   bytes_per_step_analytic=me.collective_bytes_per_step,
                   bytes_per_round_analytic=t["model_psum_bytes"],
                   rank_walls=me.last_info["rank_walls"], blocking_syncs=t["blocking_syncs"],
                   objective_after=float(o2["obj_after"]),
                   refresh_float_sum=dict(bytes_sent=4 * float_words,
                                          bytes_received=4 * float_words * n,
                                          ms_per_round_by_rank=sum_ms,
                                          rounds=len(me.last_info["float_sum_ms"][0])))
        me.release()
        if loads == "float":
            # a fresh engine on a fresh rank group (new rank processes)
            close_rank_groups()
            fresh = ShardedEngine(st, DEFAULT_CHAIN, mesh=model_mesh(devs), config=cfg, timeout_s=900,
                                  model_shard_min_partitions=1)
            (f3, _h3, o3), fresh_s = mesh_run(fresh)
            digests.append(fresh.carry_digests())
            fresh.release()
            runs3 = [(f1, o1, first_s), (f2, o2, repeat_s), (f3, o3, fresh_s)]
            rec["runs"] = [dict(run=name, wall_s=wall, placement_sha256=placement_digest(f),
                                objective_after=float(o["obj_after"]), rank_carry_sha1=d)
                           for name, (f, o, wall), d in zip(
                               ("engine1_run1", "engine1_run2", "engine2_fresh_group"), runs3,
                               digests)]
            rec["reproducible"] = bool(
                len({r["placement_sha256"] for r in rec["runs"]}) == 1
                and all(bits_equal(getattr(f, k), getattr(f1, k)) for f, _, _ in runs3
                        for k in PLACEMENT)
                and len({np.float32(r["objective_after"]).tobytes() for r in rec["runs"]}) == 1)
        # every rank's replicated carry (aggregates, key) after each run
        rec["ranks_agree"] = [len(set(d)) == 1 for d in digests]
        close_rank_groups()
        torch.cuda.empty_cache()
        if compare:
            plain = Engine(st, DEFAULT_CHAIN, config=cfg)
            pf, _ = plain.run()
            plain.release()
            if loads == "integer":
                rp = ShardedEngine(st, DEFAULT_CHAIN, mesh=model_mesh(devs), config=cfg, timeout_s=900)
                (rf, rh, ro), rep_s = mesh_run(rp)
                rec["replicated_rank_state_bytes"] = rp.build_info["rank_state_bytes"]
                rec["replicated_wall_s"] = rep_s
                rp.release()
                close_rank_groups()
                rec["equal_replicated"] = {f: bool(torch.equal(getattr(f2, f), getattr(rf, f)))
                                           for f in PLACEMENT}
                rec["equal_single"] = {f: bool(torch.equal(getattr(f2, f), getattr(pf, f).cpu()
                                                           .to(getattr(f2, f).device)))
                                       for f in PLACEMENT}
                rec["objective_equal"] = bool(float(o2["obj_after"]) == float(ro["obj_after"]))
                rec["exact"] = bool(all(rec["equal_replicated"].values())
                                    and all(rec["equal_single"].values()) and rec["objective_equal"])
            else:
                rec["goal_quality"] = goal_quality(DEFAULT_CHAIN, f2, pf)
            torch.cuda.empty_cache()
        runs[loads] = rec
        log(json.dumps(dict(phase=f"model_shard_cards_{label}", loads=loads, card=smi, **rec)))
        check(rec.get("exact", True), f"model shard 1x{n} with integer loads differs: {rec}")
        check(rec.get("reproducible", True) and all(rec.get("ranks_agree", [True])),
              f"model shard 1x{n} float loads: runs or ranks differ: {rec.get('runs')}")
        if "goal_quality" in rec:
            check(rec["goal_quality"]["ok"], f"model shard 1x{n} float loads: {rec['goal_quality']}")
    out["runs"] = runs
    return out


def check_mesh_ft_cards(state, cfg, smi: str, devs) -> dict:
    """--mesh (e): the width ladder on four cards.  A supervised "sharded"
    optimizer over cuda:0-3 with a controller checkpointing every slice;
    the rank on cuda:3 is SIGKILLed at the second slice boundary (after the
    first checkpoint): DEVICE_LOST names cuda:3, the engines touching it
    are purged and the others kept, the mesh is rebuilt at width 2 on
    cuda:0-1 and resumes, the final placements are bit for bit the
    uninterrupted run's, the result carries a `mesh_ft` record, and the
    facade's detector fires MESH_DEGRADED once.  Then one rank is
    SIGSTOPped mid-run: the supervisor's deadline probes the ranks and
    names it, a COLLECTIVE_STALL.  Seconds of detect, purge, rebuild and
    resume are recorded."""
    import signal
    import types

    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.engine import SegmentContext, segmented_execution
    from cruise_control_tpu_torch.common.device_watchdog import DeviceSupervisor
    from cruise_control_tpu_torch.parallel import MeshFtController, close_rank_groups
    from cruise_control_tpu_torch.service.facade import CruiseControl

    from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS
    from cruise_control_tpu_torch.parallel.ranks import device_ids

    dev = str(state.device)
    clean_opt = GoalOptimizer(config=cfg, device=dev, parallel_mode="sharded", mesh_max_devices=4)
    clean = clean_opt.optimize(state)
    for e in clean_opt._parallel_engines.values():
        e.release()
    close_rank_groups()
    sup = DeviceSupervisor(op_timeout_s=300.0, max_retries=0, probe_timeout_s=10.0, device=dev)
    ft = MeshFtController(checkpoint_every_slices=1)
    opt = GoalOptimizer(config=cfg, device=dev, parallel_mode="sharded", mesh_max_devices=4,
                        supervisor=sup, mesh_ft=ft)
    # an engine on the survivors' subset, cached beforehand, must survive the purge
    with opt._parallel_engine_for(state, DEFAULT_OPTIONS, cfg, devs[:2]):
        pass
    marks: dict = {}
    t0 = time.time()
    with segmented_execution(SegmentContext(0.0, kill_at_boundary(devs, 3, 2, marks))):
        res = opt.optimize(state)
    t_answer = time.time()
    rec = next((h for h in res.history if h.get("mesh_ft")), {})
    timing = next(h for h in res.history if h.get("timing"))
    event = dict(ft.last_event or {})
    stub = types.SimpleNamespace(optimizer=opt)
    fired = [CruiseControl._detect_mesh_degraded(stub) for _ in range(2)]
    cached = [list(k[3]) for k in opt._parallel_engines]
    killed = dict(
        failure_class=event.get("failure_class"), lost_devices=rec.get("lost_devices"),
        width=rec.get("width"), resumed=rec.get("resumed"),
        resumed_from_round=rec.get("resumed_from_round"), mesh_shape=timing.get("mesh_shape"),
        devices=timing.get("devices"), cached_engines=cached,
        equal_uninterrupted={f: bool(torch.equal(getattr(res.state_after, f),
                                                 getattr(clean.state_after, f))) for f in PLACEMENT},
        mesh_degraded_fired=[a is not None for a in fired], degraded=res.degraded,
        device_health={k: v["healthy"] for k, v in sup.device_health().items()},
        main_breaker=sup.breaker.state.value,
        detect_s=event.get("ms", 0) / 1e3 - marks.get("t_kill", t0),
        answer_s=t_answer - marks.get("t_kill", t0), wall_s=t_answer - t0,
        resumed_run_device_s=timing.get("device_s"), resumed_segments=timing.get("segments"))
    log(json.dumps(dict(phase="mesh_ft_cards_kill", card=smi, **killed)))
    check(killed["failure_class"] == "device_lost" and killed["lost_devices"] == [3],
          f"the SIGKILLed rank on cuda:3 was not named DEVICE_LOST: {killed}")
    check(killed["width"] == 2 and killed["devices"] == list(devs[:2]) and killed["resumed"],
          f"the ladder did not resume at width 2 on cuda:0-1: {killed}")
    check(all(killed["equal_uninterrupted"].values()), f"the resumed run differs: {killed}")
    check(all(3 not in device_ids(k) for k in cached) and any(k == list(devs[:2]) for k in cached),
          f"the purge is not scoped to cuda:3: {cached}")
    check(killed["mesh_degraded_fired"] == [True, False], f"MESH_DEGRADED fired {fired}")
    check(not res.degraded and killed["main_breaker"] == "closed", f"{killed}")
    for e in [*opt._parallel_engines.values(), *opt._engines.values()]:
        e.release()
    close_rank_groups()
    torch.cuda.empty_cache()
    # a stopped rank: the supervisor's deadline, the probes, a stall
    sup2 = DeviceSupervisor(op_timeout_s=45.0, max_retries=0, probe_timeout_s=10.0, device=dev)
    ft2 = MeshFtController(checkpoint_every_slices=1)
    opt2 = GoalOptimizer(config=cfg, device=dev, parallel_mode="sharded", mesh_max_devices=4,
                         supervisor=sup2, mesh_ft=ft2)
    marks2: dict = {}
    t0 = time.time()
    with segmented_execution(SegmentContext(0.0, kill_at_boundary(devs, 2, 2, marks2, signal.SIGSTOP))):
        res2 = opt2.optimize(state)
    event2 = dict(ft2.last_event or {})
    stalled = dict(failure_class=event2.get("failure_class"), lost_devices=event2.get("lost_devices"),
                   to_width=event2.get("to_width"), degraded=res2.degraded,
                   device_health={k: v["healthy"] for k, v in sup2.device_health().items()},
                   detect_s=event2.get("ms", 0) / 1e3 - marks2.get("t_kill", t0),
                   answer_s=time.time() - marks2.get("t_kill", t0),
                   equal_uninterrupted={f: bool(torch.equal(getattr(res2.state_after, f),
                                                            getattr(clean.state_after, f)))
                                        for f in PLACEMENT})
    log(json.dumps(dict(phase="mesh_ft_cards_stall", card=smi, **stalled)))
    check(stalled["failure_class"] == "collective_stall" and stalled["lost_devices"] == [2],
          f"the SIGSTOPped rank on cuda:2 was not named a COLLECTIVE_STALL: {stalled}")
    for e in [*opt2._parallel_engines.values(), *opt2._engines.values()]:
        e.release()
    close_rank_groups()
    torch.cuda.empty_cache()
    return dict(killed=killed, stalled=stalled)


def sticky_child() -> int:
    """Phase 22 (c), in a process of its own: one supervised optimize on a
    small fixture on the card, then a device-side assert inside
    "engine.run" (an out-of-range index on the card), then one more
    optimize.  Prints one JSON line; exits without CUDA teardown (the
    context is dead)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.common.device_watchdog import DeviceDegradedError, DeviceSupervisor
    from cruise_control_tpu_torch.testing import faults
    from cruise_control_tpu_torch.testing.fixtures import dead_broker_cluster

    state = dead_broker_cluster("cuda")
    sup = DeviceSupervisor(op_timeout_s=120.0, max_retries=2, breaker_failure_threshold=1,
                           probe_interval_s=0.0, device="cuda")
    opt = GoalOptimizer(config=OptimizerConfig(**FAST), device="cuda", supervisor=sup)
    first = opt.optimize(state)

    def device_assert(op, fn, args, kwargs):
        x = torch.zeros(4, device="cuda")
        x[torch.tensor([1 << 20], device="cuda")].sum()
        torch.cuda.synchronize()
        return fn(*args, **kwargs)

    def refusal(call) -> dict:
        t0 = time.monotonic()
        try:
            call()
        except DeviceDegradedError as e:
            return dict(raised=type(e).__name__, reason=e.reason, failure=repr(e)[:300],
                        wall_s=time.monotonic() - t0)
        return dict(raised=None)

    with faults.device_fault(device_assert, schedule=faults.first(1)):
        sticky = refusal(lambda: opt.optimize(state))
    sticky.update(retries=sup.num_retries, failure_counts=dict(sup.state_json()["failureCounts"]))

    def invoked(op, fn, args, kwargs):
        raise AssertionError(f"{op} invoked while the breaker is open")

    with faults.device_fault(invoked) as log2:
        second = refusal(lambda: opt.optimize(state))
    second.update(engine_calls=log2.total_calls, probes=sup.num_probes,
                  probe_failures=sup.num_probe_failures,
                  probe_diagnosis=(sup.state_json()["lastFailure"] or {}).get("error", "")[:300])
    out = dict(first=dict(degraded=first.degraded, proposals=len(first.proposals)),
               sticky=sticky, second=second)
    print(json.dumps(out), flush=True)
    sys.stderr.flush()
    os._exit(0)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--sticky-child"]:
        return sticky_child()
    if sys.argv[1:] not in ([], ["--monitor"], ["--executor"], ["--kafka"], ["--service"], ["--controller"],
                            ["--mesh"], ["--model-shard"]):
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # a hang leaves every thread's stack on standard error before the
    # script's 1200 s limit ends it
    faulthandler.dump_traceback_later(1140, exit=False)
    import numpy as np

    from cruise_control_tpu_torch import native
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.kernels import _build
    from cruise_control_tpu_torch.kernels import schedule as sched_k
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, prior_table, random_cluster_fast

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.monotonic()
    took = _build.build()
    runtime, driver = sched_k.cuda_versions()
    log(json.dumps({"phase": "build", "seconds": time.monotonic() - t0,
                    "per_library_s": took, "dir": str(_build.BUILD_DIR.relative_to(ROOT)),
                    "cuda_runtime": runtime, "cuda_driver": driver}))
    # the monitor's native serde (host C++, g++), phase 23's
    t0 = time.monotonic()
    check(native.native_available(), "the native serde did not build")
    log(json.dumps({"phase": "build_native", "seconds": time.monotonic() - t0,
                    "library": str(native.library_path().relative_to(ROOT))}))
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = OptimizerConfig(**SEARCH)
    t0 = time.monotonic()
    state = random_cluster_fast(RandomClusterSpec(**NORTH_STAR_SPEC), seed=42, device="cuda")
    torch.cuda.synchronize()
    s = state.shape
    log(json.dumps({"phase": "fixture", "seconds": time.monotonic() - t0, "brokers": s.B,
                    "partitions": s.P, "replicas": s.R, "topics": s.num_topics, "racks": s.num_racks}))
    if sys.argv[1:] == ["--monitor"]:
        check_monitor(state, cfg)
        print(json.dumps({"ok": True, "phases": [1, 23]}), flush=True)
        return 0
    if sys.argv[1:] == ["--executor"]:
        _, monitored = check_monitor(state, cfg)
        del state
        torch.cuda.empty_cache()
        check_executor(cfg, monitored)
        print(json.dumps({"ok": True, "phases": [1, 23, 24]}), flush=True)
        return 0
    if sys.argv[1:] == ["--kafka"]:
        _, monitored = check_monitor(state, cfg)
        del state
        torch.cuda.empty_cache()
        check_kafka(cfg, monitored)
        print(json.dumps({"ok": True, "phases": [1, 23, 25]}), flush=True)
        return 0
    if sys.argv[1:] == ["--service"]:
        _, monitored = check_monitor(state, cfg)
        del state
        torch.cuda.empty_cache()
        check_service(cfg, monitored, smi)
        print(json.dumps({"ok": True, "phases": [1, 23, 27]}), flush=True)
        return 0
    if sys.argv[1:] == ["--controller"]:
        _, monitored = check_monitor(state, cfg)
        del state
        torch.cuda.empty_cache()
        check_controller(cfg, monitored, smi)
        print(json.dumps({"ok": True, "phases": [1, 23, 28]}), flush=True)
        return 0
    if sys.argv[1:] == ["--model-shard"]:
        check_model_shard_step(state, cfg, smi)
        check_mesh_ft_one_card(state, cfg, {}, smi)
        print(json.dumps({"ok": True, "phases": [1, "30a", "30b"]}), flush=True)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        t29 = time.monotonic()
        check_mesh_slices(state, cfg)
        exact_mesh: dict = {}
        check_mesh_one_card(state, cfg, exact_mesh, smi)
        log(json.dumps({"phase": "mesh", "seconds": time.monotonic() - t29}))
        phases = [1, 29]
        if torch.cuda.device_count() >= 4:
            devs = [f"cuda:{i}" for i in range(4)]
            check_mesh_cards(state, cfg, exact_mesh, smi)
            phases.append("29c")
            # phase 30 (c)-(e): the sharded-model mode and the ladder on four cards
            t30 = time.monotonic()
            check_model_shard_cards(state, cfg, smi, devs)
            phases.append("30c")
            check_mesh_ft_cards(state, cfg, smi, devs)
            phases.append("30e")
            del state
            torch.cuda.empty_cache()
            target = random_cluster_fast(RandomClusterSpec(**TARGET_SPEC), seed=42, device="cuda")
            torch.cuda.synchronize()
            check_model_shard_cards(target, cfg, smi, devs, label="target", compare=False)
            phases.append("30d")
            log(json.dumps({"phase": "model_shard_cards", "seconds": time.monotonic() - t30}))
        print(json.dumps({"ok": True, "phases": phases, "cards": torch.cuda.device_count()}), flush=True)
        return 0

    # phase 2: kernels against their plain versions on one real step
    kstats = check_kernels(state, cfg)
    torch.cuda.empty_cache()

    # phase 3: a small cluster on the card agrees with the CPU run
    check_small_cluster()

    # phases 4-21 have no supervisor: no answer of theirs may be degraded
    audit = contextlib.ExitStack()
    audit.enter_context(card_answers_only())
    # phase 4: the main path, twice with the same seed: the anneal is
    # deterministic on the card, so placements, rounds and proposals agree
    opt = GoalOptimizer(config=cfg, device="cuda")
    res4, launches = run_proposal(opt, state, "north_star_proposal")
    again, launches_again = run_proposal(opt, state, "north_star_proposal_repeat")
    same = {
        f: bool(torch.equal(getattr(res4.state_after, f), getattr(again.state_after, f)))
        for f in ("replica_broker", "replica_is_leader", "replica_disk")
    }
    rounds = [len([h for h in r.history if "round" in h]) for r in (res4, again)]
    log(json.dumps({"phase": "determinism", "identical": same, "rounds": rounds,
                    "proposals": [len(res4.proposals), len(again.proposals)],
                    "launches_equal": launches == launches_again}))
    check(all(same.values()), f"two proposals with the same seed differ: {same}")
    check(rounds[0] == rounds[1], f"two proposals with the same seed ran {rounds} rounds")
    check(len(res4.proposals) == len(again.proposals), "two proposals with the same seed differ in size")
    exact = {f: getattr(res4.state_after, f).clone() for f in PLACEMENT}
    PLACEMENTS["4"] = {f: exact[f] for f in PLACEMENT}
    exact.update(objective_before=res4.objective_before, objective_after=res4.objective_after,
                 violated_after=res4.violated_goals_after(), proposals=len(res4.proposals),
                 rounds=rounds[0], accepted=[h["accepted"] for h in res4.history if "round" in h])
    # phase 13's tables: the prior fitted on this run's moves at mix 0.5 and
    # 1.0, and a seeded table of testing/fixtures.py at mix 0.25
    fitted = [fit_prior(res4, state, mix) for mix in (0.5, 1.0)]
    prior_tables = [f[0] for f in fitted] + [prior_table(s, 7, 0.25)]
    log(json.dumps({"phase": "prior_fit", "pairs": fitted[0][1],
                    "topics_with_mass": int((prior_tables[0].weights.sum(1) > 0).sum())}))
    walls4 = [res4.wall_seconds, again.wall_seconds]
    del res4, again

    # phase 5: decommission 1% of the brokers on the same optimizer
    B = s.B
    n_dead = max(2, B // 100)
    alive = state.broker_alive.clone()
    alive[B - n_dead:] = False
    offline = state.replica_offline | ~alive[state.replica_broker]
    decom = dataclasses.replace(
        state, broker_alive=alive, disk_alive=alive[:, None] & state.disk_alive,
        replica_offline=offline,
    )
    res5, _ = run_proposal(opt, decom, "decommission")
    check(opt.engine_cache_hits == 2 and opt.engine_cache_misses == 1, "later requests did not rebind")
    check_generation(res5, decom, cfg, "decommission",
                     dict(north_star_first=walls4[0], north_star_repeat=walls4[1]))
    after = res5.state_after
    on_dead = after.replica_valid & ~after.broker_alive[after.replica_broker]
    remaining = int(on_dead.sum())
    log(json.dumps({"phase": "decommission_check", "dead_brokers": n_dead,
                    "offline_before": int(offline.sum()), "offline_after": remaining}))
    check(remaining == 0, f"{remaining} replicas left on dead brokers")
    PLACEMENTS["5"] = {f: getattr(after, f).clone() for f in PLACEMENT}

    for engine in opt._engines.values():
        engine.release()
    del res5, opt

    # phase 6: the graph route against the legacy route at T=0
    compare_routes(state, cfg, "north_star")
    compare_routes(decom, cfg, "decommission")

    # phase 7: where the time goes (outside the counted runs)
    profile_fused(state, cfg)
    profile_steps(state, cfg)
    torch.cuda.empty_cache()

    # phases 8-9: the JBOD path (configuration 3, rebalance_disk)
    jbod = check_jbod(cfg)
    # phase 10: the bucket-padded north star against phase 4's exact run
    check_bucketed(state, cfg, exact)
    # phase 11: warm starts on the north star
    check_warm_start(state, cfg, exact)
    torch.cuda.empty_cache()
    # phase 12: convergence diagnostics on the north star
    variants = {"select_survivors_diag": check_diagnostics(state, cfg, exact)}
    # phase 13: the learned prior on the north star
    variants["candidates_prior"] = check_prior(state, cfg, exact, *prior_tables)
    # phase 14: bf16 scoring on the north star
    variants["candidates_bf16"] = check_bf16(state, cfg, exact)
    torch.cuda.empty_cache()
    # phase 15: the streaming replay at full width, with phase 13's fitted
    # prior at mix 0.5, refreshed every window
    variants["scatter_loads"] = check_streaming(state, cfg, fitted[0][2], fitted[0][3])
    torch.cuda.empty_cache()
    # phase 16: 32 north-star what-ifs as one batch graph launch
    scenario_launches = check_scenarios(state)
    check_placement_batch(state)
    variants["scenario_step"] = check_scenario_step()
    variants["scenario_step"]["launches"] = scenario_launches["scenario_step"]
    # phase 17: the planner end to end (simulate with fixes, rightsize)
    check_planner(state, cfg)
    # phase 18: the greedy oracle on the card
    check_greedy()
    # phase 19: two threads optimizing through one GoalOptimizer
    check_threads(state, cfg, exact)
    # phase 20: a bucket prewarmed on the warm pool beside a request
    check_prewarm(state, cfg, exact)
    # phase 21: segmented execution under the device scheduler, a
    # same-bucket preemption, and the node floor of the control kernels
    seg = check_segmented(state, decom, cfg, exact)
    for name in ("round_schedule", "scenario_step"):
        log(json.dumps({"phase": "control_kernel_floor", "name": name,
                        "node_floor_ms": seg["floor"]["node_ms"],
                        "byte_bound_ms": (kstats[name] if name in kstats else variants[name])["bound_ms"]}))
    audit.close()
    log(json.dumps({"phase": "degraded_audit", "checked": AUDIT}))
    check(all(AUDIT.get(k, 0) > 0 for k in ("optimize", "streaming_cycle", "scenario_batch",
                                            "scenario_outcome")),
          f"phases 4-21 did not pass every kind of answer through the audit: {AUDIT}")
    # phase 22: supervision on the card (real OOM, hang, sticky error,
    # supervised scenario batch)
    check_supervision(state, cfg, exact)
    torch.cuda.empty_cache()
    # phase 23: the monitor on the card, from the north star's topology
    _, monitored = check_monitor(state, cfg)
    torch.cuda.empty_cache()
    # phase 24: the self-healing loop (detect, fix, execute, crash and
    # recover) on phase 23's monitored cluster
    check_executor(cfg, monitored)
    torch.cuda.empty_cache()
    # phase 25: the real-cluster loop over the Kafka wire protocol
    check_kafka(cfg, monitored)
    torch.cuda.empty_cache()
    # phase 26: BASELINE configuration 2 against the converged greedy baseline
    check_config2()
    torch.cuda.empty_cache()
    # phase 27: the REST service on the card over phase 23's cluster
    check_service(cfg, monitored, smi)
    torch.cuda.empty_cache()
    # phase 28: the streaming controller through the service, phase 23's
    # cluster and windows
    check_controller(cfg, monitored, smi)
    del monitored
    torch.cuda.empty_cache()
    # phase 29: the replicated mesh: the candidate slice, and a 1x1 rank
    # group over NCCL against phase 4's single-device run
    t29 = time.monotonic()
    check_mesh_slices(state, cfg)
    check_mesh_one_card(state, cfg, {f: PLACEMENTS["4"][f] for f in PLACEMENT}
                        | {"objective_after": exact["objective_after"]}, smi)
    log(json.dumps({"phase": "mesh", "seconds": time.monotonic() - t29}))
    # phase 30: the sharded-model step emulated on one card, and a 1x1
    # rank group with mesh fault tolerance against phase 4
    t30 = time.monotonic()
    shard = check_model_shard_step(state, cfg, smi)
    check_mesh_ft_one_card(state, cfg, {f: PLACEMENTS["4"][f] for f in PLACEMENT}
                           | {"objective_after": exact["objective_after"]}, smi)
    log(json.dumps({"phase": "model_shard", "seconds": time.monotonic() - t30}))

    rows = []
    for name, (src, replaces) in SOURCES.items():
        k = kstats[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"cruise_control_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "ms_source": k["ms_source"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
        })
    for name, (src, replaces) in SHARD_CASES.items():
        k = shard["kernels"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"cruise_control_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": k["launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "ms_source": k["ms_source"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    for name, (src, replaces) in {**JBOD_CASES, **VARIANT_CASES, **STREAM_CASES, **SCENARIO_CASES}.items():
        k = jbod[name] if name in jbod else variants[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"cruise_control_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": k["launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "ms_source": k["ms_source"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    check(all(np.isfinite([r["ms"], r["plain_ms"], r["bound_ms"]]).all() for r in rows),
          "non-finite kernel timing")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
