"""The port's prewarm: the boot manifest, the warm pool, GoalOptimizer.prewarm,
capture attribution and the capture accounting, on the CPU.

tests/test_prewarm.py's manifest tests, its warm-pool priority test and its
boot-report test, pointed at the port's counterparts, beside the port's own
contract: a prewarm builds and never rebinds, leaves the hit and miss
counters alone, holds its engine pinned until the warm pool is done with
it, and hands a capture's error to the run that waits for it.  On the CPU
an engine has no graphs: the warm pool allocates its run's buffers, which
the first request then uses.  The JAX package's AOT-artifact tests have no
counterpart in the port (ROADMAP.md); its two service tests that set no
`controller.enabled` are at the end (marked slow, as in the JAX package),
and test_controller_first_cycle_waits_for_boot_gate after them.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer import GoalOptimizer
from cruise_control_tpu_torch.analyzer import engine as engine_mod
from cruise_control_tpu_torch.analyzer.engine import Engine, OptimizerConfig, _WarmPool
from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN, GoalChain
from cruise_control_tpu_torch.analyzer.prewarm import PrewarmStore, bucket_key
from cruise_control_tpu_torch.common import compilation_cache, profiling
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT
from cruise_control_tpu_torch.models.builder import pad_state, prewarm_state
from cruise_control_tpu_torch.models.state import ClusterShape
from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

CFG = OptimizerConfig(num_candidates=128, leadership_candidates=32, swap_candidates=16,
                      steps_per_round=8, num_rounds=2, seed=0)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


@pytest.fixture(scope="module")
def state():
    return random_cluster_fast(RandomClusterSpec(num_brokers=10, num_partitions=160, num_racks=4,
                                                 num_topics=6, skew=1.0), seed=3, device="cpu")


def _store(tmp_path, **kw):
    kw.setdefault("chain", DEFAULT_CHAIN)
    kw.setdefault("constraint", DEFAULT_CONSTRAINT)
    return PrewarmStore(str(tmp_path), **kw)


def _same_placement(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in PLACEMENT)


def _padded(state):
    s = state.shape
    return pad_state(state, dataclasses.replace(s, num_replicas=s.R + 64, num_brokers=s.B + 2))


# ---------------------------------------------------------------- manifest


def test_manifest_round_trip(tmp_path, state):
    store = _store(tmp_path)
    store.note(state.shape, 3, CFG, parallel_mode="single")
    # dedup: the same (bucket, config) noted again is ONE entry
    store.note(state.shape, 3, CFG, parallel_mode="single")
    doc = json.load(open(store.manifest_path))
    assert len(doc["entries"]) == 1
    # the second note is a recency touch: deduped in memory (uses=2); its
    # write is throttled, so the file may still say uses=1
    assert next(iter(store._entries.values()))["uses"] == 2

    fresh = _store(tmp_path)
    rows = fresh.claim_boot_entries()
    assert len(rows) == 1
    shape, max_rf, cfg, pmode = fresh.entry_engine_inputs(rows[0])
    assert shape == state.shape and max_rf == 3
    assert cfg == CFG  # exact dataclass equality: the engine-cache key
    assert pmode == "single"
    # claimed once per store: a second claim gets []
    assert fresh.claim_boot_entries() == []


def test_manifest_rejects_foreign_environment(tmp_path, state):
    store = _store(tmp_path)
    store.note(state.shape, 2, CFG)
    other = _store(tmp_path, chain=GoalChain.from_names(["ReplicaCapacityGoal"]))
    assert other.claim_boot_entries() == []  # chain fingerprint mismatch
    assert _store(tmp_path).claim_boot_entries()  # the same environment still claims


def test_manifest_version_and_corruption_tolerance(tmp_path, state):
    store = _store(tmp_path)
    store.note(state.shape, 2, CFG)
    doc = json.load(open(store.manifest_path))
    doc["version"] = 99
    open(store.manifest_path, "w").write(json.dumps(doc))
    assert _store(tmp_path).claim_boot_entries() == []
    open(store.manifest_path, "w").write("{ not json")
    assert _store(tmp_path).claim_boot_entries() == []
    # a corrupt file never breaks recording: the next note rebuilds it
    store2 = _store(tmp_path)
    store2.note(state.shape, 2, CFG)
    assert _store(tmp_path).claim_boot_entries()


def test_manifest_merges_concurrent_stores_not_last_writer_wins(tmp_path):
    """Two stores over one directory union their working sets."""
    a, b = _store(tmp_path), _store(tmp_path)
    s1 = ClusterShape(32, 8, 8, 2, 2, 8, 1)
    s2 = ClusterShape(64, 16, 16, 4, 2, 16, 1)
    a.note(s1, 2, CFG)
    b.note(s2, 2, CFG)  # b never saw a's entry in memory
    assert set(_store(tmp_path).manifest_bucket_keys()) == {bucket_key(s1), bucket_key(s2)}


def test_manifest_bounded_by_max_entries(tmp_path):
    store = _store(tmp_path, max_entries=2)
    for k in (1, 2, 3):
        store.note(ClusterShape(32 * k, 8, 8, 2, 2, 8, 1), 2, CFG)
        time.sleep(0.002)  # distinct last_used_ms for the recency order
    rows = _store(tmp_path, max_entries=2).claim_boot_entries()
    # the most recent two survive, the most recent first
    assert [r["bucket"]["R"] for r in rows] == [96, 64]


def test_fingerprint_covers_the_kernel_sources(tmp_path, monkeypatch):
    """A change of the port's engine, model or kernel sources (the CUDA
    sources included) changes the environment: its entries are skipped."""
    from cruise_control_tpu_torch.analyzer import prewarm

    a = prewarm.environment_fingerprint(DEFAULT_CHAIN, DEFAULT_CONSTRAINT)
    monkeypatch.setattr(prewarm, "_source_digest_cache", "another")
    assert prewarm.environment_fingerprint(DEFAULT_CHAIN, DEFAULT_CONSTRAINT) != a
    monkeypatch.setattr(prewarm, "_source_digest_cache", None)
    assert prewarm._source_digest() == prewarm._source_digest_cache
    pkg = os.path.dirname(os.path.dirname(prewarm.__file__))
    assert os.path.isfile(os.path.join(pkg, "kernels", "csrc", "candidates.cu"))


# -------------------------------------------------- compilation_cache scan


def test_scan_and_boot_report_under_concurrent_writer(tmp_path):
    d = str(tmp_path / "cache")
    os.makedirs(d)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            p = os.path.join(d, f"entry-{i % 17}")
            try:
                with open(p, "wb") as f:
                    f.write(b"x" * 128)
                if i % 3 == 0:
                    os.unlink(p)
            except OSError:
                pass
            i += 1

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(200):
            entries, total = compilation_cache._scan(d)
            assert total >= 0 and isinstance(entries, set)
        report = compilation_cache.boot_report()
        assert report is None or "engineCaptures" in report
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()


def test_boot_report_names_the_kernel_libraries_and_captures(tmp_path, monkeypatch):
    from cruise_control_tpu_torch.kernels import _build

    for name in ("_enabled", "_boot_entries", "_cache_dir"):
        monkeypatch.setattr(compilation_cache, name, getattr(compilation_cache, name))
    monkeypatch.setattr(compilation_cache, "_enabled", False)
    monkeypatch.setattr(_build, "REUSED", {"apply"})
    monkeypatch.setattr(_build, "BUILT", {"candidates"})
    d = tmp_path / "build"
    d.mkdir()
    (d / "apply-0.so").write_bytes(b"x")
    assert compilation_cache.enable_persistent_cache(str(d)) == str(d)
    (d / "candidates-0.so").write_bytes(b"xy")
    compilation_cache.reset_engine_capture_counts()
    compilation_cache.record_engine_capture("R8.B2.P4.T1", source="prewarm")
    compilation_cache.record_engine_capture("R8.B2.P4.T1", source="request")
    compilation_cache.record_engine_capture("R8.B2.P4.T1", source="prewarm")
    with pytest.raises(ValueError):
        compilation_cache.record_engine_capture("R8.B2.P4.T1", source="aot")
    r = compilation_cache.boot_report()
    assert (r["entriesAtBoot"], r["newEntries"], r["entries"], r["bytes"]) == (1, 1, 2, 3)
    assert r["librariesReused"] == ["apply"] and r["librariesBuilt"] == ["candidates"]
    assert r["engineCaptures"] == {"R8.B2.P4.T1": {"request": 1, "prewarm": 2}}
    compilation_cache.reset_engine_capture_counts()


def test_device_gauges_read_zero_without_a_card():
    class Sensors:
        def __init__(self):
            self.gauges, self.collectors = {}, {}

        def gauge(self, name, fn):
            self.gauges[name] = fn

        def collector(self, name, fn):
            self.collectors[name] = fn

    sensors = Sensors()
    tracker = profiling.register_device_gauges(sensors)
    assert set(sensors.gauges) == {"tpu.device.memory-in-use-bytes", "tpu.device.memory-limit-bytes",
                                   "tpu.device.live-buffers"}
    assert all(fn() == 0.0 for fn in sensors.gauges.values())
    tracker.record("R8.B2.P4.T1")
    assert sensors.collectors["tpu.device.peak-live-bytes-by-bucket"]() == []
    assert sensors.collectors["tpu.device.memory-by-device"]() == []
    assert profiling.per_device_live_bytes() == {}


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with profiling.profiler_trace(None) as off:
        assert off is None


# ------------------------------------------------------ warm-pool priority


def test_warm_pool_runs_higher_priority_first():
    pool = _WarmPool()
    release = threading.Event()
    order: list[str] = []
    blocker = pool.submit(lambda: release.wait(10))
    lo = pool.submit(lambda: order.append("speculative"), priority=100)
    hi = pool.submit(lambda: order.append("active"), priority=0)
    release.set()
    blocker.result(10)
    hi.result(10)
    lo.result(10)
    assert order == ["active", "speculative"]


# ------------------------------------------------------ GoalOptimizer.prewarm


def test_prewarm_builds_without_counting_and_the_request_hits(state):
    """A prewarmed bucket's first request finds its engine (a hit, no
    miss), whose buffers the warm pool made, and runs what an unprewarmed
    optimizer runs."""
    padded = _padded(state)
    opt = GoalOptimizer(config=CFG, device="cpu")
    opt.prewarm(padded, priority=0)
    assert (opt.engine_cache_hits, opt.engine_cache_misses) == (0, 0)
    assert opt.has_engine_for(padded.shape)
    (engine,) = opt._engines.values()
    engine._warm.result(60)
    assert engine._ws is not None
    ws = engine._ws
    res = opt.optimize(padded)
    assert (opt.engine_cache_hits, opt.engine_cache_misses) == (1, 0)
    assert engine._ws is ws
    cold = GoalOptimizer(config=CFG, device="cpu").optimize(padded)
    assert _same_placement(res.state_after, cold.state_after)
    assert [h for h in res.history if "round" in h] == [h for h in cold.history if "round" in h]
    row = opt.compile_attribution()[bucket_key(padded.shape)]
    assert row["buildSeconds"] > 0.0 and row["compiles"] == 0  # nothing to capture on the CPU


def test_prewarm_never_rebinds_a_cached_engine(state):
    opt = GoalOptimizer(config=CFG, device="cpu")
    opt.optimize(state)
    (engine,) = opt._engines.values()
    bound, statics = engine._state, engine.statics
    other = dataclasses.replace(state, broker_capacity=state.broker_capacity * 2.0)
    opt.prewarm(other)
    assert engine._state is bound and engine.statics is statics
    assert engine._warm is None  # no capture submitted for a cached bucket
    assert (opt.engine_cache_hits, opt.engine_cache_misses) == (0, 1)
    assert len(opt._engines) == 1


def _wider(state):
    """A placeholder generation of `state`'s shape whose member table is one
    wider (another max_rf): another bucket."""
    from cruise_control_tpu_torch.models.state import member_width

    wide = prewarm_state(state.shape, max_rf=member_width(state) + 1, device="cpu")
    assert member_width(wide) == member_width(state) + 1
    return wide


def test_prewarm_of_another_width_builds_its_engine(state):
    """max_rf is part of the bucket: a prewarm of a cached shape at another
    member-table width builds and warms that width's engine and leaves the
    cached one as it is; has_engine_for tells the widths apart."""
    from cruise_control_tpu_torch.models.state import member_width

    opt = GoalOptimizer(config=CFG, device="cpu")
    opt.optimize(state)
    (engine,) = opt._engines.values()
    bound, ws, rf = engine._state, engine._ws, member_width(state)
    wide = _wider(state)
    assert not opt.has_engine_for(state.shape, max_rf=rf + 1)
    opt.prewarm(wide)
    assert len(opt._engines) == 2 and (opt.engine_cache_hits, opt.engine_cache_misses) == (0, 1)
    assert engine._state is bound and engine._ws is ws
    warm = next(e for e in opt._engines.values() if e is not engine)
    warm._warm.result(60)
    assert warm.max_rf == rf + 1 and warm._ws is not None
    assert opt.has_engine_for(state.shape, max_rf=rf) and opt.has_engine_for(state.shape, max_rf=rf + 1)
    assert opt.has_engine_for(state.shape) and not opt.has_engine_for(state.shape, max_rf=rf + 2)
    opt.optimize(wide)
    assert (opt.engine_cache_hits, opt.engine_cache_misses) == (1, 1) and warm._ws is not None


def test_alternating_widths_keep_an_engine_each(state):
    """Generations of one shape that alternate between two member-table
    widths run on one engine each: after the first of each width no
    engine is built or released (each keeps its workspace, which holds its
    graphs on the card), and each run is a fresh optimizer's."""
    wide = _wider(state)
    opt = GoalOptimizer(config=CFG, device="cpu")
    want = {id(st): GoalOptimizer(config=CFG, device="cpu").optimize(st) for st in (state, wide)}
    kept = None
    for st in (state, wide, state, wide, state):
        res = opt.optimize(st)
        assert _same_placement(res.state_after, want[id(st)].state_after)
        workspaces = {e.max_rf: e._ws for e in opt._engines.values()}
        assert None not in workspaces.values()
        if len(workspaces) == 2:
            kept = kept or {rf: id(ws) for rf, ws in workspaces.items()}
            assert {rf: id(ws) for rf, ws in workspaces.items()} == kept
    assert (opt.engine_cache_hits, opt.engine_cache_misses) == (3, 2)


def test_prewarm_pins_the_engine_until_the_pool_is_done(state, monkeypatch):
    """An engine whose warm-up is in flight counts as pinned: evicting it
    meanwhile releases it only when the warm pool is done with it."""
    gate = threading.Event()
    real = Engine._warm_up
    monkeypatch.setattr(Engine, "_warm_up", lambda self: (gate.wait(30), real(self))[1])
    opt = GoalOptimizer(config=CFG, device="cpu", engine_cache_size=1)
    padded = _padded(state)
    opt.prewarm(padded)
    (engine,) = opt._engines.values()
    assert engine._cc_pins == 1 and not engine._warm.done()
    opt.optimize(state)  # another bucket: evicts the prewarmed engine
    assert engine._cc_evicted and engine._warm is not None  # not released while pinned
    gate.set()
    deadline = time.monotonic() + 30
    while engine._warm is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine._cc_pins == 0 and engine._warm is None and engine._ws is None


def test_a_warm_pool_error_is_raised_to_the_waiting_run(state, monkeypatch):
    def boom(self):
        raise RuntimeError("capture failed on the warm pool")

    monkeypatch.setattr(Engine, "_warm_up", boom)
    opt = GoalOptimizer(config=CFG, device="cpu")
    padded = _padded(state)
    opt.prewarm(padded)
    for _ in range(2):  # every run of the engine raises it: its graphs were never made
        with pytest.raises(RuntimeError, match="capture failed on the warm pool"):
            opt.optimize(padded)
    (engine,) = opt._engines.values()
    assert engine._cc_pins == 0


def test_capture_attribution_by_bucket(state):
    """Each engine bills its captures to its own bucket (the CPU has no
    graphs, so the captures are the engine's `on_capture` calls, as its
    `_capture` makes them on the card), beside each bucket's build."""
    opt = GoalOptimizer(config=CFG, device="cpu")
    padded = _padded(state)
    opt.optimize(state)
    opt.prewarm(padded)
    engines = {bucket_key(k[0]): e for k, e in opt._engines.items()}
    assert set(engines) == {bucket_key(state.shape), bucket_key(padded.shape)}
    engines[bucket_key(state.shape)].on_capture(0.25, "request")
    engines[bucket_key(padded.shape)].on_capture(0.5, "prewarm")
    engines[bucket_key(padded.shape)].on_capture(0.125, "prewarm")
    rows = opt.compile_attribution()
    assert rows[bucket_key(state.shape)]["compiles"] == 1
    assert rows[bucket_key(state.shape)]["captureSeconds"] == 0.25
    assert rows[bucket_key(padded.shape)]["compiles"] == 2
    assert rows[bucket_key(padded.shape)]["captureSeconds"] == 0.625
    assert all(r["buildSeconds"] > 0.0 and r["coldWallSeconds"] == 0.0 for r in rows.values())
    assert {v["bucket"]: w for v, w in opt.compile_attribution_values()} == {k: 0.0 for k in rows}


def test_optimizer_notes_its_buckets_and_boot_prewarms_them(tmp_path, state):
    """A run records its bucket (with max_rf) in the manifest; a new
    process's optimizer prewarms the claimed entry from a placeholder
    state of that bucket, and the bucket's request then hits."""
    opt = GoalOptimizer(config=CFG, device="cpu", prewarm_store=_store(tmp_path))
    opt.optimize(state)
    (engine,) = opt._engines.values()
    (row,) = _store(tmp_path).claim_boot_entries()
    shape, max_rf, cfg, _ = PrewarmStore.entry_engine_inputs(row)
    assert (shape, max_rf, cfg) == (state.shape, engine.max_rf, CFG)
    boot = GoalOptimizer(config=CFG, device="cpu")
    boot.prewarm(prewarm_state(shape, max_rf=max_rf, device="cpu"), config=cfg)
    assert boot.has_engine_for(shape, config=cfg)
    res = boot.optimize(state)
    assert (boot.engine_cache_hits, boot.engine_cache_misses) == (1, 0)
    assert np.isfinite(res.objective_after)
    assert engine_mod.bucket_key(shape) == bucket_key(shape)


# ------------------------- the service's boot prewarm (tests/test_prewarm.py :376-459)


def _service(props, tmp, seed=3, **geometry):
    from cruise_control_tpu_torch.config.app_config import CruiseControlConfig
    from cruise_control_tpu_torch.service.main import build_simulated_service

    base = {
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "num.partition.metrics.windows": 3,
        "webserver.http.port": 0,
        "tpu.num.candidates": 128, "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 8, "tpu.num.rounds": 2,
        "tpu.compile.cache.dir": os.path.join(tmp, "xla"),
        "tpu.prewarm.manifest.dir": os.path.join(tmp, "prewarm"),
    }
    base.update(props)
    return build_simulated_service(CruiseControlConfig(base), seed=seed, **geometry, device="cpu")


@pytest.mark.slow
def test_start_up_boot_prewarms_manifest_bucket(tmp_path):
    from cruise_control_tpu_torch.service.progress import OperationProgress

    tmp = str(tmp_path)
    app, fetcher, admin, sampler = _service({}, tmp)
    cc = app.cc
    r1 = cc.proposals(OperationProgress(), ignore_cache=True)
    cc.core.prewarm_store.drain(300)
    cc.shutdown()

    app2, fetcher2, admin2, sampler2 = _service({}, tmp)
    cc2 = app2.cc
    cc2.start_up(detection_interval_s=3600)
    assert cc2._boot_prewarm_done.wait(120)
    assert cc2.optimizer.has_engine_for(r1.state_before.shape)
    snap = cc2.sensors.snapshot()
    assert snap["analyzer.boot-prewarm-buckets"]["count"] >= 1
    r2 = cc2.proposals(OperationProgress(), ignore_cache=True)
    assert _same_placement(r1.state_after, r2.state_after)
    cc2.shutdown()


@pytest.mark.slow
def test_fleet_facades_merge_one_manifest_and_both_prewarm(tmp_path):
    """Fleet satellite: two clusters with DIFFERENT shape buckets over
    one shared AnalyzerCore record into ONE merged manifest (dedup, not
    last-writer-wins), and a restart prewarns BOTH clusters' buckets."""
    from cruise_control_tpu_torch.service.main import build_simulated_fleet
    from cruise_control_tpu_torch.service.progress import OperationProgress

    tmp = str(tmp_path)
    clusters = {
        "east": dict(num_brokers=6, topics={"T0": 12, "T1": 12}),
        "south": dict(num_brokers=12, topics={"T0": 48, "T1": 48}),
    }
    props = {
        "tpu.compile.cache.dir": os.path.join(tmp, "xla"),
        "tpu.prewarm.manifest.dir": os.path.join(tmp, "prewarm"),
    }
    app, fleet = build_simulated_fleet(props, clusters=clusters, seed=31, device="cpu")
    shapes = {}
    for cid in ("east", "south"):
        res = fleet.facade(cid).proposals(OperationProgress(), ignore_cache=True)
        shapes[cid] = res.state_before.shape
        # twice: recency touches must dedup, not duplicate
        fleet.facade(cid).proposals(OperationProgress(), ignore_cache=True)
    assert shapes["east"] != shapes["south"], "test needs two distinct buckets"
    store = fleet.core.prewarm_store
    assert store is not None
    store.drain(300)
    keys = store.manifest_bucket_keys()
    assert sorted(keys) == sorted(
        {bucket_key(shapes["east"]), bucket_key(shapes["south"])}
    )
    fleet.shutdown()

    app2, fleet2 = build_simulated_fleet(props, clusters=clusters, seed=31, device="cpu")
    fleet2.start_up(detection_interval_s=3600)
    for cid in ("east", "south"):
        assert fleet2.facade(cid)._boot_prewarm_done.wait(120)
    opt = fleet2.core.optimizer
    assert opt.has_engine_for(shapes["east"]), "east bucket not prewarmed"
    assert opt.has_engine_for(shapes["south"]), "south bucket not prewarmed"
    fleet2.shutdown()


def test_controller_first_cycle_waits_for_boot_gate(tmp_path):
    """(tests/test_prewarm.py:461) The controller thread starts at once
    (running=True) but its first cycle waits for the boot gate, so the
    manifest's captures are in flight before it takes ownership of
    proposal publishing."""
    tmp = str(tmp_path)
    app, fetcher, admin, sampler = _service(
        {"controller.enabled": True, "controller.poll.interval.ms": 50}, tmp
    )
    cc = app.cc
    ctl = cc.controller
    gate = threading.Event()
    ctl.start(boot_gate=gate)
    assert ctl.running
    parts = sampler.all_partition_entities()
    fetcher.fetch_once(parts, 4000, 4999)  # a rolled window is waiting
    time.sleep(0.5)
    assert ctl._stats["windowRolls"] == 0, "cycle ran before the boot gate"
    gate.set()
    deadline = time.monotonic() + 30
    while ctl._stats["windowRolls"] == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ctl._stats["windowRolls"] >= 1
    cc.shutdown()
