"""The JAX package's tests/test_fleet.py, pointed at the port on the CPU.

Fleet controller tests: one service instance over N Kafka clusters.

Covers the acceptance contract of the fleet subsystem (fleet/manager.py):

  * shared compiled engines — clusters whose bucketed shapes coincide
    rebind ONE engine (engine-cache counters on the shared core prove it)
  * batched same-bucket scoring through the ScenarioEvaluator's
    one-dispatch path
  * per-cluster isolation — namespaced executor journals (a fleet restart
    reconciles every cluster's journal with zero cross-adoption),
    per-cluster labeled sensor registries (no last-writer-wins collisions
    in /metrics), per-cluster trace components
  * the REST surface — `cluster=` routing, GET /fleet rollups, per-tenant
    admission control (429), single-cluster deployments unchanged
  * 3 live FakeKafkaClusters under one facade (slow, socket-level)
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from cruise_control_tpu_torch.config.app_config import CruiseControlConfig
from cruise_control_tpu_torch.service.main import (
    build_simulated_fleet,
    build_simulated_service,
)
from cruise_control_tpu_torch.service.progress import OperationProgress
from cruise_control_tpu_torch.service.schemas import validate_response


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def fleet_service():
    """One 3-cluster simulated fleet shared by the module: east/west share
    a bucketed shape, south has its own."""
    app, fleet = build_simulated_fleet(seed=11, device="cpu")
    app.start()
    try:
        yield app, fleet
    finally:
        fleet.shutdown()
        app.stop()


def _req(app, method, endpoint, headers=None, **params):
    base = f"http://{app.host}:{app.port}{app.prefix}"
    q = "&".join(f"{k}={v}" for k, v in params.items())
    r = urllib.request.Request(
        f"{base}/{endpoint}" + (f"?{q}" if q else ""),
        method=method, headers=headers or {},
    )
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            body = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            payload = (
                json.loads(body) if ctype.startswith("application/json")
                else body.decode()
            )
            return resp.status, payload, dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _poll(app, method, endpoint, **params):
    status, payload, headers = _req(app, method, endpoint, **params)
    tid = headers.get("User-Task-ID")
    deadline = time.time() + 300
    while status == 202 and time.time() < deadline:
        time.sleep(0.2)
        status, payload, _ = _req(
            app, method, endpoint, headers={"User-Task-ID": tid}, **params
        )
    return status, payload


# ------------------------------------------------- shared engine economics


def test_same_bucket_clusters_share_one_compiled_engine(fleet_service):
    """The tentpole economics: east and west have identical bucketed
    shapes, so the second cluster's proposal run must REBIND the first's
    compiled engine (cache hit), and the fleet must end with fewer
    compiled engines than clusters."""
    app, fleet = fleet_service
    opt = fleet.core.optimizer
    h0, m0 = opt.engine_cache_hits, opt.engine_cache_misses
    results = {}
    for cid in ("east", "west", "south"):
        results[cid] = fleet.facade(cid).proposals(
            OperationProgress(), ignore_cache=True
        )
    assert opt.engine_cache_misses - m0 == 2, (
        "east+west share one engine, south compiles its own"
    )
    assert opt.engine_cache_hits - h0 >= 1, "west must hit east's engine"
    assert opt.cache_size < len(fleet.contexts)
    # the shared registry carries the proof counters
    snap = fleet.core.sensors.snapshot()
    assert snap["analyzer.engine-cache-hits"]["count"] >= 1
    # every cluster still got its own independent proposal set
    assert all(r is not None for r in results.values())
    shapes = {cid: r.state_before.shape for cid, r in results.items()}
    assert shapes["east"] == shapes["west"] != shapes["south"]


def test_score_clusters_batches_same_bucket_clusters(fleet_service):
    app, fleet = fleet_service
    before = fleet.sensors.counter("fleet.batched-score-runs").count
    scores = fleet.score_clusters()
    assert set(scores) == {"east", "west", "south"}
    assert scores["east"]["batchedWith"] == 2, (
        "east+west share a shape -> ONE batched dispatch for both"
    )
    assert scores["west"]["batchedWith"] == 2
    assert scores["south"]["batchedWith"] == 1
    for s in scores.values():
        assert 0.0 <= s["balancedness"] <= 100.0
        assert isinstance(s["violatedGoals"], list)
    # 2 shape groups -> 2 batched runs recorded
    assert fleet.sensors.counter("fleet.batched-score-runs").count - before == 2


# ------------------------------------------------------------ REST surface


def test_fleet_rollup_endpoint(fleet_service):
    app, fleet = fleet_service
    status, payload, _ = _req(app, "GET", "fleet")
    assert status == 200
    assert validate_response("fleet", payload) == []
    assert payload["numClusters"] == 3
    assert set(payload["clusters"]) == {"east", "west", "south"}
    for rollup in payload["clusters"].values():
        assert "proposalReady" in rollup
        assert "executorState" in rollup
    shared = payload["shared"]
    assert shared["compiledEngines"] >= 1
    assert shared["tenantMaxPendingTasks"] == 8
    # ?cluster= narrows, ?score=true scores (batched)
    status, payload, _ = _req(app, "GET", "fleet", cluster="east", score="true")
    assert status == 200
    assert set(payload["clusters"]) == {"east"}
    assert set(payload["scores"]) == {"east", "west", "south"}


def test_cluster_param_routing(fleet_service):
    app, fleet = fleet_service
    # cluster-scoped endpoint without cluster= -> 400 naming the clusters
    status, payload, _ = _req(app, "GET", "state")
    assert status == 400 and "cluster" in payload["errorMessage"]
    assert "east" in payload["errorMessage"]
    # unknown cluster -> 400
    status, payload, _ = _req(app, "GET", "state", cluster="nope")
    assert status == 400 and "nope" in payload["errorMessage"]
    # per-cluster /state resolves the right facade
    status, payload, _ = _req(
        app, "GET", "state", cluster="south", substates="monitor"
    )
    assert status == 200 and "MonitorState" in payload
    # an async op on one cluster tags its user task with the cluster
    status, payload = _poll(app, "GET", "proposals", cluster="east")
    assert status == 200, payload
    status, tasks, _ = _req(app, "GET", "user_tasks", clusters="east")
    assert status == 200
    assert tasks["userTasks"], "the east proposals task must be listed"
    assert all(t["Cluster"] == "east" for t in tasks["userTasks"])
    # ... and its trace filed under east's component namespace
    trace_id = payload.get("_traceId")
    assert trace_id
    status, trace, _ = _req(app, "GET", "trace", id=trace_id)
    assert status == 200
    components = {s["component"] for s in trace["spans"]}
    assert any(c.startswith("east:") for c in components), components


def test_metrics_exposition_with_n_clusters_lints_clean(fleet_service):
    """Satellite: two clusters registering the same sensor family must be
    distinct labeled series (no last-writer-wins), and the N-cluster
    exposition must pass the strict lint parser."""
    from cruise_control_tpu_torch.common.exposition import parse_exposition

    app, fleet = fleet_service
    # every cluster builds a model first so the per-cluster monitor
    # sensor families exist regardless of which tests ran before
    fleet.score_clusters()
    status, body, headers = _req(app, "GET", "metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    families = parse_exposition(body)  # raises on any lint violation
    # the same per-cluster family carries one sample per cluster, each
    # labeled with its cluster id
    fam = "cruisecontrol_monitor_cluster_model_creation_timer_seconds"
    count_labels = {
        labels.get("cluster")
        for name, labels, _ in families[fam]["samples"]
        if name == fam + "_count"
    }
    assert count_labels == {"east", "west", "south"}
    # shared-core families ride unlabeled beside them
    fam = "cruisecontrol_analyzer_engine_cache_hits_total"
    assert all(
        "cluster" not in labels for _, labels, _ in families[fam]["samples"]
    )


def test_tenant_admission_control_429(fleet_service):
    """Satellite: one noisy cluster's pending tasks must 429 at the cap
    while the other clusters keep being admitted."""
    app, fleet = fleet_service
    cap = fleet.tenant_max_pending
    release = threading.Event()
    blockers = [
        app.user_tasks.submit(
            "proposals", lambda progress: release.wait(30),
            cluster_id="east", client_id=f"noisy-{i}",
        )
        for i in range(cap)
    ]
    try:
        status, payload, _ = _req(
            app, "POST", "rebalance", cluster="east", dryrun="true"
        )
        assert status == 429, payload
        assert "pending" in payload["errorMessage"]
        rejections = fleet.facade("east").sensors.counter(
            "fleet.tenant-rejections"
        )
        assert rejections.count >= 1
        # the quiet cluster is NOT starved: its request is admitted
        status, payload, _ = _req(
            app, "POST", "rebalance", cluster="west", dryrun="true"
        )
        assert status in (200, 202), payload
    finally:
        release.set()
        for b in blockers:
            b.future.result(timeout=60)


# -------------------------------------------------- single-cluster parity


def test_single_cluster_deployment_unchanged():
    """A deployment without fleet.clusters keeps the classic surface:
    cluster= is rejected, /fleet answers a one-entry rollup, and the
    journal path has no cluster namespace."""
    app, fetcher, admin, sampler = build_simulated_service(seed=7, device="cpu")
    app.start()
    try:
        status, payload, _ = _req(app, "GET", "state", cluster="east")
        assert status == 400
        assert "no fleet" in payload["errorMessage"]
        status, payload, _ = _req(app, "GET", "state", substates="executor")
        assert status == 200
        status, payload, _ = _req(app, "GET", "fleet")
        assert status == 200
        assert validate_response("fleet", payload) == []
        assert payload["numClusters"] == 1
        assert set(payload["clusters"]) == {"default"}
        assert payload["shared"]["tenantMaxPendingTasks"] == 0
    finally:
        app.stop()


def test_single_cluster_journal_path_has_no_namespace(tmp_path):
    from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
    from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
    from cruise_control_tpu_torch.monitor import LoadMonitor, FixedCapacityResolver
    from cruise_control_tpu_torch.monitor import WindowedMetricSampleAggregator
    from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
    from cruise_control_tpu_torch.service.facade import CruiseControl
    from cruise_control_tpu_torch.testing.synthetic import synthetic_topology

    config = CruiseControlConfig({"executor.journal.dir": str(tmp_path)})
    topo = synthetic_topology(num_brokers=4)
    metadata = StaticMetadataProvider(topo)
    agg = WindowedMetricSampleAggregator(
        num_windows=3, window_ms=1000, min_samples_per_window=1,
        metric_def=KAFKA_METRIC_DEF,
    )
    monitor = LoadMonitor(
        metadata, FixedCapacityResolver([100.0, 1e5, 1e5, 1e6]), agg, device="cpu"
    )
    cc = CruiseControl(config, monitor, SimulatedClusterAdmin(metadata), device="cpu")
    assert cc.executor.journal.path == str(
        tmp_path / "execution-journal.jsonl"
    )


def test_cluster_config_rejects_shared_core_overrides():
    """A fleet.<id>.<key> override of a key the SHARED core or webserver
    consumes (goal chain, tpu.* engine knobs, balancing thresholds,
    planner/trace/webserver) must be rejected at config time — it would
    validate, fold into the cluster's facade config, and then be silently
    ignored because those subsystems are built once from the base."""
    from cruise_control_tpu_torch.config.app_config import ConfigException

    for key, value in [
        ("tpu.num.candidates", "64"),
        ("default.goals", "DiskUsageDistributionGoal"),
        ("disk.capacity.threshold", "0.9"),
        ("planner.max.scenarios", "4"),
        ("webserver.http.port", "9999"),
    ]:
        config = CruiseControlConfig(
            {"fleet.clusters": "east,west", f"fleet.east.{key}": value}
        )
        with pytest.raises(ConfigException, match="shared"):
            config.cluster_config("east")
    # cluster-scoped overrides still fold
    config = CruiseControlConfig({
        "fleet.clusters": "east,west",
        "fleet.east.executor.reaper.enabled": "false",
    })
    assert config.cluster_config("east").get("executor.reaper.enabled") is False
    assert config.cluster_config("west").get("executor.reaper.enabled") is True
    # ... and a typo'd cluster prefix fails at CONFIG time, not by
    # silently folding nothing
    with pytest.raises(ConfigException, match="eastt"):
        CruiseControlConfig({
            "fleet.clusters": "east,west",
            "fleet.eastt.bootstrap.servers": "kafka-east:9092",
        })


def test_tenant_cap_enforced_atomically_in_submit():
    """The per-tenant cap is counted and enforced inside
    UserTaskManager.submit under its lock (not check-then-submit at the
    server), so racing submissions cannot breach it."""
    from cruise_control_tpu_torch.service.tasks import (
        TenantOverloadError,
        UserTaskManager,
    )

    mgr = UserTaskManager(max_active_tasks=50)
    release = threading.Event()
    try:
        for _ in range(2):
            mgr.submit("proposals", lambda p: release.wait(30),
                       cluster_id="east", cluster_max_active=2)
        with pytest.raises(TenantOverloadError, match="pending"):
            mgr.submit("proposals", lambda p: release.wait(30),
                       cluster_id="east", cluster_max_active=2)
        # other tenants and uncapped submissions are unaffected
        mgr.submit("proposals", lambda p: release.wait(30),
                   cluster_id="west", cluster_max_active=2)
        mgr.submit("proposals", lambda p: release.wait(30))
    finally:
        release.set()
        for t in mgr.all_tasks():
            t.future.result(timeout=30)
        mgr.shutdown()


# -------------------------------------------- journal namespace isolation


def _journal_with_inflight(path, uuid, topic, partition, old, new):
    """Craft an unfinished execution journal: a durable start record with
    one inter-broker move and no `finished` record — what a crashed fleet
    leaves on disk."""
    from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
    from cruise_control_tpu_torch.executor.journal import (
        ExecutionJournal,
        task_to_journal,
    )
    from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskType

    proposal = ExecutionProposal(
        partition=partition, topic=0, old_leader=old[0], new_leader=old[0],
        old_replicas=tuple(old), new_replicas=tuple(new),
        inter_broker_data_to_move=1.0,
    )
    task = ExecutionTask(
        execution_id=0, proposal=proposal,
        task_type=TaskType.INTER_BROKER_REPLICA_ACTION,
    )
    j = ExecutionJournal(path)
    j.start_execution({
        "uuid": uuid, "ms": 0,
        "tasks": [task_to_journal(task, (topic, partition))],
        "options": {}, "removed": {}, "demoted": {},
    })
    j.close()
    return j.path


def test_fleet_restart_replays_every_journal_without_cross_adoption(tmp_path):
    """Satellite: two clusters crash mid-execution; the restarted fleet
    reconciles EACH cluster's journal into ITS OWN executor — east never
    adopts west's in-flight moves and vice versa."""
    jdir = tmp_path / "journals"
    _journal_with_inflight(
        str(jdir / "east" / "execution-journal.jsonl"),
        "uuid-east", "T0", 0, old=(0, 1), new=(2, 1),
    )
    _journal_with_inflight(
        str(jdir / "west" / "execution-journal.jsonl"),
        "uuid-west", "T1", 3, old=(1, 2), new=(0, 2),
    )
    app, fleet = build_simulated_fleet(
        props={"executor.journal.dir": str(jdir)},
        clusters={
            "east": dict(num_brokers=4, topics={"T0": 8}),
            "west": dict(num_brokers=4, topics={"T1": 8}),
            "south": dict(num_brokers=4, topics={"T2": 8}),
        },
        seed=3, device="cpu",
    )
    try:
        east = fleet.facade("east").executor
        west = fleet.facade("west").executor
        south = fleet.facade("south").executor
        # each executor reconciled exactly its own cluster's execution
        assert east.recovery_info() is not None
        assert east.recovery_info()["uuid"] == "uuid-east"
        assert west.recovery_info() is not None
        assert west.recovery_info()["uuid"] == "uuid-west"
        # a cluster that crashed idle recovers nothing
        assert south.recovery_info() is None
        # zero cross-adoption: the recovered tasks reference only the
        # owning cluster's journal
        east_tasks = east.tracker.tasks()
        west_tasks = west.tracker.tasks()
        assert {t.proposal.partition for t in east_tasks} == {0}
        assert {t.proposal.partition for t in west_tasks} == {3}
        # each cluster journals into its OWN namespaced directory
        assert east.journal.path.endswith("east/execution-journal.jsonl")
        assert west.journal.path.endswith("west/execution-journal.jsonl")
        assert south.journal.path.endswith("south/execution-journal.jsonl")
    finally:
        fleet.shutdown()


# ----------------------------------- live-socket fleet (3 FakeKafkaClusters)


def _skewed_topology(num_brokers: int, topics: dict[str, int]) -> dict:
    """Every replica packed onto brokers 0+1 (the rest idle) — a blatant
    distribution violation each cluster's rebalance must fix."""
    parts = {}
    for t, n in topics.items():
        parts[t] = [
            {"partition": p, "leader": p % 2, "replicas": [p % 2, 1 - p % 2]}
            for p in range(n)
        ]
    return parts


@pytest.mark.slow
def test_three_fake_kafka_clusters_under_one_facade():
    """The fleet acceptance story over live sockets: 3 FakeKafkaClusters
    behind ONE service — same-bucket clusters share a compiled engine,
    rebalances execute independently with zero cross-cluster task leakage,
    the noisy tenant 429s at the admission cap, and GET /fleet rolls the
    whole thing up."""
    from cruise_control_tpu_torch.kafka import (
        KafkaAdminClient,
        KafkaClusterAdmin,
        KafkaMetadataProvider,
    )
    from cruise_control_tpu_torch.service.main import build_fleet_service
    from cruise_control_tpu_torch.testing.fake_kafka import FakeKafkaCluster
    from cruise_control_tpu_torch.testing.synthetic import SyntheticWorkloadSampler

    specs = {
        # east/west: identical geometry -> one shared compiled engine
        "east": dict(num_brokers=4, topics={"T0": 8, "T1": 8}),
        "west": dict(num_brokers=4, topics={"T0": 8, "T1": 8}),
        # south: different geometry -> its own engine
        "south": dict(num_brokers=6, topics={"T0": 16, "T1": 16}),
    }
    fakes: dict[str, FakeKafkaCluster] = {}
    clients: list[KafkaAdminClient] = []
    try:
        backends = {}
        samplers = {}
        for i, (cid, spec) in enumerate(specs.items()):
            fakes[cid] = FakeKafkaCluster(
                brokers={
                    b: {"rack": f"r{b % 2}"} for b in range(spec["num_brokers"])
                },
                topics=_skewed_topology(**spec),
            ).start()
            client = KafkaAdminClient(fakes[cid].bootstrap(), timeout_s=10.0)
            clients.append(client)
            metadata = KafkaMetadataProvider(client)
            admin = KafkaClusterAdmin(client)
            sampler = SyntheticWorkloadSampler(metadata.topology(), seed=i)
            backends[cid] = (metadata, admin, sampler)
            samplers[cid] = sampler

        window_ms = 60_000
        config = CruiseControlConfig({
            "fleet.clusters": "east,west,south",
            "fleet.tenant.max.pending.tasks": "2",
            "partition.metrics.window.ms": str(window_ms),
            "min.samples.per.partition.metrics.window": "1",
            "num.partition.metrics.windows": "2",
            "execution.progress.check.interval.ms": "100",
            "webserver.http.port": "0",
            "tpu.num.candidates": "128",
            "tpu.leadership.candidates": "32",
            "tpu.steps.per.round": "16",
            "tpu.num.rounds": "2",
        })
        app, fleet = build_fleet_service(config, backends, device="cpu")
        for cid, ctx in fleet.contexts.items():
            parts = samplers[cid].all_partition_entities()
            for w in range(3):
                n = ctx.fetcher.fetch_once(
                    parts, w * window_ms, (w + 1) * window_ms - 1
                )
                assert n > 0, f"{cid} window {w} absorbed no samples"
        app.start()

        def placement(cid):
            return {
                (t, p["partition"]): tuple(p["replicas"])
                for t, pmap in fakes[cid].topics.items()
                for p in pmap.values()
            }

        before = {cid: placement(cid) for cid in specs}
        for fake in fakes.values():
            fake.auto_complete_after(2)

        # --- east rebalances; west and south are untouched ---
        status, payload = _poll(
            app, "POST", "rebalance", cluster="east", dryrun="false"
        )
        assert status == 200, payload
        assert payload["numReplicaMovements"] > 0
        assert placement("east") != before["east"]
        assert placement("west") == before["west"], "cross-cluster leakage"
        assert placement("south") == before["south"], "cross-cluster leakage"
        east_after = placement("east")

        # --- west rebalances on the SAME compiled engine (shared cache) ---
        opt = fleet.core.optimizer
        hits_before = opt.engine_cache_hits
        status, payload = _poll(
            app, "POST", "rebalance", cluster="west", dryrun="false"
        )
        assert status == 200, payload
        assert opt.engine_cache_hits > hits_before, (
            "west's identical bucketed shape must rebind east's engine"
        )
        assert placement("west") != before["west"]
        assert placement("east") == east_after, "cross-cluster leakage"
        assert placement("south") == before["south"], "cross-cluster leakage"

        # fewer compiled engines than clusters after south's run too
        status, payload = _poll(
            app, "POST", "rebalance", cluster="south", dryrun="false"
        )
        assert status == 200, payload
        assert opt.cache_size < len(fleet.contexts)

        # zero task leakage at the executor level: every cluster executed
        # its own tasks, and the three executors saw disjoint executions
        for cid in specs:
            assert fleet.facade(cid).executor.tracker.tasks(), cid

        # --- noisy tenant: 429 at the cap, quiet cluster still admitted ---
        release = threading.Event()
        blockers = [
            app.user_tasks.submit(
                "proposals", lambda progress: release.wait(30),
                cluster_id="south", client_id=f"noisy-{i}",
            )
            for i in range(2)
        ]
        try:
            status, payload, _ = _req(
                app, "POST", "rebalance", cluster="south", dryrun="true"
            )
            assert status == 429, payload
            status, payload, _ = _req(
                app, "POST", "rebalance", cluster="east", dryrun="true"
            )
            assert status in (200, 202), payload
        finally:
            release.set()
            for b in blockers:
                b.future.result(timeout=60)

        # --- GET /fleet rollup over the live fleet ---
        status, payload, _ = _req(app, "GET", "fleet")
        assert status == 200
        assert validate_response("fleet", payload) == []
        assert payload["numClusters"] == 3
        assert payload["shared"]["compiledEngines"] < 3
        assert payload["shared"]["engineCacheHits"] >= 1

        fleet.shutdown()
        app.stop()
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        for fake in fakes.values():
            fake.stop()


# ----------------------------------------------------- labeled exposition


def test_labeled_registries_render_distinct_series():
    """Unit twin of the /metrics test: same sensor family in two labeled
    registries + an unlabeled shared one -> three distinct series, one
    TYPE line, lint-clean."""
    from cruise_control_tpu_torch.common.exposition import (
        parse_exposition,
        prometheus_text,
    )
    from cruise_control_tpu_torch.common.sensors import SensorRegistry

    shared = SensorRegistry()
    a = SensorRegistry(base_labels={"cluster": "a"})
    b = SensorRegistry(base_labels={"cluster": "b"})
    shared.counter("analyzer.engine-cache-hits").inc(5)
    a.counter("monitor.model-builds").inc(1)
    b.counter("monitor.model-builds").inc(2)
    a.histogram("analyzer.proposal-computation-seconds").observe(0.5)
    b.histogram("analyzer.proposal-computation-seconds").observe(2.0)
    a.timer("monitor.cluster-model-creation-timer").update(0.1)
    b.timer("monitor.cluster-model-creation-timer").update(0.2)
    text = prometheus_text([shared, a, b])
    fams = parse_exposition(text)  # strict lint must pass
    fam = "cruisecontrol_monitor_model_builds_total"
    samples = {
        labels["cluster"]: v for _, labels, v in fams[fam]["samples"]
    }
    assert samples == {"a": 1.0, "b": 2.0}
    # one TYPE line per family even though two registries emitted it
    assert text.count(f"# TYPE {fam} counter") == 1
    # per-label histogram ladders each hold the bucket invariants (the
    # parser validated them); both clusters' ladders are present
    hfam = "cruisecontrol_analyzer_proposal_computation_seconds"
    ladders = {
        labels["cluster"]
        for name, labels, _ in fams[hfam]["samples"]
        if name == hfam + "_bucket"
    }
    assert ladders == {"a", "b"}
