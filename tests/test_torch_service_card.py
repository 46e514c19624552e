"""What the port's service does where the JAX package's does otherwise, on
the CPU.

- The card's supervised route: a classified device failure under a
  request answers 503 with its `failureClass`, the open breaker a 503
  with a Retry-After of the supervisor's probe interval; /state shows the
  breaker, the detector records one OPTIMIZER_DEGRADED, and once the probe
  heals the same request answers 200.  No CPU answer stands in for the
  card's work (the "card" is the CPU read as another device, as in
  tests/test_torch_faults.py's `on_a_card`).
- The mesh modes, once refused by the builders, build with mesh fault
  tolerance on, in a service and a fleet; `controller.enabled=true` builds
  the streaming controller on the service's device, in a fleet too, and on
  the card (marked cuda) a reflatten and a fused cycle publish what
  /proposals serves.
- Without CUDA and without a device, every builder and `main` raise.
- Over testing/fake_kafka.py the facade throttles topics by their real
  names (the JAX facade names them by dense id, ROADMAP queue 3).
- `GoalOptimizer(profiler_dir=)` writes a trace.
"""

import json
import math
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

import cruise_control_tpu_torch.analyzer.optimizer as optimizer_mod
from cruise_control_tpu_torch.analyzer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.engine import OptimizerConfig
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.detector.anomalies import AnomalyType
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.service import main as service_main
from cruise_control_tpu_torch.service.main import build_simulated_service
from cruise_control_tpu_torch.service.progress import OperationProgress
from cruise_control_tpu_torch.testing import faults
from cruise_control_tpu_torch.testing.fixtures import small_cluster

PROPS = {
    "partition.metrics.window.ms": 1000,
    "min.samples.per.partition.metrics.window": 1,
    "num.partition.metrics.windows": 3,
    "execution.progress.check.interval.ms": 100,
    "webserver.http.port": 0,
    "tpu.num.candidates": 128,
    "tpu.leadership.candidates": 32,
    "tpu.steps.per.round": 16,
    "tpu.num.rounds": 2,
}


def _get(app, path, method="GET"):
    """(status, body, headers) of one request polled to its answer."""
    url = f"http://127.0.0.1:{app.port}{app.prefix}{path}"
    headers = {}
    deadline = time.monotonic() + 60
    while True:
        req = urllib.request.Request(url, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                status, body, hdrs = r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), dict(e.headers)
        if status != 202 or time.monotonic() > deadline:
            return status, body, hdrs
        headers = {"User-Task-ID": hdrs["User-Task-ID"]}
        time.sleep(0.05)


def test_card_route_failure_answers_503_then_recovers(monkeypatch):
    probe_s = 7.5
    app, *_ = build_simulated_service(CruiseControlConfig({
        **PROPS,
        "tpu.supervisor.breaker.failure.threshold": 1,
        "tpu.supervisor.max.retries": 0,
        "tpu.supervisor.probe.interval.s": probe_s,
    }), seed=3, device="cpu")
    cc = app.cc
    app.start()
    try:
        healthy = cc.proposals(OperationProgress(), ignore_cache=True)
        assert not healthy.degraded
        # from here the optimizer and its states read as lying on a card;
        # the device path is the test's stand-in, and a CPU answer fails
        card = torch.device("meta")
        monkeypatch.setattr(ClusterState, "device", property(lambda s: card))
        monkeypatch.setattr(optimizer_mod, "greedy_optimize",
                            lambda *a, **kw: pytest.fail("the card's work was answered on the CPU"))
        cc.optimizer.device = card
        verdict = ["down"]
        cc.supervisor._probe = lambda: verdict[0]
        calls = []

        def device_path(*a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise faults.oom_error("engine.run")
            return healthy

        cc.optimizer._optimize_on_device = device_path

        status, body, _ = _get(app, "/proposals?ignore_proposal_cache=true")
        assert status == 503
        assert body["failureClass"] == "oom" and "oom" in body["errorMessage"]
        assert body["_userTaskId"]
        st = cc.state(["analyzer"])["AnalyzerState"]
        assert st["degraded"] is True and st["supervisor"]["breaker"] == "open"
        assert st["supervisor"]["failureCounts"]["oom"] == 1
        kinds = [r.anomaly.anomaly_type for r in cc.anomaly_detector.run_once()]
        assert kinds.count(AnomalyType.OPTIMIZER_DEGRADED) == 1
        assert AnomalyType.OPTIMIZER_DEGRADED not in [
            r.anomaly.anomaly_type for r in cc.anomaly_detector.run_once()]

        # the breaker open: refused without touching the device path
        status, body, headers = _get(app, "/proposals?ignore_proposal_cache=true")
        assert status == 503 and calls == [1]
        assert body["failureClass"] == "breaker-open" and body["openedBy"] == "oom"
        assert headers["Retry-After"] == str(math.ceil(probe_s))
        assert "_retryAfter" in body  # the rider the header is sent from

        # the probe heals: the same request answers from the card
        verdict[0] = None
        cc.supervisor.breaker._next_probe_at = 0.0
        status, body, _ = _get(app, "/proposals?ignore_proposal_cache=true")
        assert status == 200 and calls == [1, 1]
        assert body["degraded"] is False
        assert cc.state(["analyzer"])["AnalyzerState"]["supervisor"]["breaker"] == "closed"
    finally:
        app.stop()


@pytest.mark.parametrize("props,key", [
    ({"tpu.parallel.mode": "sharded"}, "tpu.parallel.mode"),
    ({"tpu.parallel.mode": "grid:2x2"}, "tpu.parallel.mode"),
])
def test_builders_refuse_modes_not_yet_ported(props, key):
    """The builders refused the mesh modes until they were ported (mesh
    fault tolerance on by default, as in the JAX package); now they build
    them: the service's optimizer runs the mode with its controller, and a
    fleet builds too."""
    props = {**props, "tpu.mesh.max.devices": 4}
    config = CruiseControlConfig({**PROPS, **props})  # parses, as in the JAX package
    assert config.get(key) not in ("single", False)
    app, *_ = build_simulated_service(config, device="cpu")
    try:
        opt = app.cc.optimizer
        assert opt.parallel_mode == props[key]
        assert opt._mesh_ft is not None and opt._mesh_ft.enabled
    finally:
        app.stop()
    app, fleet = service_main.build_simulated_fleet(props, device="cpu")
    assert all(fleet.facade(cid).optimizer.parallel_mode == props[key] for cid in fleet.contexts)


def test_controller_enabled_builds_the_controller_on_the_service_device():
    """`controller.enabled=true` builds a StreamingController on the
    service's device, through build_simulated_service and in each of
    build_simulated_fleet's cluster facades, and GET /fleet carries each
    cluster's `controller` block."""
    from cruise_control_tpu_torch.controller import StreamingController

    config = CruiseControlConfig({**PROPS, "controller.enabled": "true"})
    app, *_ = build_simulated_service(config, device="cpu")
    try:
        ctl = app.cc.controller
        assert isinstance(ctl, StreamingController)
        assert ctl.optimizer is app.cc.optimizer and ctl.optimizer.device == torch.device("cpu")
        assert ctl.monitor.device == torch.device("cpu")
    finally:
        app.stop()
    app, fleet = service_main.build_simulated_fleet({"controller.enabled": "true"}, device="cpu")
    try:
        app.start()
        for cid in fleet.contexts:
            cc = fleet.facade(cid)
            assert isinstance(cc.controller, StreamingController)
            assert cc.controller.cc is cc and cc.controller.optimizer.device == torch.device("cpu")
        status, body, _ = _get(app, "/fleet")
        assert status == 200
        for cid in fleet.contexts:
            block = body["clusters"][cid]["controller"]
            assert block["running"] is False and block["windowRolls"] == 0
    finally:
        fleet.shutdown()
        app.stop()


@pytest.mark.cuda
def test_controller_on_the_card_reflattens_then_fuses_and_serves():
    """On the card: a small simulated service with the controller; its first
    window reflattens, its second goes fused with at most two dispatches,
    and /proposals serves the controller's publish."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = CruiseControlConfig({**PROPS, "controller.enabled": "true"})
    app, fetcher, admin, sampler = build_simulated_service(config, device="cuda")
    try:
        app.start()
        cc = app.cc
        ctl = cc.controller
        assert ctl.optimizer.device.type == "cuda"
        parts = sampler.all_partition_entities()
        infos = []
        for w in (4, 5):
            sampler.drift(1.05)
            fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
            infos.append(ctl.run_once())
        assert infos[0]["reflattened"] and infos[0]["reflatten_reason"] == "initial"
        assert not infos[1]["reflattened"] and infos[1]["fused"]
        stats = ctl.state_json()
        assert stats["lastCycleDispatches"] <= 2 and stats["fusedCycles"] == 1
        assert ctl._live.state.replica_load_leader.device.type == "cuda"
        status, body, _ = _get(app, "/proposals")
        assert status == 200
        assert cc.state(["analyzer"])["AnalyzerState"]["proposalSource"] == "controller"
        assert body["proposals"] == [p.to_json() for p in infos[1]["result"].proposals[:100]]
    finally:
        app.stop()


def test_no_cuda_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    for build in (lambda: build_simulated_service(),
                  lambda: service_main.build_simulated_fleet(),
                  lambda: service_main.build_service(CruiseControlConfig(PROPS), None, None, None),
                  lambda: service_main.build_fleet_service(
                      CruiseControlConfig({"fleet.clusters": "a"}), {"a": (None, None, None)}),
                  lambda: service_main.build_kafka_service(
                      CruiseControlConfig(PROPS), "127.0.0.1:1", None),
                  lambda: service_main.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_main_takes_device_cpu(monkeypatch):
    """`main --device cpu` builds the simulated service on the CPU (stopped
    right after the build, before anything starts)."""
    seen = {}
    real = service_main.build_simulated_service

    class Built(Exception):
        pass

    def spy(config, **kw):
        seen.update(kw)
        seen["app"] = real(config, **kw)[0]
        raise Built

    monkeypatch.setattr(service_main, "build_simulated_service", spy)
    with pytest.raises(Built):
        service_main.main(["--device", "cpu"])
    app = seen["app"]
    assert seen["device"] == torch.device("cpu")
    assert app.cc.optimizer.device == torch.device("cpu")
    assert app.cc.monitor.device == torch.device("cpu")
    assert app.cc.scenario_evaluator.device == torch.device("cpu")


def test_throttles_name_real_topics_over_the_wire():
    from cruise_control_tpu_torch.kafka import KafkaAdminClient, KafkaClusterAdmin, KafkaMetadataProvider
    from cruise_control_tpu_torch.testing.fake_kafka import FakeKafkaCluster
    from cruise_control_tpu_torch.testing.synthetic import SyntheticWorkloadSampler

    topics = {
        t: [{"partition": p, "leader": p % 2, "replicas": [p % 2, 1 - p % 2]} for p in range(8)]
        for t in ("orders", "payments")
    }
    cluster = FakeKafkaCluster({b: {"rack": f"r{b % 2}"} for b in range(4)}, topics).start()
    cluster.auto_complete_after(1)
    throttled = []
    handler = cluster._h_IncrementalAlterConfigs

    def recording(node, body):
        throttled.extend(r["resource_name"] for r in body["resources"] or []
                         if r["resource_type"] == 2)  # TOPIC
        return handler(node, body)

    cluster._h_IncrementalAlterConfigs = recording
    client = KafkaAdminClient(cluster.bootstrap(), timeout_s=10.0)
    try:
        metadata = KafkaMetadataProvider(client)
        sampler = SyntheticWorkloadSampler(metadata.topology(), seed=1)
        config = CruiseControlConfig({**PROPS, "default.replication.throttle": 5_000_000})
        app, fetcher = service_main.build_service(
            config, metadata, KafkaClusterAdmin(client), sampler, device="cpu")
        parts = sampler.all_partition_entities()
        for w in range(4):
            fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
        out = app.cc.rebalance(OperationProgress(), dryrun=False)
        app.stop()
    finally:
        client.close()
        cluster.stop()
    assert out["numReplicaMovements"] > 0 and out["execution"]["completed"] > 0
    assert throttled, "the execution throttled its topics"
    assert set(throttled) <= set(topics)
    # every throttle was cleared after the execution
    assert not any(cfg for (kind, name), cfg in cluster.configs.items() if kind == 2)


def test_optimizer_profiler_dir_writes_a_trace(tmp_path):
    opt = GoalOptimizer(config=OptimizerConfig(num_candidates=64, leadership_candidates=16,
                                               swap_candidates=16, steps_per_round=8, num_rounds=2),
                        device="cpu", profiler_dir=str(tmp_path / "prof"))
    opt.optimize(small_cluster("cpu"))
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].startswith("trace-") and traces[0].endswith(".json")
    with open(tmp_path / "prof" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    quiet = GoalOptimizer(device="cpu")
    assert quiet.profiler_dir is None
