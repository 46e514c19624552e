"""The JAX package's tests/test_client.py, pointed at the port on the CPU.

CLI client tests against a live in-process service (reference
cruise-control-client has no in-repo tests; we hold ours to the service)."""

import json

import pytest

from cruise_control_tpu_torch.client.cccli import ENDPOINTS, build_parser, main
from cruise_control_tpu_torch.service.main import build_simulated_service
from cruise_control_tpu_torch.service.server import GET_ENDPOINTS, POST_ENDPOINTS


@pytest.fixture(scope="module")
def service():
    app, fetcher, admin, sampler = build_simulated_service(seed=7, device="cpu")
    app.start()
    yield app
    app.stop()


def run_cli(service, capsys, *argv):
    rc = main(["-a", f"http://{service.host}:{service.port}", *argv])
    out = capsys.readouterr().out
    return rc, json.loads(out)


def test_cli_covers_every_endpoint():
    covered = {spec["endpoint"] for spec in ENDPOINTS.values()}
    assert set(GET_ENDPOINTS) <= covered
    assert set(POST_ENDPOINTS) <= covered


def test_cli_parameter_validation():
    p = build_parser()
    with pytest.raises(SystemExit):
        p.parse_args(["remove_broker", "--brokers", "abc"])  # not a csv int list
    with pytest.raises(SystemExit):
        p.parse_args(["rebalance", "--dryrun", "maybe"])  # not boolean
    args = p.parse_args(["add_broker", "--brokers", "1,2,3", "--dryrun", "true"])
    assert args.brokerid == "1,2,3"


def test_cli_state(service, capsys):
    rc, payload = run_cli(service, capsys, "state")
    assert rc == 0 and "MonitorState" in payload


def test_cli_async_proposals(service, capsys):
    rc, payload = run_cli(service, capsys, "proposals")
    assert rc == 0 and "balancednessAfter" in payload


def test_cli_rebalance_dryrun(service, capsys):
    rc, payload = run_cli(service, capsys, "rebalance", "--dryrun", "true")
    assert rc == 0 and "proposals" in payload
    # per-phase ETA derived from data-to-move over active caps (ADVICE r4
    # weak #8: dataToMoveMB alone was surfaced)
    eta = payload["estimatedExecutionTime"]
    assert set(eta) == {
        "interBrokerSeconds", "intraBrokerSeconds", "leadershipSeconds",
        "assumptions",
    }
    assert eta["assumptions"]["concurrentLeaderMovements"] >= 1
    assert eta["assumptions"]["dataToMoveMB"] == payload["dataToMoveMB"]


def test_cli_user_tasks_filters(service, capsys):
    """user_tasks filter flags reach the server-side filters
    (service/parameters.py user_task_ids/client_ids/endpoints/types)."""
    rc, _ = run_cli(service, capsys, "proposals")  # async op -> user task
    rc, payload = run_cli(service, capsys, "user_tasks",
                          "--endpoints", "PROPOSALS")
    assert rc == 0
    tasks = payload["userTasks"]
    assert tasks and all("proposals" in t["RequestURL"].lower() for t in tasks)
    # a filter that matches nothing returns an empty list, not an error
    rc, payload = run_cli(service, capsys, "user_tasks",
                          "--endpoints", "TRAIN")
    assert rc == 0 and payload["userTasks"] == []


def test_cli_admin_concurrency_flags(service, capsys):
    """ADMIN mid-execution concurrency flags serialize to the server's
    parameter names; with no live execution the server answers 400 and
    the CLI reports the error body (exit 1)."""
    p = build_parser()
    args = p.parse_args([
        "admin",
        "--concurrent-partition-movements-per-broker", "8",
        "--concurrent-leader-movements", "500",
        "--execution-progress-check-interval-ms", "100",
    ])
    assert args.concurrent_partition_movements_per_broker == "8"
    with pytest.raises(SystemExit):
        p.parse_args(["admin", "--concurrent-leader-movements", "0"])  # < 1
    rc, payload = run_cli(
        service, capsys, "admin",
        "--concurrent-partition-movements-per-broker", "8",
    )
    assert rc == 1 and "no ongoing execution" in json.dumps(payload)


def test_cli_error_reporting(service, capsys):
    rc, payload = run_cli(service, capsys, "topic_configuration",
                          "--topic", "NoSuchTopic", "--replication-factor", "3")
    assert rc == 0  # unknown topic -> zero proposals, not an error
    assert payload["numProposals"] == 0


def test_cli_basic_auth(tmp_path, capsys):
    """-u user:password sends the Authorization header the server's
    BasicSecurityProvider expects (reference cccli auth flags)."""
    from cruise_control_tpu_torch.config import CruiseControlConfig

    creds = tmp_path / "credentials"
    creds.write_text("admin:secret:ADMIN\nviewer:ro:VIEWER\n")
    config = CruiseControlConfig({
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "execution.progress.check.interval.ms": 100,
        "webserver.http.port": 0,
        "webserver.security.enable": "true",
        "basic.auth.credentials.file": str(creds),
        "tpu.num.candidates": 64, "tpu.leadership.candidates": 16,
        "tpu.steps.per.round": 8, "tpu.num.rounds": 2,
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=8, device="cpu")
    app.start()
    try:
        addr = f"http://{app.host}:{app.port}"
        # no credentials -> 401 -> nonzero exit with the error payload
        rc = main(["-a", addr, "state"])
        capsys.readouterr()
        assert rc == 1
        rc = main(["-a", addr, "-u", "admin:secret", "state"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and "MonitorState" in out
        # VIEWER may GET but not POST
        rc = main(["-a", addr, "-u", "viewer:ro", "state"])
        capsys.readouterr()
        assert rc == 0
        rc = main(["-a", addr, "-u", "viewer:ro", "pause_sampling"])
        err = json.loads(capsys.readouterr().out)
        assert rc == 1 and "errorMessage" in err
    finally:
        app.stop()


def test_cli_trace_and_metrics(service, capsys):
    # seed a traced operation, then replay it through the CLI
    rc, payload = run_cli(service, capsys, "proposals")
    assert rc == 0
    tid = payload.get("_traceId")
    assert tid
    rc, idx = run_cli(service, capsys, "trace")
    assert rc == 0 and idx["traces"]
    rc, tree = run_cli(service, capsys, "trace", "--id", tid)
    assert rc == 0
    assert tree["traceId"] == tid and tree["spans"]
    # metrics is raw Prometheus text, passed through verbatim (not JSON)
    rc = main(["-a", f"http://{service.host}:{service.port}", "metrics"])
    out = capsys.readouterr().out
    assert rc == 0
    from cruise_control_tpu_torch.common.exposition import parse_exposition

    assert parse_exposition(out), "CLI must emit lintable exposition text"
