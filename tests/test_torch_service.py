"""The JAX package's tests/test_service.py, pointed at the port on the CPU.

Service-layer tests: config system, facade operations, REST API.

Mirrors reference KafkaCruiseControlServletEndpointTest / UserTaskManagerTest
(SURVEY §4.4) over the in-process simulated service.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cruise_control_tpu_torch.config import ConfigException, CruiseControlConfig
from cruise_control_tpu_torch.service.main import build_simulated_service
from cruise_control_tpu_torch.service.progress import OperationProgress
from cruise_control_tpu_torch.service.purgatory import Purgatory, ReviewStatus
from cruise_control_tpu_torch.service.server import GET_ENDPOINTS, POST_ENDPOINTS


# ----------------------------------------------------------------- config


def test_config_defaults_and_overrides():
    c = CruiseControlConfig({})
    assert c.get("max.replicas.per.broker") == 10_000
    assert c.get("num.concurrent.partition.movements.per.broker") == 5
    c2 = CruiseControlConfig({"cpu.balance.threshold": "1.25"})
    assert c2.balancing_constraint().balance_threshold[0] == 1.25


def test_config_validation():
    with pytest.raises(ConfigException):
        CruiseControlConfig({"cpu.capacity.threshold": "1.5"})  # > 1.0
    with pytest.raises(ConfigException):
        CruiseControlConfig({"default.goals": "NoSuchGoal"})


def test_purgatory_flow():
    p = Purgatory()
    info = p.add("rebalance", {"dryrun": "false"})
    assert info.status == ReviewStatus.PENDING_REVIEW
    p.review(info.review_id, approve=True)
    taken = p.take_approved("rebalance", info.review_id)
    assert taken.status == ReviewStatus.SUBMITTED
    with pytest.raises(ValueError):
        p.take_approved("rebalance", info.review_id)  # already submitted


# ----------------------------------------------------------------- service


@pytest.fixture(scope="module")
def service():
    app, fetcher, admin, sampler = build_simulated_service(seed=3, device="cpu")
    app.start()
    yield app
    app.stop()


def _url(app, endpoint, **params):
    q = "&".join(f"{k}={v}" for k, v in params.items())
    return f"http://{app.host}:{app.port}{app.prefix}/{endpoint}" + (f"?{q}" if q else "")


def _request(app, method, endpoint, headers=None, **params):
    req = urllib.request.Request(
        _url(app, endpoint, **params), method=method, headers=headers or {}
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _poll(app, method, endpoint, **params):
    """Drive the 202 + User-Task-ID pattern to completion."""
    status, payload, headers = _request(app, method, endpoint, **params)
    tid = headers.get("User-Task-ID")
    deadline = time.time() + 60
    while status == 202 and time.time() < deadline:
        time.sleep(0.3)
        status, payload, headers = _request(
            app, method, endpoint, headers={"User-Task-ID": tid}, **params
        )
    return status, payload


def test_state_endpoint(service):
    status, payload, _ = _request(service, "GET", "state")
    assert status == 200
    assert {"MonitorState", "ExecutorState", "AnalyzerState", "AnomalyDetectorState"} <= set(payload)
    assert payload["MonitorState"]["numValidWindows"] >= 2
    # substates filter
    status, payload, _ = _request(service, "GET", "state", substates="monitor")
    assert "ExecutorState" not in payload


def test_kafka_cluster_state(service):
    status, payload, _ = _request(service, "GET", "kafka_cluster_state")
    assert status == 200
    assert payload["KafkaPartitionState"]["numTotalPartitions"] == 24
    assert len(payload["KafkaBrokerState"]) == 6


def test_load_endpoint(service):
    status, payload = _poll(service, "GET", "load")
    assert status == 200
    assert len(payload["brokers"]) == 6
    assert all("CPUPct" in b for b in payload["brokers"])


def test_partition_load_endpoint(service):
    status, payload = _poll(service, "GET", "partition_load", resource="NW_IN", entries=5)
    assert status == 200
    vals = [r["NW_IN"] for r in payload["records"]]
    assert vals == sorted(vals, reverse=True) and len(vals) <= 5


def test_proposals_and_cache(service):
    status, payload = _poll(service, "GET", "proposals")
    assert status == 200
    assert "balancednessAfter" in payload
    # second call should hit the proposal cache (fast, same result)
    t0 = time.time()
    status2, payload2 = _poll(service, "GET", "proposals")
    assert status2 == 200 and time.time() - t0 < 5
    assert payload2["balancednessAfter"] == payload["balancednessAfter"]


def test_rebalance_dryrun_then_execute(service):
    status, payload = _poll(service, "POST", "rebalance", dryrun="true")
    assert status == 200
    status, payload = _poll(service, "POST", "rebalance", dryrun="false")
    assert status == 200
    if "execution" in payload:
        assert payload["execution"]["dead"] == 0
    # post-execution: proposals should find (almost) nothing left to move
    status, after = _poll(service, "GET", "proposals", ignore_proposal_cache="true")
    assert after["balancednessAfter"] >= payload["balancednessAfter"] - 1e-6


def test_user_tasks_listing(service):
    status, payload, _ = _request(service, "GET", "user_tasks")
    assert status == 200
    assert any(t["Status"] in ("Active", "Completed") for t in payload["userTasks"])


def test_pause_resume_sampling(service):
    status, payload, _ = _request(service, "POST", "pause_sampling", reason="test")
    assert status == 200
    assert service.cc.monitor.monitor_state()["state"] == "PAUSED"
    _request(service, "POST", "resume_sampling")
    assert service.cc.monitor.monitor_state()["state"] == "RUNNING"


def test_admin_self_healing_toggle(service):
    status, payload, _ = _request(
        service, "POST", "admin", enable_self_healing_for="goal_violation"
    )
    assert status == 200 and "GOAL_VIOLATION" in payload["selfHealingEnabled"]
    _request(service, "POST", "admin", disable_self_healing_for="goal_violation")
    assert not service.cc.notifier.self_healing_enabled()[
        __import__("cruise_control_tpu_torch.detector", fromlist=["AnomalyType"]).AnomalyType.GOAL_VIOLATION
    ]


def test_demote_broker(service):
    status, payload = _poll(service, "POST", "demote_broker", brokerid="0", dryrun="false")
    assert status == 200
    topo = service.cc.admin.topology()
    leaders = {p.leader for p in topo.partitions}
    assert 0 not in leaders


def test_topic_configuration_rf_change(service):
    status, payload = _poll(
        service, "POST", "topic_configuration", topic="T0", replication_factor="3",
        dryrun="false",
    )
    assert status == 200
    topo = service.cc.admin.topology()
    for p in topo.partitions:
        if p.topic == "T0":
            assert len(p.replicas) == 3


def test_unknown_endpoint_and_bad_params(service):
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "GET", "nonsense")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "POST", "remove_broker")  # missing brokerid
    assert e.value.code == 400


def test_endpoint_surface_complete():
    """The reference exposes 9 GET + 11 POST endpoints
    (CruiseControlEndPoint.java:16-37) — all must exist here, plus the
    planner's read-only /rightsize (GET) and /simulate (POST), the
    observability surface /trace + /metrics + /slo + the decision
    ledger's /explain + /ledger (GET), and the fleet controller's /fleet
    rollup (GET)."""
    assert set(GET_ENDPOINTS) == {
        "bootstrap", "train", "load", "partition_load", "proposals", "state",
        "kafka_cluster_state", "user_tasks", "review_board", "rightsize",
        "trace", "metrics", "fleet", "slo", "explain", "ledger",
    }
    assert set(POST_ENDPOINTS) == {
        "add_broker", "remove_broker", "fix_offline_replicas", "rebalance",
        "stop_proposal_execution", "pause_sampling", "resume_sampling",
        "demote_broker", "admin", "review", "topic_configuration", "simulate",
    }


# ----------------------------------------------------------------- security


def _basic(user, pw):
    import base64

    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()}


def _service_config(**extra):
    return CruiseControlConfig(
        {
            "partition.metrics.window.ms": 1000,
            "min.samples.per.partition.metrics.window": 1,
            "execution.progress.check.interval.ms": 100,
            "webserver.http.port": 0,
            **extra,
        }
    )


def test_basic_auth_credentials_parsing(tmp_path):
    from cruise_control_tpu_torch.service.security import BasicSecurityProvider

    creds = tmp_path / "creds"
    creds.write_text("admin:secret\nviewer:vpw:VIEWER\n")
    p = BasicSecurityProvider(str(creds))
    assert p.authenticate({"Authorization": _basic("admin", "secret")["Authorization"]}) == (
        "admin", "ADMIN"
    )
    assert p.authenticate({"Authorization": _basic("viewer", "vpw")["Authorization"]}) == (
        "viewer", "VIEWER"
    )
    assert p.authenticate({"Authorization": _basic("admin", "wrong")["Authorization"]}) is None
    assert p.authenticate({}) is None
    # malformed lines must fail loudly, not create broken users
    bad_role = tmp_path / "bad_role"
    bad_role.write_text("user:pw:WIZARD\n")
    with pytest.raises(ValueError):
        BasicSecurityProvider(str(bad_role))
    no_pw = tmp_path / "no_pw"
    no_pw.write_text("loneuser\n")
    with pytest.raises(ValueError):
        BasicSecurityProvider(str(no_pw))


@pytest.fixture(scope="module")
def basic_auth_service(tmp_path_factory):
    creds = tmp_path_factory.mktemp("auth") / "credentials"
    creds.write_text("admin:adminpw:ADMIN\nviewer:viewerpw:VIEWER\n")
    config = _service_config(**{
        "webserver.security.enable": "true",
        "basic.auth.credentials.file": str(creds),
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=5, device="cpu")
    app.start()
    yield app
    app.stop()


def test_unauthenticated_request_gets_401(basic_auth_service):
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(basic_auth_service, "GET", "state")
    assert e.value.code == 401
    assert "WWW-Authenticate" in e.value.headers
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(basic_auth_service, "GET", "state", headers=_basic("admin", "nope"))
    assert e.value.code == 401


def test_role_enforcement(basic_auth_service):
    # VIEWER may GET but not POST (reference DefaultRoleSecurityProvider)
    status, _, _ = _request(
        basic_auth_service, "GET", "state", headers=_basic("viewer", "viewerpw")
    )
    assert status == 200
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(
            basic_auth_service, "POST", "pause_sampling",
            headers=_basic("viewer", "viewerpw"),
        )
    assert e.value.code == 403
    status, _, _ = _request(
        basic_auth_service, "POST", "pause_sampling", headers=_basic("admin", "adminpw")
    )
    assert status == 200
    _request(basic_auth_service, "POST", "resume_sampling", headers=_basic("admin", "adminpw"))


def test_jwt_auth_and_expiry():
    from cruise_control_tpu_torch.service.security import JwtSecurityProvider, jwt_encode

    config = _service_config(**{
        "webserver.security.enable": "true",
        "jwt.secret.key": "test-secret",
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=6, device="cpu")
    app.start()
    try:
        provider = app.security
        assert isinstance(provider, JwtSecurityProvider)
        admin_tok = provider.issue("ops", role="ADMIN")
        viewer_tok = provider.issue("watcher", role="VIEWER")
        expired_tok = jwt_encode(
            {"sub": "late", "role": "ADMIN", "exp": time.time() - 10}, "test-secret"
        )
        forged_tok = provider.issue("mallory", role="ADMIN")[:-4] + "AAAA"

        hdr = lambda t: {"Authorization": f"Bearer {t}"}  # noqa: E731
        status, _, _ = _request(app, "GET", "state", headers=hdr(admin_tok))
        assert status == 200
        status, _, _ = _request(
            app, "POST", "pause_sampling", headers=hdr(admin_tok)
        )
        assert status == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(app, "POST", "resume_sampling", headers=hdr(viewer_tok))
        assert e.value.code == 403
        for tok in (expired_tok, forged_tok, "garbage"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _request(app, "GET", "state", headers=hdr(tok))
            assert e.value.code == 401
        _request(app, "POST", "resume_sampling", headers=hdr(admin_tok))
    finally:
        app.stop()


def test_unknown_user_task_id_rejected(service):
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(
            service, "GET", "proposals", headers={"User-Task-ID": "no-such-task"}
        )
    assert e.value.code == 404


def test_session_rebind_resumes_same_task():
    """A client that lost the User-Task-ID header but repeats the identical
    request must resume the in-flight task, not start a second one
    (reference servlet/SessionManager.java)."""
    config = _service_config(**{
        "tpu.num.candidates": 64,
        "tpu.leadership.candidates": 16,
        "tpu.steps.per.round": 8,
        "tpu.num.rounds": 2,
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=7, device="cpu")
    app.start()
    try:
        headers = {"X-Client": "c1"}
        status, payload, _ = _request(app, "GET", "proposals", headers=headers)
        n0 = len(app.user_tasks.all_tasks())
        deadline = time.time() + 60
        while status == 202 and time.time() < deadline:
            time.sleep(0.3)
            status, payload, _ = _request(app, "GET", "proposals", headers=headers)
        assert status == 200
        assert len(app.user_tasks.all_tasks()) == n0  # no duplicate task spawned
        assert app.sessions.num_active() == 0  # released once delivered
    finally:
        app.stop()


def test_header_delivery_releases_session_binding():
    """If the final response is delivered via the User-Task-ID header path,
    the session binding must be dropped too — a later identical request must
    execute fresh rather than resume the stale completed task."""
    config = _service_config(**{
        "tpu.num.candidates": 64,
        "tpu.leadership.candidates": 16,
        "tpu.steps.per.round": 8,
        "tpu.num.rounds": 2,
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=9, device="cpu")
    app.start()
    try:
        headers = {"X-Client": "c2"}
        status, payload, h = _request(app, "GET", "proposals", headers=headers)
        tid = h.get("User-Task-ID")
        deadline = time.time() + 60
        while status == 202 and time.time() < deadline:
            time.sleep(0.3)
            # poll by HEADER (keeps the session binding out of the loop)
            status, payload, h = _request(
                app, "GET", "proposals",
                headers={"X-Client": "c2", "User-Task-ID": tid},
            )
        assert status == 200
        assert app.sessions.num_active() == 0  # header delivery released it
        # identical request again: must start a NEW task, not resume tid
        status2, _, h2 = _request(app, "GET", "proposals", headers=headers)
        assert h2.get("User-Task-ID") != tid
    finally:
        app.stop()


def test_two_step_verification_flow():
    config = CruiseControlConfig(
        {
            "partition.metrics.window.ms": 1000,
            "min.samples.per.partition.metrics.window": 1,
            "execution.progress.check.interval.ms": 100,
            "webserver.http.port": 0,
            "two.step.verification.enabled": "true",
            "tpu.num.candidates": 64,
            "tpu.leadership.candidates": 16,
            "tpu.steps.per.round": 8,
            "tpu.num.rounds": 2,
        }
    )
    app, fetcher, admin, sampler = build_simulated_service(config, seed=4, device="cpu")
    app.start()
    try:
        status, payload, _ = _request(app, "POST", "rebalance", dryrun="true")
        assert status == 200 and "reviewId" in payload
        rid = payload["reviewId"]
        status, board, _ = _request(app, "GET", "review_board")
        assert any(r["Id"] == rid for r in board["requestInfo"])
        _request(app, "POST", "review", approve=str(rid))
        status, payload = _poll(app, "POST", "rebalance", review_id=str(rid))
        assert status == 200 and "balancednessAfter" in payload
    finally:
        app.stop()


def test_ssl_listener():
    """REST over TLS (reference KafkaCruiseControlApp.java:100-120)."""
    import datetime
    import ssl as ssl_mod
    import tempfile

    pytest.importorskip("cryptography")
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name).public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=1))
        .not_valid_after(now + datetime.timedelta(hours=1))
        .sign(key, hashes.SHA256())
    )
    pem = tempfile.NamedTemporaryFile("wb", suffix=".pem", delete=False)
    pem.write(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    pem.write(cert.public_bytes(serialization.Encoding.PEM))
    pem.close()

    config = _service_config(**{
        "webserver.ssl.enable": "true",
        "webserver.ssl.certificate.location": pem.name,
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=2, device="cpu")
    app.start()
    try:
        ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl_mod.CERT_NONE
        url = f"https://{app.host}:{app.port}{app.prefix}/state?substates=monitor"
        with urllib.request.urlopen(url, context=ctx, timeout=30) as resp:
            assert resp.status == 200
            assert "MonitorState" in json.loads(resp.read())
    finally:
        app.stop()


def test_slack_notifier_posts_webhook():
    """SlackSelfHealingNotifier formats + delivers alerts
    (reference SlackSelfHealingNotifier.java); injected poster, no egress."""
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType, GoalViolations
    from cruise_control_tpu_torch.detector.notifier import (
        Action,
        SlackSelfHealingNotifier,
    )

    posts = []
    n = SlackSelfHealingNotifier(
        "https://hooks.slack.invalid/services/X",
        channel="#ops",
        poster=lambda url, body: posts.append((url, json.loads(body))),
        self_healing={AnomalyType.GOAL_VIOLATION: True},
    )
    anomaly = GoalViolations(fixable_violations=["DiskUsageDistributionGoal"])
    result = n.on_anomaly(anomaly)
    assert result.action == Action.FIX
    assert len(posts) == 1
    url, payload = posts[0]
    assert payload["channel"] == "#ops"
    assert "GOAL_VIOLATION" in payload["text"]
    # delivery failure must not propagate
    def boom(url, body):
        raise OSError("no route")
    n2 = SlackSelfHealingNotifier(
        "https://x.invalid", poster=boom,
        self_healing={AnomalyType.GOAL_VIOLATION: True},
    )
    assert n2.on_anomaly(anomaly).action == Action.FIX


def test_execution_overrides_reach_executor():
    """Per-request caps/throttle (reference ParameterUtils request params)
    must override the config-level defaults in ExecutionOptions."""
    from cruise_control_tpu_torch.service.server import _parse_execution_overrides

    ov = _parse_execution_overrides({
        "concurrent_partition_movements_per_broker": ["9"],
        "concurrent_leader_movements": ["77"],
        "replication_throttle": ["12345"],
    })
    assert ov == {
        "concurrent_partition_movements_per_broker": 9,
        "concurrent_leader_movements": 77,
        "replication_throttle": 12345.0,
    }
    with pytest.raises(Exception):
        _parse_execution_overrides({"concurrent_leader_movements": ["xyz"]})

    app, fetcher, admin, sampler = build_simulated_service(seed=21, device="cpu")
    captured = {}
    real = app.cc.executor.execute_proposals

    def spy(proposals, options=None, **kw):
        captured["options"] = options
        return real(proposals, options, **kw)

    app.cc.executor.execute_proposals = spy
    try:
        out = app.cc.rebalance(
            OperationProgress(), dryrun=False,
            execution_overrides={
                "concurrent_partition_movements_per_broker": 9,
                "concurrent_leader_movements": 77,
                "replication_throttle": 12345.0,
            },
        )
        if "execution" in out:  # moves existed -> executor ran
            opts = captured["options"]
            assert opts.concurrent_partition_movements_per_broker == 9
            assert opts.concurrent_leader_movements == 77
            assert opts.replication_throttle_bytes_per_s == 12345.0
    finally:
        app.stop()


def test_operation_audit_log(service, caplog):
    """Every REST operation lands one line in the operations audit logger
    (reference OPERATION_LOGGER)."""
    import logging

    with caplog.at_level(logging.INFO, logger="cruisecontrol.operations"):
        _request(service, "GET", "state")
    recs = [r for r in caplog.records if r.name == "cruisecontrol.operations"]
    assert recs and "GET state" in recs[-1].getMessage()
    assert "-> 200" in recs[-1].getMessage()


def test_parse_bootstrap_servers():
    """IPv4/hostname/IPv6 bootstrap parsing (ADVICE r2: rpartition(':')
    mangled IPv6 literals)."""
    import pytest

    from cruise_control_tpu_torch.service.main import parse_bootstrap_servers as parse

    assert parse("h1:9092,h2:9093") == [("h1", 9092), ("h2", 9093)]
    assert parse("h1") == [("h1", 9092)]
    assert parse(":9094") == [("127.0.0.1", 9094)]
    assert parse("::1") == [("::1", 9092)]
    assert parse("[::1]") == [("::1", 9092)]
    assert parse("[::1]:9095") == [("::1", 9095)]
    assert parse("[2001:db8::2]:9096, h7:9097") == [
        ("2001:db8::2", 9096), ("h7", 9097)
    ]
    for bad in ("h1:x", "[::1", "[::1]9092", "", "h1:"):
        with pytest.raises(ValueError):
            parse(bad)


def test_unknown_and_malformed_parameters_rejected(service):
    """Declared-parameter validation (reference CruiseControlParametersConfig
    parameter classes): unknown names and bad values 400 instead of being
    silently ignored."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "POST", "rebalance", dry_run="true")
    assert e.value.code == 400
    assert "unknown parameter" in json.loads(e.value.read())["errorMessage"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "GET", "proposals", ignore_proposal_cache="maybe")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "POST", "add_broker", brokerid="zero")
    assert e.value.code == 400


class UpperCaseReasonParameters:
    """Custom parameters class for tests: extends the builtin set."""

    def __init__(self, endpoint, builtin):
        self.builtin = builtin

    def parse(self, raw):
        out = self.builtin.parse({k: v for k, v in raw.items() if k != "shout"})
        if "shout" in raw:
            out["shout"] = raw["shout"][0]
        return out


def custom_pause_handler(app, endpoint, parsed):
    # custom request classes receive the PARSED parameter dict
    reason = parsed.get("reason", "user request")
    app.cc.monitor.pause(reason.upper())
    return 200, {"message": f"sampling paused: {reason.upper()}"}


def test_parameter_and_request_class_override_maps():
    """{endpoint}.parameters.class / {endpoint}.request.class plug custom
    classes per endpoint (reference CruiseControlRequestConfig)."""
    config = CruiseControlConfig({
        "pause_sampling.parameters.class":
            "tests.test_service.UpperCaseReasonParameters",
        "pause_sampling.request.class":
            "tests.test_service.custom_pause_handler",
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=21, device="cpu")
    app.start()
    try:
        # the custom parameters class accepts `shout`, builtin would 400
        status, payload, _ = _request(
            app, "POST", "pause_sampling", reason="drill", shout="1"
        )
        assert status == 200
        assert payload["message"] == "sampling paused: DRILL"
    finally:
        app.stop()


def test_two_step_rejects_invalid_params_before_parking():
    """An invalid request must 400 immediately, not park in the purgatory
    with a 200 and burn its approval on resubmit."""
    config = CruiseControlConfig({"two.step.verification.enabled": "true"})
    app, fetcher, admin, sampler = build_simulated_service(config, seed=22, device="cpu")
    app.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(app, "POST", "rebalance", dry_run="true")
        assert e.value.code == 400
        # a VALID request still parks for review
        status, payload, _ = _request(app, "POST", "rebalance", dryrun="true")
        assert status == 200 and "reviewId" in payload
    finally:
        app.stop()


def capture_rebalance_handler(app, endpoint, parsed):
    return 200, {"numReplicaMovements": 0, "numLeaderMovements": 0,
                 "dataToMoveMB": 0, "balancednessBefore": 0.0,
                 "balancednessAfter": 0.0, "objectiveBefore": 0.0,
                 "objectiveAfter": 0.0, "violatedGoalsAfter": [],
                 "wallSeconds": 0.0, "proposals": [],
                 "execution": {"parsedSeen": {k: str(v) for k, v in parsed.items()}}}


def test_two_step_resubmit_passes_merged_parsed_to_custom_handler():
    """After approval, a custom request class must see the PARKED parameters
    (merged + re-parsed), not just the resubmit's review_id."""
    config = CruiseControlConfig({
        "two.step.verification.enabled": "true",
        "rebalance.request.class": "tests.test_service.capture_rebalance_handler",
    })
    app, fetcher, admin, sampler = build_simulated_service(config, seed=23, device="cpu")
    app.start()
    try:
        status, payload, _ = _request(
            app, "POST", "rebalance", dryrun="true", excluded_topics="T0"
        )
        assert status == 200 and "reviewId" in payload
        rid = payload["reviewId"]
        status, payload, _ = _request(app, "POST", "review", approve=str(rid))
        assert status == 200
        status, payload, _ = _request(app, "POST", "rebalance", review_id=str(rid))
        assert status == 200
        seen = payload["execution"]["parsedSeen"]
        assert seen.get("dryrun") == "True"
        assert seen.get("excluded_topics") == "T0"
    finally:
        app.stop()


def test_admin_concurrency_change_mid_execution():
    """Reference AdminParameters.java:31-38 ChangeExecutionConcurrency:
    an operator halts/accelerates a LIVE rebalance via POST /admin; the
    executor consults the change on its next progress tick."""
    import threading

    app, fetcher, admin, sampler = build_simulated_service(seed=31, device="cpu")
    app.start()
    try:
        gate = threading.Event()
        orig_tick = admin.tick

        def gated_tick(seconds):
            time.sleep(0.02)
            # no progress until the test releases the gate — keeps the
            # execution alive regardless of proposal sizes
            return orig_tick(seconds if gate.is_set() else 0.0)

        admin.tick = gated_tick

        status, first, headers = _request(app, "POST", "rebalance", dryrun="false")
        tid = headers.get("User-Task-ID")
        deadline = time.time() + 30
        while not app.cc.executor.has_ongoing_execution and time.time() < deadline:
            time.sleep(0.05)
        assert app.cc.executor.has_ongoing_execution, "execution never started"

        status2, payload2, _ = _request(
            app, "POST", "admin",
            concurrent_partition_movements_per_broker="8",
            concurrent_leader_movements="500",
            execution_progress_check_interval_ms="50",
        )
        assert status2 == 200
        assert payload2["ongoingExecution"] is True
        assert payload2["requestedConcurrency"] == {
            "inter_broker": 8, "leadership": 500, "interval_s": 0.05,
        }
        # the LIVE executor sees it (next tick reads these, not the frozen
        # ExecutionOptions)
        assert app.cc.executor.requested_concurrency()["inter_broker"] == 8
        # and STATE surfaces it
        st, state_payload, _ = _request(app, "GET", "state", substates="executor")
        assert state_payload["ExecutorState"]["requestedConcurrency"][
            "inter_broker"] == 8

        gate.set()  # let the execution drain
        status3, payload3, _ = _request(
            app, "POST", "rebalance", dryrun="false",
            headers={"User-Task-ID": tid},
        )
        deadline = time.time() + 60
        while status3 == 202 and time.time() < deadline:
            time.sleep(0.2)
            status3, payload3, _ = _request(
                app, "POST", "rebalance", dryrun="false",
                headers={"User-Task-ID": tid},
            )
        assert status3 == 200
        if "execution" in payload3:
            assert payload3["execution"]["dead"] == 0
    finally:
        app.stop()


def test_admin_concurrency_rejects_bad_values(service):
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "POST", "admin",
                 concurrent_partition_movements_per_broker="0")
    assert e.value.code == 400


def test_admin_concurrency_requires_ongoing_execution(service):
    """Overrides die with the execution, so accepting one while idle would
    200 a silent no-op — the reference rejects it (AdminParameters)."""
    import urllib.error

    assert not service.cc.executor.has_ongoing_execution
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "POST", "admin", concurrent_leader_movements="5")
    assert e.value.code == 400
    assert service.cc.executor.requested_concurrency() == {}


def test_admin_drop_recently_demoted_brokers(service):
    ex = service.cc.executor
    ex._demoted_history[4] = int(time.time() * 1000)
    status, payload, _ = _request(
        service, "POST", "admin", drop_recently_demoted_brokers="4"
    )
    assert status == 200
    assert 4 not in ex.demoted_brokers
    assert payload["recentlyDemotedBrokers"] == sorted(ex.demoted_brokers)


def test_long_running_task_survives_retention_after_completion():
    """Purgatory-retention audit for long-running async ops: a task whose
    EXECUTION outlives the completed-task retention window (a rightsize
    search, a big simulate batch) must stay pollable for the full window
    AFTER completion — retention counts from completion, not creation.
    Under the old creation-stamped retention the record expired the moment
    it finished, 404ing the poll that was waiting on it."""
    import threading

    from cruise_control_tpu_torch.service.tasks import UserTaskManager

    utm = UserTaskManager(completed_retention_ms=150, max_cached_completed=10)
    try:
        gate = threading.Event()

        def long_op(progress):
            gate.wait(10)
            return {"provisionStatus": "RIGHT_SIZED"}

        task = utm.submit("rightsize", long_op)
        time.sleep(0.4)  # run well past the 150ms retention window
        # in-execution: eviction scans must never touch it
        utm.submit("load", lambda p: {})
        assert utm.get(task.task_id) is not None
        gate.set()
        task.future.result(timeout=10)
        # freshly completed (older than retention since CREATION): an
        # eviction scan must keep it — the client has not polled yet
        utm.submit("load", lambda p: {})
        resumed = utm.get(task.task_id)
        assert resumed is not None, "completed task expired before it could be polled"
        assert resumed.future.result()["provisionStatus"] == "RIGHT_SIZED"
        # ...and once the window has passed SINCE COMPLETION it may expire
        time.sleep(0.4)
        utm.submit("load", lambda p: {})
        assert utm.get(task.task_id) is None
    finally:
        utm.shutdown()


def test_user_tasks_filters(service):
    # seed at least one completed task
    _poll(service, "GET", "load")
    status, payload, _ = _request(service, "GET", "user_tasks")
    all_tasks = payload["userTasks"]
    assert all_tasks
    # endpoints filter
    status, by_ep, _ = _request(service, "GET", "user_tasks", endpoints="load")
    assert by_ep["userTasks"]
    assert all("load" in t["RequestURL"].lower() for t in by_ep["userTasks"])
    # types filter (task status names)
    status, by_type, _ = _request(service, "GET", "user_tasks", types="Completed")
    assert all(t["Status"] == "Completed" for t in by_type["userTasks"])
    # user_task_ids filter
    tid = all_tasks[0]["UserTaskId"]
    status, by_id, _ = _request(service, "GET", "user_tasks", user_task_ids=tid)
    assert [t["UserTaskId"] for t in by_id["userTasks"]] == [tid]
    # client_ids filter with a known client identity
    status, _p, _ = _request(
        service, "GET", "proposals", headers={"X-Client": "filter-me"}
    )
    deadline = time.time() + 30
    while time.time() < deadline:
        status, by_client, _ = _request(
            service, "GET", "user_tasks", client_ids="filter-me"
        )
        if by_client["userTasks"]:
            break
        time.sleep(0.1)
    assert by_client["userTasks"]
    assert all(t["ClientIdentity"] == "filter-me" for t in by_client["userTasks"])
    # non-matching filter returns empty, not everything
    status, none, _ = _request(service, "GET", "user_tasks", client_ids="nobody")
    assert none["userTasks"] == []


# -------------------------------------------- observability (PR 6 surface)


def _raw_get(app, endpoint, **params):
    """GET returning the raw body (the /metrics exposition is text)."""
    req = urllib.request.Request(_url(app, endpoint, **params), method="GET")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read().decode(), dict(resp.headers)


def _flatten_spans(nodes):
    out = []
    for n in nodes:
        out.append(n)
        out.extend(_flatten_spans(n["children"]))
    return out


def test_metrics_endpoint_is_lintable_prometheus_text(service):
    from cruise_control_tpu_torch.common.exposition import parse_exposition

    # make sure at least one proposal ran so analyzer sensors exist
    _poll(service, "GET", "proposals")
    status, body, headers = _raw_get(service, "metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    fams = parse_exposition(body)  # raises ExpositionError on any lint hit
    assert "cruisecontrol_analyzer_proposal_computation_timer_seconds" in fams
    assert (
        fams["cruisecontrol_analyzer_proposal_computation_seconds"]["type"]
        == "histogram"
    )
    # the device-memory surface registered by the facade is scrapeable
    assert "cruisecontrol_tpu_device_live_buffers" in fams


def test_trace_of_a_proposal_covers_monitor_analyzer_device(service):
    """A fresh (cache-bypassing) proposal computation yields one trace
    whose tree covers model build -> optimize -> supervised device op,
    with the engine-run timing attached as span attributes."""
    status, payload = _poll(
        service, "GET", "proposals", ignore_proposal_cache="true"
    )
    assert status == 200
    tid = payload.get("_traceId")
    assert tid, "200 responses must carry the flight-recorder trace id"
    status, trace, _ = _request(service, "GET", "trace", id=tid)
    assert status == 200
    assert trace["traceId"] == tid
    spans = _flatten_spans(trace["spans"])
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], s)
    assert "service.proposals" in by_name
    assert by_name["service.proposals"]["parentId"] is None
    assert "monitor.cluster_model" in by_name
    assert by_name["monitor.cluster_model"]["attributes"]["brokers"] >= 6
    opt = by_name["analyzer.optimize"]
    assert opt["component"] == "analyzer"
    attrs = opt["attributes"]
    assert "device_s" in attrs
    assert "engine_cache_hit" in attrs
    assert "bucket" in attrs
    # the supervised device op nests under the optimize span
    dev = by_name["device.optimize"]
    assert dev["component"] == "device"
    assert dev["attributes"]["attempts"] >= 1
    # every span of the tree shares the one trace id
    assert {s["traceId"] for s in spans} == {tid}
    # ...and the user-task record carries the same handle
    status, tasks, _ = _request(service, "GET", "user_tasks")
    assert tid in {t.get("TraceId") for t in tasks["userTasks"]}


def test_trace_index_and_unknown_id(service):
    _poll(service, "GET", "proposals")
    status, payload, _ = _request(service, "GET", "trace")
    assert status == 200
    assert payload["traces"], "recent root traces must be listed"
    names = {t["name"] for t in payload["traces"]}
    assert any(n.startswith("service.") for n in names)
    # limit is respected
    status, one, _ = _request(service, "GET", "trace", limit=1)
    assert len(one["traces"]) == 1
    # unknown id -> 404, not an empty tree
    with pytest.raises(urllib.error.HTTPError) as e:
        _request(service, "GET", "trace", id="deadbeef" * 4)
    assert e.value.code == 404


def test_tracing_disabled_service_serves_empty_surface():
    """trace.enabled=false: no spans recorded, no _traceId riders, but the
    endpoints stay well-formed (a scraper never 500s)."""
    config = _service_config(**{
        "trace.enabled": "false",
        "tpu.num.candidates": 128,
        "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 16,
        "tpu.num.rounds": 2,
    })
    app, fetcher, admin, sampler = build_simulated_service(config, device="cpu")
    app.start()
    try:
        status, payload = _poll(app, "GET", "proposals")
        assert status == 200
        assert "_traceId" not in payload
        status, idx, _ = _request(app, "GET", "trace")
        assert status == 200 and idx["traces"] == []
    finally:
        app.stop()
