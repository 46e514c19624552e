"""The JAX package's tests/test_schemas.py, pointed at the port on the CPU.

Response-schema conformance + RS256 JWT tests.

Reference: servlet/response/ResponseTest.java:1 (every response class
declares its schema) + servlet/security/jwt/JwtAuthenticator.java:1
(certificate-based token verification).
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from cruise_control_tpu_torch.config.app_config import CruiseControlConfig
from cruise_control_tpu_torch.service.main import build_simulated_service
from cruise_control_tpu_torch.service.schemas import (
    RESPONSE_SCHEMAS,
    validate_response,
)
from cruise_control_tpu_torch.service.server import GET_ENDPOINTS, POST_ENDPOINTS


@pytest.fixture(scope="module")
def service():
    app, fetcher, admin, sampler = build_simulated_service(seed=11, device="cpu")
    app.start()
    yield app
    app.stop()


def _req(app, method, endpoint, headers=None, **params):
    q = "&".join(f"{k}={v}" for k, v in params.items())
    url = f"http://{app.host}:{app.port}{app.prefix}/{endpoint}" + (f"?{q}" if q else "")
    req = urllib.request.Request(url, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _poll(app, method, endpoint, **params):
    status, payload, headers = _req(app, method, endpoint, **params)
    tid = headers.get("User-Task-ID")
    deadline = time.time() + 120
    while status == 202 and time.time() < deadline:
        # 202 progress bodies conform too
        assert validate_response(endpoint, payload, status=202) == []
        time.sleep(0.3)
        status, payload, headers = _req(
            app, method, endpoint, headers={"User-Task-ID": tid}, **params
        )
    return status, payload


def test_every_endpoint_has_a_declared_schema():
    """The registry covers the full endpoint surface — adding an endpoint
    without declaring its response schema fails here (ResponseTest role)."""
    assert set(RESPONSE_SCHEMAS) == set(GET_ENDPOINTS) | set(POST_ENDPOINTS)


# (endpoint, method, params) driven against the live simulated service
CASES = [
    ("state", "GET", {}),
    ("state", "GET", {"substates": "monitor,sensors"}),
    ("kafka_cluster_state", "GET", {}),
    ("load", "GET", {}),
    ("partition_load", "GET", {"resource": "NW_IN", "entries": "5"}),
    ("proposals", "GET", {}),
    ("user_tasks", "GET", {}),
    ("review_board", "GET", {}),
    ("train", "GET", {}),
    ("rebalance", "POST", {"dryrun": "true"}),
    ("add_broker", "POST", {"brokerid": "0", "dryrun": "true"}),
    ("remove_broker", "POST", {"brokerid": "1", "dryrun": "true"}),
    ("demote_broker", "POST", {"brokerid": "0", "dryrun": "true"}),
    ("fix_offline_replicas", "POST", {"dryrun": "true"}),
    ("topic_configuration", "POST",
     {"topic": "T0", "replication_factor": "2", "dryrun": "true"}),
    ("pause_sampling", "POST", {}),
    ("resume_sampling", "POST", {}),
    ("admin", "POST", {"enable_self_healing_for": "broker_failure"}),
    ("stop_proposal_execution", "POST", {}),
    # compact JSON: the raw-URL helper does not percent-encode spaces
    ("simulate", "POST",
     {"scenarios": '[{"name":"add-one","addBrokers":[{"count":1}]}]'}),
    ("rightsize", "GET", {}),
    ("trace", "GET", {}),
    ("fleet", "GET", {}),
]
# /metrics is absent from CASES on purpose: its body is Prometheus TEXT,
# validated by the exposition lint gate (scripts/check.sh +
# tests/test_trace.py), not by the JSON schema walker.


@pytest.mark.parametrize("endpoint,method,params", CASES,
                         ids=[f"{m} {e} {p}" for e, m, p in CASES])
def test_live_response_conforms_to_declared_schema(service, endpoint, method, params):
    status, payload = _poll(service, method, endpoint, **params)
    assert status == 200, payload
    problems = validate_response(endpoint, payload, status=status)
    assert problems == [], problems


def test_error_response_schema(service):
    status, payload, _ = _req(service, "GET", "partition_load", resource="BOGUS")
    assert status == 400
    assert validate_response("partition_load", payload, status=status) == []


def test_schema_validator_catches_drift():
    ok = {"message": "sampling resumed"}
    assert validate_response("resume_sampling", ok) == []
    assert validate_response("resume_sampling", {}) != []  # missing field
    assert validate_response("resume_sampling", {"message": 3}) != []  # wrong type
    assert validate_response(
        "resume_sampling", {"message": "x", "surprise": 1}
    ) != []  # undeclared field


# ---------------------------------------------------------------- RS256


def _rsa_keypair(tmp_path):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pub_pem = key.public_key().public_bytes(
        serialization.Encoding.PEM, serialization.PublicFormat.SubjectPublicKeyInfo
    )
    pub_path = tmp_path / "jwt_pub.pem"
    pub_path.write_bytes(pub_pem)
    return key, str(pub_path)


def _rs256_token(private_key, claims):
    import base64

    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    def b64(b):
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

    header = b64(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    payload = b64(json.dumps(claims).encode())
    sig = private_key.sign(
        f"{header}.{payload}".encode(), padding.PKCS1v15(), hashes.SHA256()
    )
    return f"{header}.{payload}.{b64(sig)}"


def test_rs256_jwt_provider_end_to_end(tmp_path):
    """Service accepts only tokens signed by the certificate's private key
    (reference JwtAuthenticator/JwtLoginService)."""
    key, pub_path = _rsa_keypair(tmp_path)
    config = CruiseControlConfig({
        "webserver.security.enable": "true",
        "jwt.authentication.certificate.location": pub_path,
    })
    app, *_ = build_simulated_service(config, seed=12, device="cpu")
    app.start()
    try:
        good = _rs256_token(
            key, {"sub": "ops", "role": "ADMIN", "exp": time.time() + 600}
        )
        status, payload, _ = _req(
            app, "GET", "state", headers={"Authorization": f"Bearer {good}"}
        )
        assert status == 200

        # no token -> 401
        status, _, _ = _req(app, "GET", "state")
        assert status == 401

        # token signed by a DIFFERENT key -> 401
        from cryptography.hazmat.primitives.asymmetric import rsa

        other = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        forged = _rs256_token(
            other, {"sub": "evil", "role": "ADMIN", "exp": time.time() + 600}
        )
        status, _, _ = _req(
            app, "GET", "state", headers={"Authorization": f"Bearer {forged}"}
        )
        assert status == 401

        # expired token -> 401
        expired = _rs256_token(
            key, {"sub": "ops", "role": "ADMIN", "exp": time.time() - 10}
        )
        status, _, _ = _req(
            app, "GET", "state", headers={"Authorization": f"Bearer {expired}"}
        )
        assert status == 401

        # VIEWER role cannot POST
        viewer = _rs256_token(
            key, {"sub": "ro", "role": "VIEWER", "exp": time.time() + 600}
        )
        status, _, _ = _req(
            app, "POST", "pause_sampling",
            headers={"Authorization": f"Bearer {viewer}"},
        )
        assert status == 403
    finally:
        app.stop()
