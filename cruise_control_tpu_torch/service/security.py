"""Pluggable security providers: basic auth, JWT, roles, sessions.

Reference: servlet/security/SecurityProvider.java (SPI),
BasicSecurityProvider.java (credentials file with roles),
jwt/JwtAuthenticator.java + JwtLoginService.java (token auth),
servlet/SessionManager.java (session -> task binding with expiry).

JWT here is HS256 via stdlib hmac — no external dependency; RS256 key
loading can be plugged behind the same provider SPI.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import uuid
from typing import Protocol

# roles (reference DefaultRoleSecurityProvider: VIEWER/USER/ADMIN)
VIEWER = "VIEWER"
USER = "USER"
ADMIN = "ADMIN"

#: minimum role required per endpoint type (reference CruiseControlEndpointType)
ENDPOINT_ROLE = {
    "GET": VIEWER,
    "POST": ADMIN,
}
_ROLE_RANK = {VIEWER: 0, USER: 1, ADMIN: 2}


class SecurityProvider(Protocol):
    """Reference servlet/security/SecurityProvider.java."""

    def authenticate(self, headers) -> tuple[str, str] | None:
        """-> (principal, role) or None if unauthenticated."""

    def authorize(self, role: str, method: str, endpoint: str) -> bool:
        ...


class AllowAllSecurityProvider:
    def authenticate(self, headers):
        return ("anonymous", ADMIN)

    def authorize(self, role, method, endpoint):
        return True


class BasicSecurityProvider:
    """Credentials file: `user:password[:role]` lines
    (reference BasicSecurityProvider + basic-auth.credentials fixture)."""

    def __init__(self, credentials_path: str):
        self._users: dict[str, tuple[str, str]] = {}
        with open(credentials_path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(":", 2)
                if len(parts) < 2:
                    raise ValueError(
                        f"{credentials_path}:{lineno}: expected user:password[:role]"
                    )
                user, pw = parts[0], parts[1]
                role = parts[2].strip().upper() if len(parts) > 2 else ADMIN
                if role not in _ROLE_RANK:
                    raise ValueError(
                        f"{credentials_path}:{lineno}: unknown role {role!r} "
                        f"(expected one of {sorted(_ROLE_RANK)})"
                    )
                self._users[user] = (pw, role)

    def authenticate(self, headers):
        header = headers.get("Authorization", "")
        if not header.startswith("Basic "):
            return None
        try:
            user, _, pw = base64.b64decode(header[6:]).decode().partition(":")
        except Exception:  # noqa: BLE001
            return None
        entry = self._users.get(user)
        if entry is None or not hmac.compare_digest(entry[0], pw):
            return None
        return (user, entry[1])

    def authorize(self, role, method, endpoint):
        return _ROLE_RANK.get(role, -1) >= _ROLE_RANK[ENDPOINT_ROLE.get(method, ADMIN)]


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_encode(claims: dict, secret: str) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    signing = f"{header}.{payload}".encode()
    sig = _b64url(hmac.new(secret.encode(), signing, hashlib.sha256).digest())
    return f"{header}.{payload}.{sig}"


def jwt_decode(token: str, secret: str) -> dict | None:
    try:
        header, payload, sig = token.split(".")
        signing = f"{header}.{payload}".encode()
        expected = _b64url(hmac.new(secret.encode(), signing, hashlib.sha256).digest())
        if not hmac.compare_digest(expected, sig):
            return None
        claims = json.loads(_b64url_decode(payload))
    except Exception:  # noqa: BLE001
        return None
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        return None
    return claims


def jwt_decode_rs256(token: str, public_key) -> dict | None:
    """Verify an RS256 (RSASSA-PKCS1-v1_5 / SHA-256) JWT against a public
    key — certificate-based tokens, reference
    servlet/security/jwt/JwtAuthenticator.java:1 (shared-secret HS256 across
    services is a deployment blocker; the issuer signs with its private key
    and the service verifies with the cert)."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        if header.get("alg") != "RS256":
            return None
        public_key.verify(
            _b64url_decode(sig_b64),
            f"{header_b64}.{payload_b64}".encode(),
            padding.PKCS1v15(),
            hashes.SHA256(),
        )
        claims = json.loads(_b64url_decode(payload_b64))
    except InvalidSignature:
        return None
    except Exception:  # noqa: BLE001 — malformed token shapes
        return None
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        return None
    return claims


def extract_bearer_token(headers, cookie_name: str | None = None) -> str | None:
    """Token from `Authorization: Bearer ...`, else from the configured
    cookie (reference WebServerConfig jwt.cookie.name; header wins)."""
    header = headers.get("Authorization", "")
    if header.startswith("Bearer "):
        return header[7:]
    if cookie_name:
        from http.cookies import SimpleCookie

        jar = SimpleCookie()
        try:
            jar.load(headers.get("Cookie", ""))
        except Exception:  # noqa: BLE001 — malformed cookie header
            return None
        morsel = jar.get(cookie_name)
        if morsel is not None:
            return morsel.value
    return None


def audience_ok(claims: dict, expected: list[str] | None) -> bool:
    """aud claim must intersect the configured audiences when set
    (reference JwtAuthenticator expected-audiences check)."""
    if not expected:
        return True
    aud = claims.get("aud")
    if aud is None:
        return False
    auds = {aud} if isinstance(aud, str) else set(aud)
    return bool(auds & set(expected))


def load_public_key(pem_path: str):
    """Load an RSA public key from a PEM file holding either a bare public
    key or an X.509 certificate (the reference's JwtLoginService takes a
    certificate)."""
    from cryptography.hazmat.primitives.serialization import load_pem_public_key
    from cryptography.x509 import load_pem_x509_certificate

    with open(pem_path, "rb") as f:
        data = f.read()
    if b"CERTIFICATE" in data:
        return load_pem_x509_certificate(data).public_key()
    return load_pem_public_key(data)


class JwtRs256SecurityProvider:
    """Public-key bearer-token auth (reference servlet/security/jwt/
    JwtAuthenticator.java:1 + JwtLoginService certificate verification).

    The service holds only the PUBLIC key/certificate
    (jwt.authentication.certificate.location); tokens are minted elsewhere
    with the private key — no shared secret crosses service boundaries.
    """

    def __init__(
        self,
        certificate_path: str,
        *,
        default_role: str = USER,
        cookie_name: str | None = None,
        expected_audiences: list[str] | None = None,
    ):
        self.public_key = load_public_key(certificate_path)
        self.default_role = default_role
        self.cookie_name = cookie_name
        self.expected_audiences = expected_audiences or None

    def authenticate(self, headers):
        token = extract_bearer_token(headers, self.cookie_name)
        if token is None:
            return None
        claims = jwt_decode_rs256(token, self.public_key)
        if claims is None or not audience_ok(claims, self.expected_audiences):
            return None
        return (claims.get("sub", "unknown"), claims.get("role", self.default_role))

    def authorize(self, role, method, endpoint):
        return _ROLE_RANK.get(role, -1) >= _ROLE_RANK[ENDPOINT_ROLE.get(method, ADMIN)]


class JwtSecurityProvider:
    """HS256 bearer-token auth (reference servlet/security/jwt/).

    Expects `Authorization: Bearer <jwt>` with claims {sub, role, exp}.
    `issue()` mints tokens for tests/trusted issuers.
    """

    def __init__(
        self,
        secret: str,
        *,
        default_role: str = USER,
        cookie_name: str | None = None,
        expected_audiences: list[str] | None = None,
    ):
        self.secret = secret
        self.default_role = default_role
        self.cookie_name = cookie_name
        self.expected_audiences = expected_audiences or None

    def issue(self, subject: str, role: str = ADMIN, ttl_s: int = 3600) -> str:
        return jwt_encode(
            {"sub": subject, "role": role, "exp": time.time() + ttl_s}, self.secret
        )

    def authenticate(self, headers):
        token = extract_bearer_token(headers, self.cookie_name)
        if token is None:
            return None
        claims = jwt_decode(token, self.secret)
        if claims is None or not audience_ok(claims, self.expected_audiences):
            return None
        return (claims.get("sub", "unknown"), claims.get("role", self.default_role))

    def authorize(self, role, method, endpoint):
        return _ROLE_RANK.get(role, -1) >= _ROLE_RANK[ENDPOINT_ROLE.get(method, ADMIN)]


class SessionManager:
    """Session-key -> in-flight task binding with expiry
    (reference servlet/SessionManager.java): lets a client that lost the
    User-Task-ID header resume its async request by session."""

    def __init__(self, max_expiry_ms: int = 3_600_000, max_sessions: int = 100):
        self._sessions: dict[str, tuple[str, int]] = {}  # key -> (task_id, created)
        self._lock = threading.Lock()
        self.max_expiry_ms = max_expiry_ms
        self.max_sessions = max_sessions

    @staticmethod
    def session_key(client: str, method: str, endpoint: str, query: str) -> str:
        return hashlib.sha256(f"{client}|{method}|{endpoint}|{query}".encode()).hexdigest()

    def get_or_bind(self, key: str, task_id_factory) -> str:
        now = int(time.time() * 1000)
        with self._lock:
            self._expire(now)
            entry = self._sessions.get(key)
            if entry is not None:
                return entry[0]
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError("too many active sessions")
            task_id = task_id_factory()
            self._sessions[key] = (task_id, now)
            return task_id

    def release(self, key: str):
        with self._lock:
            self._sessions.pop(key, None)

    def release_task(self, task_id: str):
        """Unbind every session pointing at task_id (used when the task's
        response was delivered via the User-Task-ID header path, so a later
        identical request must execute fresh rather than resume it)."""
        with self._lock:
            for k in [k for k, (t, _) in self._sessions.items() if t == task_id]:
                del self._sessions[k]

    def _expire(self, now: int):
        for k in [
            k for k, (_, t) in self._sessions.items() if now - t > self.max_expiry_ms
        ]:
            del self._sessions[k]

    def num_active(self) -> int:
        with self._lock:
            return len(self._sessions)
