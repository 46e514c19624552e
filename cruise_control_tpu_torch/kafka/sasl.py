"""SASL/SCRAM-SHA-256 + SCRAM-SHA-512 (RFC 5802/7677) for the wire client.

Reference parity: the reference service gets SASL for free from the JVM
clients via JAAS (config/cruise_control_jaas.conf_template); this client
speaks the SaslHandshake (key 17) + SaslAuthenticate (key 36) exchange
itself.  Both halves of SCRAM live here: the client exchange used by
BrokerConnection, and the server-side verifier used by the fake broker so
the contract can be tested end to end over live sockets.

PLAIN (RFC 4616) is also provided — some clusters still terminate SASL
PLAIN over TLS.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import os


_HASHES = {
    "SCRAM-SHA-256": hashlib.sha256,
    "SCRAM-SHA-512": hashlib.sha512,
}


@dataclasses.dataclass(frozen=True)
class SaslCredentials:
    """What the operator configures (sasl.mechanism/username/password)."""

    username: str
    password: str
    mechanism: str = "SCRAM-SHA-256"

    def __post_init__(self):
        if self.mechanism not in (*_HASHES, "PLAIN"):
            raise ValueError(
                f"unsupported sasl.mechanism {self.mechanism!r}; "
                f"supported: PLAIN, {', '.join(_HASHES)}"
            )


def _hm(h, key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, h).digest()


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def salted_password(mechanism: str, password: str, salt: bytes, iterations: int) -> bytes:
    h = _HASHES[mechanism]
    return hashlib.pbkdf2_hmac(h().name, password.encode(), salt, iterations)


def _escape(username: str) -> str:
    return username.replace("=", "=3D").replace(",", "=2C")


class ScramClient:
    """Client half of one SCRAM conversation.

    first() -> client-first-message; final(server_first) -> client-final;
    verify(server_final) checks the server signature (mutual auth).
    """

    def __init__(self, creds: SaslCredentials, nonce: str | None = None):
        self.creds = creds
        self.h = _HASHES[creds.mechanism]
        self.cnonce = nonce or base64.b64encode(os.urandom(18)).decode()
        self._client_first_bare = f"n={_escape(creds.username)},r={self.cnonce}"
        self._server_sig: bytes | None = None

    def first(self) -> bytes:
        return f"n,,{self._client_first_bare}".encode()

    def final(self, server_first: bytes) -> bytes:
        sf = server_first.decode()
        attrs = dict(kv.split("=", 1) for kv in sf.split(","))
        rnonce, salt, iters = attrs["r"], base64.b64decode(attrs["s"]), int(attrs["i"])
        if not rnonce.startswith(self.cnonce):
            raise ValueError("server nonce does not extend client nonce")
        salted = salted_password(self.creds.mechanism, self.creds.password, salt, iters)
        client_key = _hm(self.h, salted, b"Client Key")
        stored_key = self.h(client_key).digest()
        channel = base64.b64encode(b"n,,").decode()
        auth_msg = f"{self._client_first_bare},{sf},c={channel},r={rnonce}".encode()
        client_sig = _hm(self.h, stored_key, auth_msg)
        proof = base64.b64encode(_xor(client_key, client_sig)).decode()
        server_key = _hm(self.h, salted, b"Server Key")
        self._server_sig = _hm(self.h, server_key, auth_msg)
        return f"c={channel},r={rnonce},p={proof}".encode()

    def verify(self, server_final: bytes) -> None:
        attrs = dict(kv.split("=", 1) for kv in server_final.decode().split(","))
        if "e" in attrs:
            raise PermissionError(f"SASL authentication failed: {attrs['e']}")
        if self._server_sig is None or not hmac.compare_digest(
            base64.b64decode(attrs["v"]), self._server_sig
        ):
            raise PermissionError("server signature mismatch (not the real broker?)")


class ScramServer:
    """Server half, for the fake broker: verifies a client conversation
    against a username -> password table (a real broker stores the derived
    StoredKey/ServerKey in ZK/KRaft; deriving from the password here keeps
    the fake simple while exercising the same math)."""

    def __init__(self, mechanism: str, users: dict[str, str], *, iterations: int = 4096):
        self.mechanism = mechanism
        self.h = _HASHES[mechanism]
        self.users = users
        self.iterations = iterations
        self._state: dict = {}

    def respond(self, client_msg: bytes) -> tuple[bytes, bool, bool]:
        """-> (server_msg, done, ok).  First call handles client-first,
        second client-final."""
        if not self._state:
            text = client_msg.decode()
            if not text.startswith("n,,"):
                return b"e=channel-binding-not-supported", True, False
            bare = text[3:]
            attrs = dict(kv.split("=", 1) for kv in bare.split(","))
            user = attrs["n"].replace("=2C", ",").replace("=3D", "=")
            password = self.users.get(user)
            if password is None:
                return b"e=unknown-user", True, False
            salt = os.urandom(16)
            rnonce = attrs["r"] + base64.b64encode(os.urandom(12)).decode()
            server_first = (
                f"r={rnonce},s={base64.b64encode(salt).decode()},i={self.iterations}"
            )
            self._state = dict(
                bare=bare, rnonce=rnonce, salt=salt, server_first=server_first,
                password=password,
            )
            return server_first.encode(), False, True
        st = self._state
        attrs = dict(kv.split("=", 1) for kv in client_msg.decode().split(","))
        if attrs.get("r") != st["rnonce"]:
            return b"e=other-error", True, False
        salted = salted_password(
            self.mechanism, st["password"], st["salt"], self.iterations
        )
        client_key = _hm(self.h, salted, b"Client Key")
        stored_key = self.h(client_key).digest()
        auth_msg = (
            f"{st['bare']},{st['server_first']},c={attrs['c']},r={attrs['r']}".encode()
        )
        client_sig = _hm(self.h, stored_key, auth_msg)
        expected = _xor(client_key, client_sig)
        try:
            got = base64.b64decode(attrs["p"])
        except Exception:  # noqa: BLE001
            return b"e=invalid-proof", True, False
        if not hmac.compare_digest(expected, got):
            return b"e=invalid-proof", True, False
        server_key = _hm(self.h, salted, b"Server Key")
        server_sig = _hm(self.h, server_key, auth_msg)
        return b"v=" + base64.b64encode(server_sig), True, True
