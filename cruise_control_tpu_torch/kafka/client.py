"""Blocking Kafka admin client over raw sockets with controller routing.

Reference roles covered: common/MetadataClient.java:1 (metadata refresh),
executor/ExecutorAdminUtils.java:1 (admin operations).  One connection per
broker, lazily opened; controller-only APIs (reassignments, elections,
configs) are routed to the current controller and retried once after a
metadata refresh if the controller moved (NOT_CONTROLLER).
"""

from __future__ import annotations

import socket
import struct
import threading

from cruise_control_tpu_torch.kafka import protocol as proto

#: Kafka error codes we interpret (public protocol spec)
NONE = 0
NOT_CONTROLLER = 41
NO_REASSIGNMENT_IN_PROGRESS = 85


class KafkaProtocolError(Exception):
    def __init__(self, api: str, code: int, message: str | None = None):
        super().__init__(f"{api}: error_code={code} {message or ''}".strip())
        self.api = api
        self.code = code


class BrokerConnection:
    """One socket to one broker; request/response are strictly serial."""

    def __init__(
        self, host: str, port: int, client_id: str, timeout_s: float, sasl=None
    ):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.timeout_s = timeout_s
        #: optional SaslCredentials — every (re)connected socket
        #: authenticates before it carries any other request
        self.sasl = sasl
        self._sock: socket.socket | None = None
        self._correlation = 0
        self._lock = threading.Lock()

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s
            )
            if self.sasl is not None:
                try:
                    self._authenticate(sock)
                except BaseException:
                    sock.close()
                    raise
            self._sock = sock
        return self._sock

    def _raw_request(self, sock: socket.socket, api: proto.Api, body: dict) -> dict:
        """One framed request on an explicit socket — used during SASL
        setup, before the connection is available to request()."""
        self._correlation += 1
        cid = self._correlation
        sock.sendall(proto.encode_request(api, cid, self.client_id, body))
        (size,) = struct.unpack(">i", self._read_exact(sock, 4))
        got_cid, resp = proto.decode_response(api, self._read_exact(sock, size))
        if got_cid != cid:
            raise ConnectionError(f"correlation mismatch: sent {cid}, got {got_cid}")
        return resp

    def _authenticate(self, sock: socket.socket) -> None:
        """SaslHandshake + SaslAuthenticate exchange (KIP-152 framing)."""
        from cruise_control_tpu_torch.kafka.sasl import ScramClient

        creds = self.sasl
        hs = self._raw_request(sock, proto.SASL_HANDSHAKE, {"mechanism": creds.mechanism})
        if hs["error_code"] != NONE:
            raise KafkaProtocolError(
                "SaslHandshake", hs["error_code"],
                f"mechanism {creds.mechanism} rejected; broker offers "
                f"{hs.get('mechanisms')}",
            )

        def auth_round(payload: bytes) -> bytes:
            resp = self._raw_request(
                sock, proto.SASL_AUTHENTICATE, {"auth_bytes": payload}
            )
            if resp["error_code"] != NONE:
                raise KafkaProtocolError(
                    "SaslAuthenticate", resp["error_code"], resp.get("error_message")
                )
            return resp["auth_bytes"]

        if creds.mechanism == "PLAIN":
            auth_round(f"\0{creds.username}\0{creds.password}".encode())
            return
        scram = ScramClient(creds)
        server_first = auth_round(scram.first())
        server_final = auth_round(scram.final(server_first))
        scram.verify(server_final)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _read_exact(self, sock: socket.socket, n: int) -> bytes:
        chunks = []
        while n:
            chunk = sock.recv(n)
            if not chunk:
                raise ConnectionError("broker closed connection")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def request(self, api: proto.Api, body: dict) -> dict:
        """One retry on a fresh socket: brokers close idle connections
        (connections.max.idle.ms), so the first call after an idle window
        hits a dead cached socket — reconnect once, then surface errors.

        Only idempotent APIs retry: an ambiguous failure (e.g. timeout after
        the request was written) may mean the broker already executed it,
        and re-sending a Produce would append duplicate records."""
        with self._lock:
            last_error: Exception | None = None
            attempts = 2 if api.idempotent else 1
            for attempt in range(attempts):
                self._correlation += 1
                cid = self._correlation
                frame = proto.encode_request(api, cid, self.client_id, body)
                try:
                    sock = self._ensure()
                    sock.sendall(frame)
                    (size,) = struct.unpack(">i", self._read_exact(sock, 4))
                    payload = self._read_exact(sock, size)
                except (OSError, ConnectionError) as e:
                    self.close()  # poisoned stream; retry on a fresh socket
                    last_error = e
                    continue
                got_cid, resp = proto.decode_response(api, payload)
                if got_cid != cid:
                    self.close()
                    raise ConnectionError(
                        f"correlation mismatch: sent {cid}, got {got_cid}"
                    )
                return resp
            raise last_error  # type: ignore[misc]


class KafkaAdminClient:
    """Cluster-level operations with broker/controller routing."""

    def __init__(
        self,
        bootstrap: list[tuple[str, int]],
        *,
        client_id: str = "cruise-control-tpu",
        timeout_s: float = 30.0,
        sasl=None,
    ):
        if not bootstrap:
            raise ValueError("bootstrap servers required")
        self.bootstrap = bootstrap
        self.client_id = client_id
        self.timeout_s = timeout_s
        #: optional kafka.sasl.SaslCredentials applied to every connection
        self.sasl = sasl
        self._conns: dict[tuple[str, int], BrokerConnection] = {}
        self._brokers: dict[int, tuple[str, int]] = {}  # node_id -> addr
        self._controller_id: int | None = None
        # routing maps are shared by detector/executor/REST threads; per-
        # connection locks serialize frames but not these dicts
        self._route_lock = threading.Lock()

    # ------------------------------------------------------------- plumbing

    def _conn(self, addr: tuple[str, int]) -> BrokerConnection:
        with self._route_lock:
            conn = self._conns.get(addr)
            if conn is None:
                conn = BrokerConnection(
                    addr[0], addr[1], self.client_id, self.timeout_s, sasl=self.sasl
                )
                self._conns[addr] = conn
            return conn

    def close(self) -> None:
        with self._route_lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()

    def _any_conn(self) -> BrokerConnection:
        errors = []
        with self._route_lock:
            known = list(self._brokers.values())
        for node_addr in known + self.bootstrap:
            try:
                conn = self._conn(node_addr)
                conn._ensure()
                return conn
            except OSError as e:  # try the next seed
                errors.append(f"{node_addr}: {e}")
        raise ConnectionError("no reachable broker: " + "; ".join(errors))

    # ------------------------------------------------------------ metadata

    def metadata(self, topics: list[str] | None = None) -> dict:
        resp = self._any_conn().request(proto.METADATA, {"topics": topics})
        with self._route_lock:
            self._brokers = {
                b["node_id"]: (b["host"], b["port"]) for b in resp["brokers"]
            }
            self._controller_id = resp["controller_id"]
        return resp

    def api_versions(self) -> dict:
        return self._any_conn().request(proto.API_VERSIONS, {})

    def check_api_support(self) -> None:
        """Verify the broker supports every (api, version) this client pins
        (one fixed version per API — see protocol.py).  Raises with the
        full unsupported list, which beats per-operation decode failures
        against an old broker."""
        resp = self.api_versions()
        if resp["error_code"] != NONE:
            raise KafkaProtocolError("ApiVersions", resp["error_code"])
        ranges = {
            a["api_key"]: (a["min_version"], a["max_version"])
            for a in resp["api_keys"] or []
        }
        missing = []
        for api in proto.ALL_APIS:
            lo_hi = ranges.get(api.key)
            if lo_hi is None or not (lo_hi[0] <= api.version <= lo_hi[1]):
                missing.append(f"{api.name} v{api.version} (broker has {lo_hi})")
        if missing:
            raise KafkaProtocolError(
                "ApiVersions", 35,  # UNSUPPORTED_VERSION
                "broker lacks required APIs: " + ", ".join(missing),
            )

    def _controller_conn(self) -> BrokerConnection:
        with self._route_lock:
            cid = self._controller_id
            addr = self._brokers.get(cid) if cid is not None else None
        if addr is None:
            self.metadata()
            with self._route_lock:
                addr = self._brokers.get(self._controller_id)
        if addr is None:
            raise ConnectionError("no controller in metadata")
        return self._conn(addr)

    def _controller_request(self, api: proto.Api, body: dict) -> dict:
        """Route to controller; one retry after refresh on NOT_CONTROLLER."""
        resp = self._controller_conn().request(api, body)
        if resp.get("error_code", NONE) == NOT_CONTROLLER:
            self.metadata()
            resp = self._controller_conn().request(api, body)
        return resp

    def broker_request(self, node_id: int, api: proto.Api, body: dict) -> dict:
        with self._route_lock:
            addr = self._brokers.get(node_id)
        if addr is None:
            self.metadata()
            with self._route_lock:
                addr = self._brokers.get(node_id)
        if addr is None:
            raise ConnectionError(f"unknown broker {node_id}")
        return self._conn(addr).request(api, body)

    # ----------------------------------------------------------- operations

    def alter_partition_reassignments(
        self, assignments: dict[tuple[str, int], list[int] | None],
        timeout_ms: int = 60_000,
    ) -> list[tuple[str, int, int, str | None]]:
        """assignments: (topic, partition) -> target replicas (None cancels).
        Returns per-partition (topic, partition, error_code, message)."""
        by_topic: dict[str, list[dict]] = {}
        for (topic, part), replicas in assignments.items():
            by_topic.setdefault(topic, []).append(
                {"partition_index": part, "replicas": replicas}
            )
        resp = self._controller_request(proto.ALTER_PARTITION_REASSIGNMENTS, {
            "timeout_ms": timeout_ms,
            "topics": [
                {"name": t, "partitions": ps} for t, ps in sorted(by_topic.items())
            ],
        })
        if resp["error_code"] != NONE:
            raise KafkaProtocolError(
                "AlterPartitionReassignments", resp["error_code"],
                resp.get("error_message"),
            )
        out = []
        for t in resp["responses"] or []:
            for p in t["partitions"] or []:
                out.append(
                    (t["name"], p["partition_index"], p["error_code"],
                     p.get("error_message"))
                )
        return out

    def list_partition_reassignments(self) -> set[tuple[str, int]]:
        resp = self._controller_request(proto.LIST_PARTITION_REASSIGNMENTS, {
            "timeout_ms": 30_000, "topics": None,
        })
        if resp["error_code"] not in (NONE, NO_REASSIGNMENT_IN_PROGRESS):
            raise KafkaProtocolError(
                "ListPartitionReassignments", resp["error_code"],
                resp.get("error_message"),
            )
        return {
            (t["name"], p["partition_index"])
            for t in resp["topics"] or []
            for p in t["partitions"] or []
        }

    def elect_preferred_leaders(
        self, partitions: list[tuple[str, int]], timeout_ms: int = 30_000
    ) -> list[tuple[str, int, int]]:
        by_topic: dict[str, list[int]] = {}
        for topic, part in partitions:
            by_topic.setdefault(topic, []).append(part)
        resp = self._controller_request(proto.ELECT_LEADERS, {
            "election_type": 0,  # PREFERRED
            "topic_partitions": [
                {"topic": t, "partition_ids": ps}
                for t, ps in sorted(by_topic.items())
            ],
            "timeout_ms": timeout_ms,
        })
        if resp["error_code"] != NONE:
            raise KafkaProtocolError("ElectLeaders", resp["error_code"])
        return [
            (t["topic"], p["partition_id"], p["error_code"])
            for t in resp["replica_election_results"] or []
            for p in t["partition_results"] or []
        ]

    def incremental_alter_configs(
        self, resources: list[tuple[int, str, list[tuple[str, int, str | None]]]],
    ) -> None:
        """resources: (resource_type, name, [(config, op, value)])."""
        resp = self._any_conn().request(proto.INCREMENTAL_ALTER_CONFIGS, {
            "resources": [
                {
                    "resource_type": rt, "resource_name": name,
                    "configs": [
                        {"name": c, "config_operation": op, "value": v}
                        for c, op, v in configs
                    ],
                }
                for rt, name, configs in resources
            ],
            "validate_only": False,
        })
        for r in resp["responses"] or []:
            if r["error_code"] != NONE:
                raise KafkaProtocolError(
                    "IncrementalAlterConfigs", r["error_code"], r.get("error_message")
                )

    def create_topics(
        self, topics: list[tuple[str, int, int]], timeout_ms: int = 30_000
    ) -> dict[str, int]:
        """[(name, num_partitions, replication_factor)] -> name: error_code.
        36 = TOPIC_ALREADY_EXISTS (callers usually treat it as success)."""
        resp = self._controller_request(proto.CREATE_TOPICS, {
            "topics": [
                {"name": n, "num_partitions": p, "replication_factor": rf,
                 "assignments": [], "configs": []}
                for n, p, rf in topics
            ],
            "timeout_ms": timeout_ms,
        })
        return {t["name"]: t["error_code"] for t in resp["topics"] or []}

    def describe_configs(
        self, resources: list[tuple[int, str]], names: list[str] | None = None,
        *, node_id: int | None = None,
    ) -> dict[tuple[int, str], dict[str, str]]:
        """(resource_type, name) -> {config: value} for non-default configs
        (value None and defaults are omitted).  `node_id` routes the request
        to a specific broker — required for BROKER resources (KIP-226)."""
        body = {
            "resources": [
                {"resource_type": rt, "resource_name": rn,
                 "configuration_keys": names}
                for rt, rn in resources
            ],
        }
        if node_id is not None:
            resp = self.broker_request(node_id, proto.DESCRIBE_CONFIGS, body)
        else:
            resp = self._any_conn().request(proto.DESCRIBE_CONFIGS, body)
        out: dict[tuple[int, str], dict[str, str]] = {}
        for r in resp["results"] or []:
            if r["error_code"] != NONE:
                continue
            out[(r["resource_type"], r["resource_name"])] = {
                c["name"]: c["value"]
                for c in r["configs"] or []
                if c["value"] is not None and not c["is_default"]
            }
        return out

    def alter_replica_logdirs(
        self, node_id: int, moves: dict[str, list[tuple[str, int]]]
    ) -> list[tuple[str, int, int]]:
        """moves: logdir path -> [(topic, partition)] on ONE broker."""
        dirs = []
        for path, tps in sorted(moves.items()):
            by_topic: dict[str, list[int]] = {}
            for topic, part in tps:
                by_topic.setdefault(topic, []).append(part)
            dirs.append({
                "path": path,
                "topics": [
                    {"name": t, "partitions": ps}
                    for t, ps in sorted(by_topic.items())
                ],
            })
        resp = self.broker_request(node_id, proto.ALTER_REPLICA_LOG_DIRS, {"dirs": dirs})
        return [
            (t["topic_name"], p["partition_index"], p["error_code"])
            for t in resp["results"] or []
            for p in t["partitions"] or []
        ]

    def describe_logdirs(self, node_id: int) -> dict[str, dict]:
        """node's logdirs: path -> {"error_code", "replicas": {(t, p): size},
        "future_replicas": {(t, p)}}.

        future_replicas are in-flight AlterReplicaLogDirs targets
        (is_future_key=true): the partition is still copying into this dir
        (reference ExecutorAdminUtils polls these to track intra-broker
        move completion)."""
        resp = self.broker_request(node_id, proto.DESCRIBE_LOG_DIRS, {"topics": None})
        out: dict[str, dict] = {}
        for r in resp["results"] or []:
            replicas = {}
            future = set()
            for t in r["topics"] or []:
                for p in t["partitions"] or []:
                    key = (t["name"], p["partition_index"])
                    if p.get("is_future_key"):
                        future.add(key)
                    else:
                        replicas[key] = p["partition_size"]
            out[r["log_dir"]] = {
                "error_code": r["error_code"],
                "replicas": replicas,
                "future_replicas": future,
            }
        return out
