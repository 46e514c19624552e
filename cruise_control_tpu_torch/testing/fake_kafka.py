"""In-process fake Kafka cluster speaking the real wire protocol.

The analog of the reference's embedded-cluster test harness
(CCEmbeddedBroker/CCKafkaIntegrationTestHarness,
cruise-control-metrics-reporter/src/test/java/.../utils/): contract tests
drive the production `KafkaClusterAdmin` through REAL sockets and REAL
binary frames against this server, so the codec, framing, routing, and
adapter logic are all exercised end to end without a JVM.

One listening socket per fake broker node (each on its own ephemeral port
and its broker's loopback host — the client routes per-broker requests
like DescribeLogDirs by address); all listeners share one cluster state,
and one selector thread serves every listener and connection (a thread a
connection, as the reference's fake runs, comes to thousands of threads at
a north-star width, more than some hosts allow).  Reassignments park in an
in-progress set until `complete_reassignments()` — mirroring
SimulatedClusterAdmin.tick so both backends satisfy the same contract
suite; `auto_complete_after(n)` finishes them after n list polls to
exercise the executor's progress loop.
"""

from __future__ import annotations

import logging
import selectors
import socket
import struct
import threading

from cruise_control_tpu_torch.kafka import protocol as proto
from cruise_control_tpu_torch.kafka.client import NO_REASSIGNMENT_IN_PROGRESS

log = logging.getLogger(__name__)


class FakeKafkaCluster:
    def __init__(
        self,
        brokers: dict[int, dict],
        topics: dict[str, list[dict]],
        *,
        controller: int | None = None,
        scram_users: dict[str, str] | None = None,
    ):
        """brokers: id -> {"rack": str, "logdirs": [path, ...], "host": str};
        "host", a loopback address (127.0.0.1 by default), is where the
        broker's listener binds and what Metadata reports for it, so brokers
        can share a host or each have one of their own.
        topics: name -> [{"partition", "leader", "replicas"}]
        scram_users: username -> password; when set, every connection must
        complete a SaslHandshake + SCRAM exchange before any other API
        (a SASL-only listener, like a secured real cluster)."""
        self._lock = threading.RLock()
        self.controller = controller if controller is not None else min(brokers)
        self.brokers: dict[int, dict] = {}
        self.topics = {
            t: {p["partition"]: dict(p) for p in parts} for t, parts in topics.items()
        }
        #: (topic, partition) -> target replica list
        self.reassignments: dict[tuple[str, int], list[int]] = {}
        #: (resource_type, name) -> {config: value}
        self.configs: dict[tuple[int, str], dict[str, str]] = {}
        #: logdir placement: broker -> path -> set[(topic, partition)]
        self.placement: dict[int, dict[str, set]] = {}
        #: >0 makes AlterReplicaLogDirs copies GRADUAL: the replica shows as
        #: a future replica under the target dir for this many
        #: DescribeLogDirs polls before the move applies (models
        #: KIP-113 async logdir copies)
        self.intra_copy_polls = 0
        #: broker -> {(topic, partition): [target path, polls left]}
        self.future_replicas: dict[int, dict[tuple[str, int], list]] = {}
        self._auto_complete_after: int | None = None
        self._list_polls = 0
        #: reassignments frozen by stall_reassignment: they stay listed as
        #: in-progress but complete_reassignments skips them (a wedged
        #: follower that never catches up — stuck-move reaper fodder)
        self.stalled: set[tuple[str, int]] = set()
        #: data plane: (topic, partition) -> [batch bytes]; offsets assigned
        #: at append like a real log
        self.logs: dict[tuple[str, int], list[bytes]] = {}
        self.log_end: dict[tuple[str, int], int] = {}
        self.scram_users = scram_users or {}
        #: brokers crashed via kill_broker (absent from metadata)
        self._dead: set[int] = set()
        #: requests served, by API name (counted in `handle`)
        self.requests: dict[str, int] = {}
        self._server: _Server | None = None
        first: dict[int, set] = {}
        for bid, spec in sorted(brokers.items()):
            self.brokers[bid] = {"rack": spec.get("rack", ""), "port": None,
                                 "host": spec.get("host", "127.0.0.1")}
            dirs = spec.get("logdirs") or ["/data/d0"]
            self.placement[bid] = {d: set() for d in dirs}
            first[bid] = self.placement[bid][dirs[0]]
        # every replica starts on its broker's first logdir: one pass over
        # the partitions, each added to its replicas' brokers in the
        # (topic, partition) order a pass per broker would add them, so
        # every set is built by the same insertions
        for t, parts in self.topics.items():
            for p in parts.values():
                key = (t, p["partition"])
                for b in p["replicas"]:
                    members = first.get(b)
                    if members is not None:
                        members.add(key)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "FakeKafkaCluster":
        server = _Server(self)
        for bid in self.brokers:
            self.brokers[bid]["port"] = server.listen(bid, self.brokers[bid]["host"])
        server.start()
        self._server = server
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None

    def bootstrap(self) -> list[tuple[str, int]]:
        first = self.brokers[min(self.brokers)]
        return [(first["host"], first["port"])]

    # ------------------------------------------------------- test control

    def complete_reassignments(self) -> list[tuple[str, int]]:
        """Apply every parked reassignment (the SimulatedClusterAdmin.tick
        analog)."""
        with self._lock:
            done = []
            for (t, pidx), replicas in list(self.reassignments.items()):
                if (t, pidx) in self.stalled:
                    continue
                part = self.topics[t][pidx]
                old = part["replicas"]
                part["replicas"] = list(replicas)
                if part["leader"] not in replicas:
                    part["leader"] = replicas[0]
                # move physical placement for brokers that gained the replica
                for b in set(replicas) - set(old):
                    dirs = self.placement.get(b)
                    if dirs:
                        next(iter(dirs.values())).add((t, pidx))
                for b in set(old) - set(replicas):
                    for members in self.placement.get(b, {}).values():
                        members.discard((t, pidx))
                del self.reassignments[(t, pidx)]
                done.append((t, pidx))
            return done

    def auto_complete_after(self, polls: int) -> None:
        """Finish reassignments after `polls` ListPartitionReassignments
        calls — drives the executor's real progress-check loop."""
        self._auto_complete_after = polls
        self._list_polls = 0

    def stall_reassignment(self, topic: str, partition: int) -> None:
        """Freeze one reassignment: it stays in-progress (listed by
        ListPartitionReassignments) but never completes until unstalled —
        the wedged-move shape the executor's reaper exists for."""
        with self._lock:
            self.stalled.add((topic, partition))

    def unstall_reassignment(self, topic: str, partition: int) -> None:
        with self._lock:
            self.stalled.discard((topic, partition))

    def kill_broker(self, broker_id: int) -> None:
        """Chaos: crash one broker — its listener closes (connections die),
        it vanishes from Metadata responses, and partitions it led fail
        over to their first surviving replica (the controller's ISR
        election).  Its replica assignments REMAIN in the partition lists,
        which is exactly the referenced-but-absent signal the
        BrokerFailureDetector reads (kafka/admin.py topology derivation;
        reference BrokerFailureDetector.java:88 ZK watch analog)."""
        if broker_id == self.controller:
            raise ValueError("refusing to kill the controller in this fake")
        with self._lock:
            self._dead.add(broker_id)
            for parts in self.topics.values():
                for p in parts.values():
                    if p["leader"] == broker_id:
                        alive = [
                            b for b in p["replicas"]
                            if b != broker_id and b not in self._dead
                        ]
                        p["leader"] = alive[0] if alive else -1
        if self._server is not None:
            self._server.close_listener(broker_id)

    # ------------------------------------------------------ request logic

    def handle(self, node_id: int, api: proto.Api, body: dict) -> dict:
        with self._lock:
            self.requests[api.name] = self.requests.get(api.name, 0) + 1
            return getattr(self, f"_h_{api.name}")(node_id, body)

    def _h_ApiVersions(self, node, body):  # noqa: N802
        return {
            "error_code": 0,
            "api_keys": [
                {"api_key": a.key, "min_version": a.version, "max_version": a.version}
                for a in proto.ALL_APIS
            ],
        }

    def _h_Metadata(self, node, body):  # noqa: N802
        names = body["topics"]
        topics = self.topics if names is None else {
            t: self.topics[t] for t in names if t in self.topics
        }
        return {
            "brokers": [
                {"node_id": b, "host": info["host"], "port": info["port"],
                 "rack": info["rack"] or None}
                for b, info in sorted(self.brokers.items())
                if b not in self._dead
            ],
            "controller_id": self.controller,
            "topics": [
                {
                    "error_code": 0, "name": t, "is_internal": False,
                    "partitions": [
                        {
                            "error_code": 0, "partition_index": pidx,
                            "leader_id": p["leader"],
                            "replica_nodes": list(p["replicas"]),
                            "isr_nodes": list(p["replicas"]),
                        }
                        for pidx, p in sorted(parts.items())
                    ],
                }
                for t, parts in sorted(topics.items())
            ],
        }

    def _not_controller(self, api: proto.Api) -> dict | None:
        return None  # single-controller fake; routing correctness is covered
        # by the client retry test using `controller` reassignment

    def _h_AlterPartitionReassignments(self, node, body):  # noqa: N802
        responses = []
        for t in body["topics"] or []:
            parts = []
            for p in t["partitions"] or []:
                key = (t["name"], p["partition_index"])
                code, msg = 0, None
                if t["name"] not in self.topics or key[1] not in self.topics[t["name"]]:
                    code, msg = 3, "UNKNOWN_TOPIC_OR_PARTITION"
                elif p["replicas"] is None:
                    if key in self.reassignments:
                        del self.reassignments[key]
                    else:
                        code, msg = NO_REASSIGNMENT_IN_PROGRESS, "none in progress"
                elif set(p["replicas"]) == set(self.topics[t["name"]][key[1]]["replicas"]):
                    # pure reorder: every target replica is already in ISR, so
                    # real Kafka completes it immediately (no data movement)
                    self.topics[t["name"]][key[1]]["replicas"] = list(p["replicas"])
                else:
                    self.reassignments[key] = list(p["replicas"])
                parts.append(
                    {"partition_index": key[1], "error_code": code,
                     "error_message": msg}
                )
            responses.append({"name": t["name"], "partitions": parts})
        return {
            "throttle_time_ms": 0, "error_code": 0, "error_message": None,
            "responses": responses,
        }

    def _h_ListPartitionReassignments(self, node, body):  # noqa: N802
        self._list_polls += 1
        if (
            self._auto_complete_after is not None
            and self._list_polls >= self._auto_complete_after
        ):
            self.complete_reassignments()
        by_topic: dict[str, list[dict]] = {}
        for (t, pidx), target in sorted(self.reassignments.items()):
            current = self.topics[t][pidx]["replicas"]
            by_topic.setdefault(t, []).append({
                "partition_index": pidx,
                "replicas": sorted(set(current) | set(target)),
                "adding_replicas": sorted(set(target) - set(current)),
                "removing_replicas": sorted(set(current) - set(target)),
            })
        return {
            "throttle_time_ms": 0, "error_code": 0, "error_message": None,
            "topics": [
                {"name": t, "partitions": ps} for t, ps in sorted(by_topic.items())
            ],
        }

    def _h_ElectLeaders(self, node, body):  # noqa: N802
        results = []
        for t in body["topic_partitions"] or []:
            parts = []
            for pidx in t["partition_ids"] or []:
                part = self.topics.get(t["topic"], {}).get(pidx)
                if part is None:
                    parts.append({"partition_id": pidx, "error_code": 3,
                                  "error_message": "unknown"})
                    continue
                part["leader"] = part["replicas"][0]  # preferred election
                parts.append({"partition_id": pidx, "error_code": 0,
                              "error_message": None})
            results.append({"topic": t["topic"], "partition_results": parts})
        return {"throttle_time_ms": 0, "error_code": 0,
                "replica_election_results": results}

    def _h_IncrementalAlterConfigs(self, node, body):  # noqa: N802
        responses = []
        for r in body["resources"] or []:
            store = self.configs.setdefault((r["resource_type"], r["resource_name"]), {})
            for c in r["configs"] or []:
                if c["config_operation"] == 0:  # SET
                    store[c["name"]] = c["value"]
                else:  # DELETE
                    store.pop(c["name"], None)
            responses.append({
                "error_code": 0, "error_message": None,
                "resource_type": r["resource_type"],
                "resource_name": r["resource_name"],
            })
        return {"throttle_time_ms": 0, "responses": responses}

    def _h_CreateTopics(self, node, body):  # noqa: N802
        out = []
        ids = sorted(self.brokers)
        for t in body["topics"] or []:
            if t["name"] in self.topics:
                out.append({"name": t["name"], "error_code": 36})  # EXISTS
                continue
            n = max(1, t["num_partitions"])
            rf = max(1, min(t["replication_factor"], len(ids)))
            self.topics[t["name"]] = {
                p: {
                    "partition": p,
                    "leader": ids[p % len(ids)],
                    "replicas": [ids[(p + r) % len(ids)] for r in range(rf)],
                }
                for p in range(n)
            }
            out.append({"name": t["name"], "error_code": 0})
        return {"topics": out}

    def _h_Produce(self, node, body):  # noqa: N802
        responses = []
        for t in body["topic_data"] or []:
            name = t["name"]
            if name not in self.topics:
                # reporter auto-creates its topic
                # (CruiseControlMetricsReporter topic bootstrap)
                self.topics[name] = {
                    0: {"partition": 0, "leader": node, "replicas": [node]}
                }
            parts = []
            for pd in t["partition_data"] or []:
                key = (name, pd["index"])
                part = self.topics[name].get(pd["index"])
                code = 0
                base = -1
                if part is None:
                    code = 3  # UNKNOWN_TOPIC_OR_PARTITION
                elif part["leader"] != node:
                    code = 6  # NOT_LEADER_OR_FOLLOWER
                elif pd["records"]:
                    batch = bytearray(pd["records"])
                    base = self.log_end.get(key, 0)
                    struct.pack_into(">q", batch, 0, base)  # assign offsets
                    (count,) = struct.unpack_from(">i", batch, 57)
                    self.logs.setdefault(key, []).append(bytes(batch))
                    self.log_end[key] = base + count
                parts.append({
                    "index": pd["index"], "error_code": code,
                    "base_offset": base, "log_append_time_ms": -1,
                })
            responses.append({"name": name, "partition_responses": parts})
        return {"responses": responses, "throttle_time_ms": 0}

    def _h_Fetch(self, node, body):  # noqa: N802
        responses = []
        for t in body["topics"] or []:
            parts = []
            for p in t["partitions"] or []:
                key = (t["topic"], p["partition"])
                end = self.log_end.get(key, 0)
                part = self.topics.get(t["topic"], {}).get(p["partition"])
                code = 0
                data = b""
                if part is None:
                    code = 3
                elif part["leader"] != node:
                    code = 6
                else:
                    want = p["fetch_offset"]
                    chunks = []
                    for batch in self.logs.get(key, []):
                        (base,) = struct.unpack_from(">q", batch, 0)
                        (count,) = struct.unpack_from(">i", batch, 57)
                        if base + count > want:
                            chunks.append(batch)
                    data = b"".join(chunks)
                parts.append({
                    "partition_index": p["partition"], "error_code": code,
                    "high_watermark": end, "last_stable_offset": end,
                    "aborted_transactions": None,
                    "records": data,
                })
            responses.append({"topic": t["topic"], "partitions": parts})
        return {"throttle_time_ms": 0, "responses": responses}

    def _h_ListOffsets(self, node, body):  # noqa: N802
        topics = []
        for t in body["topics"] or []:
            parts = []
            for p in t["partitions"] or []:
                key = (t["name"], p["partition_index"])
                if p["timestamp"] == -2:  # earliest
                    off = 0
                else:  # latest
                    off = self.log_end.get(key, 0)
                parts.append({
                    "partition_index": p["partition_index"], "error_code": 0,
                    "timestamp": -1, "offset": off,
                })
            topics.append({"name": t["name"], "partitions": parts})
        return {"topics": topics}

    def _h_DescribeConfigs(self, node, body):  # noqa: N802
        results = []
        for r in body["resources"] or []:
            store = self.configs.get((r["resource_type"], r["resource_name"]), {})
            wanted = r["configuration_keys"]
            results.append({
                "error_code": 0, "error_message": None,
                "resource_type": r["resource_type"],
                "resource_name": r["resource_name"],
                "configs": [
                    {"name": k, "value": v, "read_only": False,
                     "is_default": False, "is_sensitive": False}
                    for k, v in sorted(store.items())
                    if wanted is None or k in wanted
                ],
            })
        return {"throttle_time_ms": 0, "results": results}

    def _h_AlterReplicaLogDirs(self, node, body):  # noqa: N802
        results: dict[str, list[dict]] = {}
        dirs = self.placement[node]
        for d in body["dirs"] or []:
            path = d["path"]
            for t in d["topics"] or []:
                for pidx in t["partitions"] or []:
                    code = 0
                    if path not in dirs:
                        code = 57  # LOG_DIR_NOT_FOUND
                    elif self.intra_copy_polls > 0:
                        # async copy: future replica until polled down
                        self.future_replicas.setdefault(node, {})[
                            (t["name"], pidx)
                        ] = [path, self.intra_copy_polls]
                    else:
                        for members in dirs.values():
                            members.discard((t["name"], pidx))
                        dirs[path].add((t["name"], pidx))
                    results.setdefault(t["name"], []).append(
                        {"partition_index": pidx, "error_code": code}
                    )
        return {
            "throttle_time_ms": 0,
            "results": [
                {"topic_name": t, "partitions": ps} for t, ps in sorted(results.items())
            ],
        }

    def _h_DescribeLogDirs(self, node, body):  # noqa: N802
        futures = self.future_replicas.get(node, {})
        results = []
        for path, members in sorted(self.placement[node].items()):
            topics: dict[str, list[dict]] = {}
            for t, pidx in sorted(members):
                topics.setdefault(t, []).append(
                    {"partition_index": pidx, "partition_size": 1024,
                     "offset_lag": 0, "is_future_key": False}
                )
            for (t, pidx), (target, _polls) in sorted(futures.items()):
                if target == path:
                    topics.setdefault(t, []).append(
                        {"partition_index": pidx, "partition_size": 512,
                         "offset_lag": 512, "is_future_key": True}
                    )
            results.append({
                "error_code": 0, "log_dir": path,
                "topics": [
                    {"name": t, "partitions": ps} for t, ps in sorted(topics.items())
                ],
            })
        # advance the copies AFTER reporting: each poll is progress; a copy
        # that reaches 0 lands on its target dir
        for key, entry in list(futures.items()):
            entry[1] -= 1
            if entry[1] <= 0:
                for members in self.placement[node].values():
                    members.discard(key)
                self.placement[node][entry[0]].add(key)
                del futures[key]
        return {"throttle_time_ms": 0, "results": results}


class _Connection:
    """One accepted connection: its broker, the bytes read and not yet
    framed, and its SASL state."""

    def __init__(self, sock: socket.socket, node_id: int, sasl_required: bool):
        self.sock = sock
        self.node_id = node_id
        self.buf = bytearray()
        self.scram = None
        self.authenticated = not sasl_required


class _Server(threading.Thread):
    """Every fake broker's listener and connections on one selector loop.

    A readable listener accepts; a readable connection is read, and each
    complete frame in it is answered in order (a client's requests on one
    connection are strictly serial).  Responses go out with a blocking
    send: the client waits for each one."""

    def __init__(self, cluster: FakeKafkaCluster):
        super().__init__(daemon=True, name="fake-kafka")
        self.cluster = cluster
        self._sel = selectors.DefaultSelector()
        self._listeners: dict[int, socket.socket] = {}
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._stopping = threading.Event()

    def listen(self, node_id: int, host: str) -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, 0))
        sock.listen(64)
        self._listeners[node_id] = sock
        self._sel.register(sock, selectors.EVENT_READ, node_id)
        return sock.getsockname()[1]

    def close_listener(self, node_id: int) -> None:
        """A killed broker's listener closes: new connections are refused,
        open ones stay served, as in the reference's fake."""
        sock = self._listeners.pop(node_id, None)
        if sock is not None:
            self._sel.unregister(sock)
            sock.close()

    def stop(self) -> None:
        self._stopping.set()
        self._wake_w.send(b"x")
        self.join()

    def run(self) -> None:
        try:
            while not self._stopping.is_set():
                for key, _ in self._sel.select():
                    if key.data is None:
                        self._wake_r.recv(64)
                    elif isinstance(key.data, _Connection):
                        self._read(key.data)
                    else:
                        self._accept(key.fileobj, key.data)
        finally:
            for key in list(self._sel.get_map().values()):
                key.fileobj.close()
            self._sel.close()
            self._wake_w.close()
            self._listeners.clear()

    def _accept(self, sock: socket.socket, node_id: int) -> None:
        try:
            conn, _ = sock.accept()
        except OSError:
            return
        conn.setblocking(True)
        self._sel.register(conn, selectors.EVENT_READ,
                           _Connection(conn, node_id, bool(self.cluster.scram_users)))

    def _close(self, c: _Connection) -> None:
        self._sel.unregister(c.sock)
        c.sock.close()

    def _read(self, c: _Connection) -> None:
        try:
            chunk = c.sock.recv(1 << 20)
        except OSError:
            chunk = b""
        if not chunk:
            self._close(c)
            return
        c.buf += chunk
        while len(c.buf) >= 4:
            (size,) = struct.unpack_from(">i", c.buf)
            if len(c.buf) < 4 + size:
                return
            payload = bytes(c.buf[4: 4 + size])
            del c.buf[: 4 + size]
            try:
                out, close = self._answer(c, payload)
                if out is not None:
                    c.sock.sendall(out)
            except OSError:
                close = True
            except Exception:  # noqa: BLE001 — a broken request ends its connection only
                log.exception("fake broker %d: request failed", c.node_id)
                close = True
            if close:
                self._close(c)
                return

    def _answer(self, c: _Connection, payload: bytes) -> tuple[bytes | None, bool]:
        """The framed response to one request and whether the connection
        closes after it.  A per-connection SASL gate (only when the cluster
        has scram users): handshake -> scram rounds -> authenticated;
        anything else first closes the connection, like a real SASL
        listener."""
        api, cid, _client, body = proto.decode_request(payload)
        if api.name == "SaslHandshake":
            from cruise_control_tpu_torch.kafka.sasl import _HASHES, ScramServer

            mech = body["mechanism"]
            if mech in _HASHES:
                c.scram = ScramServer(mech, self.cluster.scram_users)
                resp = {"error_code": 0, "mechanisms": sorted(_HASHES)}
            else:
                resp = {
                    "error_code": 33,  # UNSUPPORTED_SASL_MECHANISM
                    "mechanisms": sorted(_HASHES),
                }
        elif api.name == "SaslAuthenticate":
            if c.scram is None:
                resp = {"error_code": 47, "error_message": "handshake first",
                        "auth_bytes": b""}  # ILLEGAL_SASL_STATE
            else:
                msg, done, ok = c.scram.respond(body["auth_bytes"])
                if done and not ok:
                    resp = {
                        "error_code": 58,  # SASL_AUTHENTICATION_FAILED
                        "error_message": msg.decode(),
                        "auth_bytes": b"",
                    }
                    return proto.encode_response(api, cid, resp), True
                c.authenticated = c.authenticated or (done and ok)
                resp = {"error_code": 0, "error_message": None, "auth_bytes": msg}
        elif not c.authenticated:
            # a real SASL listener disconnects on pre-auth requests
            return None, True
        else:
            resp = self.cluster.handle(c.node_id, api, body)
        return proto.encode_response(api, cid, resp), False
