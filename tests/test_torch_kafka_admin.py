"""The port's Kafka wire-protocol adapter (cruise_control_tpu_torch.kafka)
on the CPU: tests/test_kafka_admin.py's 19 tests pointed at the port, the
contract suite run against both SimulatedClusterAdmin and KafkaClusterAdmin
over the port's fake cluster.  The reference's notes follow.

Kafka wire-protocol adapter tests.

Three layers (reference test strategy SURVEY §4):
  1. codec golden bytes — the encoding pinned against hand-computed frames
     from the public protocol spec (not self-round-trip only);
  2. ClusterAdmin CONTRACT suite — the same assertions run against both
     SimulatedClusterAdmin and KafkaClusterAdmin-over-fake-broker-sockets
     (the embedded-harness analog, CCKafkaIntegrationTestHarness);
  3. executor end-to-end through real sockets: Executor drives
     KafkaClusterAdmin against the fake cluster and the reassignment
     completes via the live progress loop.
"""

import dataclasses

import pytest

from cruise_control_tpu_torch.executor.admin import (
    LeadershipSpec,
    ReassignmentSpec,
    SimulatedClusterAdmin,
)
from cruise_control_tpu_torch.kafka import (
    KafkaAdminClient,
    KafkaClusterAdmin,
    KafkaMetadataProvider,
)
from cruise_control_tpu_torch.kafka import codec, protocol as proto
from cruise_control_tpu_torch.monitor.topology import (
    BrokerNode,
    ClusterTopology,
    PartitionInfo,
    StaticMetadataProvider,
)
from cruise_control_tpu_torch.testing.fake_kafka import FakeKafkaCluster

# ------------------------------------------------------------------ codec


def test_uvarint_roundtrip_and_spec_values():
    for v, expect in [(0, b"\x00"), (1, b"\x01"), (127, b"\x7f"),
                      (128, b"\x80\x01"), (300, b"\xac\x02")]:
        out = bytearray()
        codec.write_uvarint(out, v)
        assert bytes(out) == expect
        got, off = codec.read_uvarint(out, 0)
        assert got == v and off == len(out)


def test_metadata_request_golden_bytes():
    """Metadata v1 request for topic "a", correlation 7, client "cc":
    hand-assembled per the public spec (classic encoding)."""
    frame = proto.encode_request(proto.METADATA, 7, "cc", {"topics": ["a"]})
    expect = (
        b"\x00\x00\x00\x13"          # length = 19
        b"\x00\x03" b"\x00\x01"      # api_key=3, version=1
        b"\x00\x00\x00\x07"          # correlation_id=7
        b"\x00\x02" b"cc"            # client_id
        b"\x00\x00\x00\x01"          # 1 topic
        b"\x00\x01" b"a"             # "a"
    )
    assert frame == expect


def test_alter_reassignments_golden_bytes():
    """AlterPartitionReassignments v0 (flexible: compact arrays + tag
    buffers + header v2)."""
    frame = proto.encode_request(
        proto.ALTER_PARTITION_REASSIGNMENTS, 1, "c",
        {"timeout_ms": 1000,
         "topics": [{"name": "t", "partitions": [
             {"partition_index": 0, "replicas": [1, 2]}]}]},
    )
    expect = (
        b"\x00\x00\x00\x24"              # length = 36
        b"\x00\x2d" b"\x00\x00"          # api_key=45, version=0
        b"\x00\x00\x00\x01"              # correlation
        b"\x00\x01" b"c"                 # client_id (classic in header v2)
        b"\x00"                          # header tag buffer
        b"\x00\x00\x03\xe8"              # timeout_ms=1000
        b"\x02"                          # compact array: 1 topic (len+1)
        b"\x02" b"t"                     # compact string "t"
        b"\x02"                          # 1 partition
        b"\x00\x00\x00\x00"              # partition_index=0
        b"\x03"                          # compact nullable array: 2 replicas
        b"\x00\x00\x00\x01" b"\x00\x00\x00\x02"
        b"\x00" b"\x00" b"\x00"          # partition/topic/request tag buffers
    )
    assert frame == expect


def test_all_schemas_roundtrip():
    """Every API's request+response schema encodes/decodes losslessly."""
    samples = {
        "ApiVersions": ({}, {"error_code": 0, "api_keys": [
            {"api_key": 3, "min_version": 0, "max_version": 9}]}),
        "CreateTopics": (
            {"topics": [{"name": "t", "num_partitions": 2,
                         "replication_factor": 1, "assignments": [],
                         "configs": [{"name": "k", "value": None}]}],
             "timeout_ms": 100},
            {"topics": [{"name": "t", "error_code": 0}]},
        ),
        "Produce": (
            {"transactional_id": None, "acks": 1, "timeout_ms": 100,
             "topic_data": [{"name": "t", "partition_data": [
                 {"index": 0, "records": b"\x01\x02"}]}]},
            {"responses": [{"name": "t", "partition_responses": [
                {"index": 0, "error_code": 0, "base_offset": 7,
                 "log_append_time_ms": -1}]}],
             "throttle_time_ms": 0},
        ),
        "Fetch": (
            {"replica_id": -1, "max_wait_ms": 0, "min_bytes": 0,
             "max_bytes": 1024, "isolation_level": 0,
             "topics": [{"topic": "t", "partitions": [
                 {"partition": 0, "fetch_offset": 3,
                  "partition_max_bytes": 1024}]}]},
            {"throttle_time_ms": 0, "responses": [{"topic": "t", "partitions": [
                {"partition_index": 0, "error_code": 0, "high_watermark": 9,
                 "last_stable_offset": 9, "aborted_transactions": None,
                 "records": b"\x00"}]}]},
        ),
        "ListOffsets": (
            {"replica_id": -1, "topics": [{"name": "t", "partitions": [
                {"partition_index": 0, "timestamp": -2}]}]},
            {"topics": [{"name": "t", "partitions": [
                {"partition_index": 0, "error_code": 0, "timestamp": -1,
                 "offset": 0}]}]},
        ),
        "Metadata": (
            {"topics": None},
            {"brokers": [{"node_id": 0, "host": "h", "port": 9092, "rack": None}],
             "controller_id": 0,
             "topics": [{"error_code": 0, "name": "t", "is_internal": False,
                         "partitions": [{"error_code": 0, "partition_index": 0,
                                         "leader_id": 0, "replica_nodes": [0, 1],
                                         "isr_nodes": [0]}]}]},
        ),
        "AlterPartitionReassignments": (
            {"timeout_ms": 1, "topics": [{"name": "t", "partitions": [
                {"partition_index": 0, "replicas": None}]}]},
            {"throttle_time_ms": 0, "error_code": 0, "error_message": None,
             "responses": [{"name": "t", "partitions": [
                 {"partition_index": 0, "error_code": 0, "error_message": "x"}]}]},
        ),
        "ListPartitionReassignments": (
            {"timeout_ms": 1, "topics": None},
            {"throttle_time_ms": 0, "error_code": 0, "error_message": None,
             "topics": [{"name": "t", "partitions": [
                 {"partition_index": 2, "replicas": [1], "adding_replicas": [],
                  "removing_replicas": [3]}]}]},
        ),
        "ElectLeaders": (
            {"election_type": 0, "topic_partitions": [
                {"topic": "t", "partition_ids": [0, 1]}], "timeout_ms": 9},
            {"throttle_time_ms": 0, "error_code": 0,
             "replica_election_results": [
                {"topic": "t", "partition_results": [
                    {"partition_id": 0, "error_code": 0, "error_message": None}]}]},
        ),
        "IncrementalAlterConfigs": (
            {"resources": [{"resource_type": 4, "resource_name": "1",
                            "configs": [{"name": "k", "config_operation": 0,
                                         "value": "v"}]}],
             "validate_only": False},
            {"throttle_time_ms": 0, "responses": [
                {"error_code": 0, "error_message": None, "resource_type": 4,
                 "resource_name": "1"}]},
        ),
        "AlterReplicaLogDirs": (
            {"dirs": [{"path": "/d", "topics": [
                {"name": "t", "partitions": [0]}]}]},
            {"throttle_time_ms": 0, "results": [
                {"topic_name": "t", "partitions": [
                    {"partition_index": 0, "error_code": 0}]}]},
        ),
        "DescribeConfigs": (
            {"resources": [{"resource_type": 4, "resource_name": "1",
                            "configuration_keys": None}]},
            {"throttle_time_ms": 0, "results": [
                {"error_code": 0, "error_message": None, "resource_type": 4,
                 "resource_name": "1", "configs": [
                     {"name": "k", "value": "v", "read_only": False,
                      "is_default": False, "is_sensitive": False}]}]},
        ),
        "DescribeLogDirs": (
            {"topics": None},
            {"throttle_time_ms": 0, "results": [
                {"error_code": 0, "log_dir": "/d", "topics": [
                    {"name": "t", "partitions": [
                        {"partition_index": 0, "partition_size": 5,
                         "offset_lag": 0, "is_future_key": False}]}]}]},
        ),
    }
    for api in proto.ALL_APIS:
        req, resp = samples[api.name]
        assert api.request.decode(api.request.encode(req)) == req, api.name
        assert api.response.decode(api.response.encode(resp)) == resp, api.name


# --------------------------------------------------------------- contract

TOPO = ClusterTopology(
    brokers=tuple(
        BrokerNode(broker_id=i, rack=f"r{i % 2}", host=f"h{i}") for i in range(3)
    ),
    partitions=(
        PartitionInfo("T0", 0, leader=0, replicas=(0, 1)),
        PartitionInfo("T0", 1, leader=1, replicas=(1, 2)),
        PartitionInfo("T1", 0, leader=2, replicas=(2, 0)),
    ),
)


class _SimHarness:
    """SimulatedClusterAdmin under the contract."""

    def __init__(self):
        self.admin = SimulatedClusterAdmin(
            StaticMetadataProvider(TOPO), link_rate_bytes_per_s=1e12
        )

    def advance(self):
        self.admin.tick(1.0)

    def throttle_active(self):
        return self.admin.throttle_rate is not None

    def close(self):
        pass


class _KafkaHarness:
    """KafkaClusterAdmin against the fake wire-protocol cluster."""

    def __init__(self):
        self.cluster = FakeKafkaCluster(
            brokers={i: {"rack": f"r{i % 2}", "logdirs": [f"/d{i}/a", f"/d{i}/b"]}
                     for i in range(3)},
            topics={
                "T0": [{"partition": 0, "leader": 0, "replicas": [0, 1]},
                       {"partition": 1, "leader": 1, "replicas": [1, 2]}],
                "T1": [{"partition": 0, "leader": 2, "replicas": [2, 0]}],
            },
        ).start()
        self.client = KafkaAdminClient(self.cluster.bootstrap(), timeout_s=5.0)
        self.admin = KafkaClusterAdmin(self.client)

    def advance(self):
        self.cluster.complete_reassignments()

    def throttle_active(self):
        return any(
            "leader.replication.throttled.rate" in cfg
            for (rt, _), cfg in self.cluster.configs.items()
            if rt == 4
        )

    def close(self):
        self.client.close()
        self.cluster.stop()


@pytest.fixture(params=["simulated", "kafka"])
def harness(request):
    h = _SimHarness() if request.param == "simulated" else _KafkaHarness()
    yield h
    h.close()


def test_contract_topology(harness):
    topo = harness.admin.topology()
    assert sorted(b.broker_id for b in topo.brokers) == [0, 1, 2]
    parts = {(p.topic, p.partition): p for p in topo.partitions}
    assert parts[("T0", 0)].replicas == (0, 1)
    assert parts[("T1", 0)].leader == 2


def test_contract_reassignment_lifecycle(harness):
    admin = harness.admin
    spec = ReassignmentSpec("T0", 0, (2, 1), data_to_move=10.0)
    admin.reassign_partitions([spec])
    assert ("T0", 0) in admin.in_progress_reassignments()
    harness.advance()
    assert ("T0", 0) not in admin.in_progress_reassignments()
    parts = {(p.topic, p.partition): p for p in admin.topology().partitions}
    assert set(parts[("T0", 0)].replicas) == {1, 2}


def test_contract_cancel(harness):
    admin = harness.admin
    admin.reassign_partitions([ReassignmentSpec("T0", 1, (0, 2), 10.0)])
    assert admin.in_progress_reassignments()
    admin.cancel_reassignments()
    assert admin.in_progress_reassignments() == set()


def test_contract_leadership(harness):
    admin = harness.admin
    # T0 p1: replicas (1, 2), leader 1.  Move leadership to 2 — NOT the
    # preferred replica, so the real-cluster adapter must reorder the
    # assignment before the preferred election (a plain election would
    # re-elect 1 and silently no-op).
    admin.elect_leaders([LeadershipSpec("T0", 1, preferred_leader=2)])
    parts = {(p.topic, p.partition): p for p in admin.topology().partitions}
    assert parts[("T0", 1)].leader == 2
    # already-leader case must be accepted as success, not an error
    admin.elect_leaders([LeadershipSpec("T0", 1, preferred_leader=2)])


def test_contract_throttle(harness):
    admin = harness.admin
    admin.set_replication_throttle(5e6, {"T0"})
    assert harness.throttle_active()
    admin.clear_replication_throttle()
    assert not harness.throttle_active()


# ------------------------------------------------- executor end to end


def test_executor_against_fake_kafka():
    """The real Executor drives KafkaClusterAdmin over live sockets; the
    reassignment completes through the actual progress-check loop."""
    h = _KafkaHarness()
    try:
        h.cluster.auto_complete_after(2)
        from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
        from cruise_control_tpu_torch.executor import ExecutionOptions, Executor

        catalog = None
        ex = Executor(h.admin, topic_names={0: "T0", 1: "T1"}, catalog=catalog)
        proposal = ExecutionProposal(
            partition=0, topic=0, old_leader=0, new_leader=2,
            old_replicas=(0, 1), new_replicas=(2, 1),
            inter_broker_data_to_move=10.0,
        )
        result = ex.execute_proposals(
            [proposal],
            ExecutionOptions(progress_check_interval_s=0.05, max_ticks=200),
        )
        assert result.completed >= 1
        assert result.dead == 0
        parts = {
            (p.topic, p.partition): p for p in h.admin.topology().partitions
        }
        assert set(parts[("T0", 0)].replicas) == {1, 2}
    finally:
        h.close()


def test_logdir_moves_against_fake_kafka():
    h = _KafkaHarness()
    try:
        # T0-0 lives on broker 0 logdir /d0/a; move it to /d0/b (index 1)
        h.admin.alter_replica_logdirs([("T0", 0, 0, 1)])
        dirs = h.client.describe_logdirs(0)
        assert ("T0", 0) in dirs["/d0/b"]["replicas"]
        assert ("T0", 0) not in dirs["/d0/a"]["replicas"]
    finally:
        h.close()


def test_throttle_clear_survives_restart():
    """A NEW admin instance (fresh process after a crash) must discover and
    clear throttles set by the old one — via DescribeConfigs, not memory."""
    h = _KafkaHarness()
    try:
        h.admin.set_replication_throttle(5e6, {"T0"})
        assert h.throttle_active()
        fresh = KafkaClusterAdmin(h.client)  # empty in-memory tracking
        fresh.clear_replication_throttle()
        assert not h.throttle_active()
        assert not any(
            cfg for (rt, _), cfg in h.cluster.configs.items() if cfg
        )
    finally:
        h.close()


def test_connection_retries_after_idle_close():
    """The first request after the broker closed an idle connection must
    transparently reconnect (brokers enforce connections.max.idle.ms)."""
    h = _KafkaHarness()
    try:
        h.admin.topology()  # opens connections
        # simulate an idle-close: kill every cached socket server-side view
        for conn in h.client._conns.values():
            if conn._sock is not None:
                conn._sock.close()  # poisoned fd; next send/recv fails
        topo = h.admin.topology()  # must succeed via reconnect
        assert len(topo.brokers) == 3
    finally:
        h.close()


def test_api_version_negotiation():
    """check_api_support passes against the fake broker (which advertises
    exactly our pinned versions) and raises clearly when an API is absent."""
    h = _KafkaHarness()
    try:
        h.client.check_api_support()  # must not raise

        # simulate an older broker missing AlterPartitionReassignments
        real = h.client.api_versions

        def degraded():
            resp = real()
            resp["api_keys"] = [
                a for a in resp["api_keys"] if a["api_key"] != 45
            ]
            return resp

        h.client.api_versions = degraded
        from cruise_control_tpu_torch.kafka import KafkaProtocolError

        with pytest.raises(KafkaProtocolError) as e:
            h.client.check_api_support()
        assert "AlterPartitionReassignments" in str(e.value)
    finally:
        h.close()


# ------------------------------------------------------------------ SASL


def _scram_cluster(users):
    return FakeKafkaCluster(
        brokers={i: {"rack": f"r{i%2}"} for i in range(3)},
        topics={
            "T0": [
                {"partition": p, "leader": p % 3, "replicas": [p % 3, (p + 1) % 3]}
                for p in range(4)
            ],
        },
        scram_users=users,
    ).start()


@pytest.mark.parametrize("mechanism", ["SCRAM-SHA-256", "SCRAM-SHA-512"])
def test_sasl_scram_authenticates_over_live_sockets(mechanism):
    """SaslHandshake + SCRAM exchange against the fake SASL-only listener;
    admin operations work only after authentication (reference gets this
    from JAAS, config/cruise_control_jaas.conf_template)."""
    from cruise_control_tpu_torch.kafka.sasl import SaslCredentials

    cluster = _scram_cluster({"alice": "s3cret"})
    client = KafkaAdminClient(
        cluster.bootstrap(), timeout_s=5.0,
        sasl=SaslCredentials("alice", "s3cret", mechanism),
    )
    try:
        topo = KafkaMetadataProvider(client).topology()
        assert sorted(b.broker_id for b in topo.brokers) == [0, 1, 2]
        # a full admin operation rides the authenticated connection
        admin = KafkaClusterAdmin(client)
        admin.reassign_partitions([ReassignmentSpec("T0", 0, (2, 1), 10.0)])
        assert ("T0", 0) in admin.in_progress_reassignments()
    finally:
        client.close()
        cluster.stop()


def test_sasl_wrong_password_rejected_and_unauthenticated_disconnected():
    from cruise_control_tpu_torch.kafka.client import KafkaProtocolError
    from cruise_control_tpu_torch.kafka.sasl import SaslCredentials

    cluster = _scram_cluster({"alice": "s3cret"})
    bad = KafkaAdminClient(
        cluster.bootstrap(), timeout_s=5.0,
        sasl=SaslCredentials("alice", "wrong"),
    )
    anon = KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    try:
        with pytest.raises(KafkaProtocolError) as e:
            bad.metadata()
        assert e.value.code == 58  # SASL_AUTHENTICATION_FAILED
        # no SASL at all: the listener hangs up
        with pytest.raises((ConnectionError, OSError)):
            anon.metadata()
    finally:
        bad.close()
        anon.close()
        cluster.stop()


def test_scram_client_rejects_forged_server_signature():
    """Mutual auth: a MITM that accepts the password but cannot produce the
    server signature must be detected (RFC 5802 v= check)."""
    from cruise_control_tpu_torch.kafka.sasl import SaslCredentials, ScramClient, ScramServer

    creds = SaslCredentials("alice", "pw")
    c = ScramClient(creds)
    s = ScramServer("SCRAM-SHA-256", {"alice": "pw"})
    server_first, done, ok = s.respond(c.first())
    assert not done and ok
    final = c.final(server_first)
    server_final, done, ok = s.respond(final)
    assert done and ok
    c.verify(server_final)  # genuine signature passes
    c2 = ScramClient(creds)
    s2 = ScramServer("SCRAM-SHA-256", {"alice": "pw"})
    first2, _, _ = s2.respond(c2.first())
    c2.final(first2)
    with pytest.raises(PermissionError):
        c2.verify(b"v=" + __import__("base64").b64encode(b"x" * 32))


def test_scram_sha256_rfc7677_test_vector():
    """Exact-bytes conformance against the published SCRAM-SHA-256 test
    vector (RFC 7677 §3) — the wire exchange must interoperate with real
    brokers, not merely with our own server half."""
    from cruise_control_tpu_torch.kafka.sasl import SaslCredentials, ScramClient

    c = ScramClient(
        SaslCredentials("user", "pencil"), nonce="rOprNGfwEbeRWgbNEkqO"
    )
    assert c.first() == b"n,,n=user,r=rOprNGfwEbeRWgbNEkqO"
    server_first = (
        b"r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
        b"s=W22ZaJ0SNY7soEsUEjb6gQ==,i=4096"
    )
    assert c.final(server_first) == (
        b"c=biws,r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
        b"p=dHzbZapWIk4jUhN+Ute9ytag9zjfMHgsqmmiz7AndVQ="
    )
    c.verify(b"v=6rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4=")  # no raise


def test_intra_broker_copy_tracked_over_wire():
    """Executor + KafkaClusterAdmin against fake brokers with GRADUAL
    logdir copies: the task stays in flight while DescribeLogDirs reports
    a future replica, completes once the copy lands on the target dir,
    and the landed dir is verifiable (reference ExecutorAdminUtils)."""
    from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
    from cruise_control_tpu_torch.executor.executor import ExecutionOptions, Executor

    cluster = FakeKafkaCluster(
        brokers={i: {"rack": f"r{i % 2}", "logdirs": [f"/d{i}/a", f"/d{i}/b"]}
                 for i in range(3)},
        topics={
            "T0": [{"partition": 0, "leader": 0, "replicas": [0, 1]}],
        },
    ).start()
    try:
        cluster.intra_copy_polls = 2
        client = KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
        admin = KafkaClusterAdmin(client)
        prop = ExecutionProposal(
            topic=0, partition=0, old_leader=0, new_leader=0,
            old_replicas=(0, 1), new_replicas=(0, 1),
            disk_moves=((0, 0, 1),),  # broker 0: /d0/a -> /d0/b
            intra_broker_data_to_move=512.0,
        )
        ex = Executor(admin, topic_names={0: "T0"})
        res = ex.execute_proposals(
            [prop], ExecutionOptions(progress_check_interval_s=0.05)
        )
        assert res.completed == 1 and res.dead == 0
        # the replica physically lives on the target dir now
        assert ("T0", 0) in cluster.placement[0]["/d0/b"]
        assert ("T0", 0) not in cluster.placement[0]["/d0/a"]
        assert admin.logdir_of("T0", 0, 0) == 1
        assert admin.in_progress_logdir_moves() == set()
    finally:
        cluster.stop()
