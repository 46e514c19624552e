"""The port's wire codec (cruise_control_tpu_torch.kafka.{protocol,records,
sasl}) against golden bytes: tests/test_protocol_golden.py's 25 tests
pointed at the port.  The reference's notes follow.

Spec-pinned golden-byte conformance for EVERY wire API we speak.

Round-4 VERDICT: only 2 of 15 APIs had spec-derived golden bytes;
everything else was verified against testing/fake_kafka.py, which shares
an author with the client — circular.  This file removes the circularity:

  * an INDEPENDENT mini-encoder (`i16`/`s`/`arr`/`cs`/... below), written
    directly from the public protocol spec (kafka.apache.org/protocol),
    assembles every request/response frame field by field — it shares no
    code with cruise_control_tpu_torch.kafka.codec;
  * each API in protocol.ALL_APIS + SASL_APIS is pinned in all four
    directions: encode_request, decode_request, encode_response,
    decode_response against those hand-assembled bytes;
  * record-batch v2 bytes are assembled from the spec layout with the CRC
    computed by a second, bit-at-a-time CRC-32C implementation anchored to
    the published check value crc32c("123456789") = 0xE3069283;
  * the SCRAM-SHA-256 exchange replays the RFC 7677 §3 test vector
    (published client/server messages for user "user" / password
    "pencil"), not a self-generated conversation.

No fake_kafka involvement anywhere in this file.

Reference parity: the reference inherits wire correctness from the
official kafka-clients jar (build.gradle dependency;
executor/ExecutorAdminUtils.java:1) and embedded-broker integration tests
(CCKafkaIntegrationTestHarness.java:17); these goldens play that
conformance role for our self-built client.
"""

import struct

import pytest

from cruise_control_tpu_torch.kafka import protocol as proto
from cruise_control_tpu_torch.kafka import records
from cruise_control_tpu_torch.kafka.sasl import SaslCredentials, ScramClient

# --------------------------------------------------------------------------
# independent spec primitives (deliberately NOT cruise_control_tpu_torch.kafka.codec)
# --------------------------------------------------------------------------


def i8(v):
    return struct.pack(">b", v)


def i16(v):
    return struct.pack(">h", v)


def i32(v):
    return struct.pack(">i", v)


def i64(v):
    return struct.pack(">q", v)


def u32(v):
    return struct.pack(">I", v)


def boolean(v):
    return b"\x01" if v else b"\x00"


def s(v):
    """Classic STRING / NULLABLE_STRING: INT16 length (-1 = null)."""
    if v is None:
        return i16(-1)
    return i16(len(v)) + v.encode()


def by(v):
    """Classic BYTES / NULLABLE_BYTES: INT32 length (-1 = null)."""
    if v is None:
        return i32(-1)
    return i32(len(v)) + v


def arr(items):
    """Classic ARRAY: INT32 count (-1 = null); items are pre-encoded bytes."""
    if items is None:
        return i32(-1)
    return i32(len(items)) + b"".join(items)


def uvarint(v):
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def cs(v):
    """COMPACT_STRING / COMPACT_NULLABLE_STRING: uvarint len+1 (0 = null)."""
    if v is None:
        return uvarint(0)
    return uvarint(len(v.encode()) + 1) + v.encode()


def carr(items):
    """COMPACT_ARRAY: uvarint count+1 (0 = null); items pre-encoded."""
    if items is None:
        return uvarint(0)
    return uvarint(len(items) + 1) + b"".join(items)


TAGS = uvarint(0)  # empty tagged-field buffer

CID = 7
CLIENT = "cc"


def req_header(api):
    """Request header: v1 for classic APIs, v2 (+tag buffer) for flexible
    (KIP-482).  client_id stays a classic nullable string in BOTH."""
    h = i16(api.key) + i16(api.version) + i32(CID) + s(CLIENT)
    return h + TAGS if api.flexible else h


def resp_header(api):
    """Response header: v0 classic, v1 (+tag buffer) flexible."""
    h = i32(CID)
    return h + TAGS if api.flexible else h


def frame(payload):
    return i32(len(payload)) + payload


def check(api, req_body, req_bytes, resp_body, resp_bytes):
    """Pin all four codec directions of one API against spec bytes."""
    req_payload = req_header(api) + req_bytes
    resp_payload = resp_header(api) + resp_bytes
    # client -> broker
    assert proto.encode_request(api, CID, CLIENT, req_body) == frame(req_payload), (
        f"{api.name} v{api.version} request encoding diverges from spec bytes"
    )
    # broker side parse (exercised by real brokers against our frames)
    got_api, got_cid, got_client, got_body = proto.decode_request(req_payload)
    assert (got_api, got_cid, got_client) == (api, CID, CLIENT)
    assert got_body == req_body
    # broker -> client
    assert proto.encode_response(api, CID, resp_body) == frame(resp_payload), (
        f"{api.name} v{api.version} response encoding diverges from spec bytes"
    )
    got_cid, got_body = proto.decode_response(api, resp_payload)
    assert got_cid == CID
    assert got_body == resp_body


# --------------------------------------------------------------------------
# one golden per API — request and response, hand-assembled per the spec
# --------------------------------------------------------------------------


def test_produce_v3():
    check(
        proto.PRODUCE,
        {"transactional_id": None, "acks": -1, "timeout_ms": 30000,
         "topic_data": [{"name": "t", "partition_data": [
             {"index": 0, "records": b"RB"}]}]},
        s(None) + i16(-1) + i32(30000)
        + arr([s("t") + arr([i32(0) + by(b"RB")])]),
        {"responses": [{"name": "t", "partition_responses": [
            {"index": 0, "error_code": 0, "base_offset": 5,
             "log_append_time_ms": -1}]}],
         "throttle_time_ms": 0},
        arr([s("t") + arr([i32(0) + i16(0) + i64(5) + i64(-1)])]) + i32(0),
    )


def test_fetch_v4():
    check(
        proto.FETCH,
        {"replica_id": -1, "max_wait_ms": 500, "min_bytes": 1,
         "max_bytes": 1048576, "isolation_level": 0,
         "topics": [{"topic": "t", "partitions": [
             {"partition": 0, "fetch_offset": 3, "partition_max_bytes": 65536}]}]},
        i32(-1) + i32(500) + i32(1) + i32(1048576) + i8(0)
        + arr([s("t") + arr([i32(0) + i64(3) + i32(65536)])]),
        {"throttle_time_ms": 0, "responses": [{"topic": "t", "partitions": [
            {"partition_index": 0, "error_code": 0, "high_watermark": 10,
             "last_stable_offset": 10, "aborted_transactions": None,
             "records": b"RB"}]}]},
        i32(0) + arr([s("t") + arr([
            i32(0) + i16(0) + i64(10) + i64(10) + arr(None) + by(b"RB")])]),
    )


def test_list_offsets_v1():
    check(
        proto.LIST_OFFSETS,
        {"replica_id": -1, "topics": [{"name": "t", "partitions": [
            {"partition_index": 0, "timestamp": -1}]}]},
        i32(-1) + arr([s("t") + arr([i32(0) + i64(-1)])]),
        {"topics": [{"name": "t", "partitions": [
            {"partition_index": 0, "error_code": 0, "timestamp": 123,
             "offset": 42}]}]},
        arr([s("t") + arr([i32(0) + i16(0) + i64(123) + i64(42)])]),
    )


def test_create_topics_v0():
    check(
        proto.CREATE_TOPICS,
        {"topics": [{"name": "t", "num_partitions": 2,
                     "replication_factor": 1,
                     "assignments": [{"partition_index": 0, "broker_ids": [0, 1]}],
                     "configs": [{"name": "k", "value": None}]}],
         "timeout_ms": 100},
        arr([s("t") + i32(2) + i16(1)
             + arr([i32(0) + arr([i32(0), i32(1)])])
             + arr([s("k") + s(None)])])
        + i32(100),
        {"topics": [{"name": "t", "error_code": 36}]},
        arr([s("t") + i16(36)]),
    )


def test_api_versions_v0():
    check(
        proto.API_VERSIONS,
        {},
        b"",
        {"error_code": 0, "api_keys": [
            {"api_key": 3, "min_version": 0, "max_version": 9}]},
        i16(0) + arr([i16(3) + i16(0) + i16(9)]),
    )


def test_metadata_v1():
    check(
        proto.METADATA,
        {"topics": ["a"]},
        arr([s("a")]),
        {"brokers": [{"node_id": 0, "host": "h", "port": 9092, "rack": None}],
         "controller_id": 0,
         "topics": [{"error_code": 0, "name": "a", "is_internal": False,
                     "partitions": [{"error_code": 0, "partition_index": 0,
                                     "leader_id": 0, "replica_nodes": [0, 1],
                                     "isr_nodes": [0]}]}]},
        arr([i32(0) + s("h") + i32(9092) + s(None)]) + i32(0)
        + arr([i16(0) + s("a") + boolean(False)
               + arr([i16(0) + i32(0) + i32(0)
                      + arr([i32(0), i32(1)]) + arr([i32(0)])])]),
    )


def test_metadata_v1_all_topics_null_array():
    """topics=null -> fetch-all (the monitor's refreshMetadata path)."""
    assert proto.encode_request(proto.METADATA, CID, CLIENT, {"topics": None}) == frame(
        req_header(proto.METADATA) + arr(None)
    )


def test_alter_partition_reassignments_v0_flexible():
    check(
        proto.ALTER_PARTITION_REASSIGNMENTS,
        {"timeout_ms": 1000, "topics": [{"name": "t", "partitions": [
            {"partition_index": 0, "replicas": [1, 2]}]}]},
        i32(1000)
        + carr([cs("t") + carr([i32(0) + carr([i32(1), i32(2)]) + TAGS]) + TAGS])
        + TAGS,
        {"throttle_time_ms": 0, "error_code": 0, "error_message": None,
         "responses": [{"name": "t", "partitions": [
             {"partition_index": 0, "error_code": 0, "error_message": None}]}]},
        i32(0) + i16(0) + cs(None)
        + carr([cs("t") + carr([i32(0) + i16(0) + cs(None) + TAGS]) + TAGS])
        + TAGS,
    )


def test_alter_partition_reassignments_v0_cancel_null_replicas():
    """replicas=null cancels an in-progress reassignment (KIP-455) — the
    executor's force-stop path; null inside a COMPACT_NULLABLE_ARRAY is the
    single byte 0x00."""
    body = {"timeout_ms": 1000, "topics": [{"name": "t", "partitions": [
        {"partition_index": 3, "replicas": None}]}]}
    expect = (
        i32(1000)
        + carr([cs("t") + carr([i32(3) + uvarint(0) + TAGS]) + TAGS])
        + TAGS
    )
    assert proto.encode_request(
        proto.ALTER_PARTITION_REASSIGNMENTS, CID, CLIENT, body
    ) == frame(req_header(proto.ALTER_PARTITION_REASSIGNMENTS) + expect)


def test_list_partition_reassignments_v0_flexible():
    check(
        proto.LIST_PARTITION_REASSIGNMENTS,
        {"timeout_ms": 1000, "topics": None},
        i32(1000) + uvarint(0) + TAGS,
        {"throttle_time_ms": 0, "error_code": 0, "error_message": None,
         "topics": [{"name": "t", "partitions": [
             {"partition_index": 0, "replicas": [1, 2],
              "adding_replicas": [2], "removing_replicas": []}]}]},
        i32(0) + i16(0) + cs(None)
        + carr([cs("t") + carr([
            i32(0) + carr([i32(1), i32(2)]) + carr([i32(2)]) + carr([]) + TAGS
        ]) + TAGS])
        + TAGS,
    )


def test_elect_leaders_v1():
    check(
        proto.ELECT_LEADERS,
        {"election_type": 0, "topic_partitions": [
            {"topic": "t", "partition_ids": [0, 1]}],
         "timeout_ms": 1000},
        i8(0) + arr([s("t") + arr([i32(0), i32(1)])]) + i32(1000),
        {"throttle_time_ms": 0, "error_code": 0,
         "replica_election_results": [{"topic": "t", "partition_results": [
             {"partition_id": 0, "error_code": 0, "error_message": None}]}]},
        i32(0) + i16(0) + arr([s("t") + arr([i32(0) + i16(0) + s(None)])]),
    )


def test_incremental_alter_configs_v0():
    check(
        proto.INCREMENTAL_ALTER_CONFIGS,
        {"resources": [{"resource_type": 2, "resource_name": "t",
                        "configs": [{"name": "k", "config_operation": 0,
                                     "value": "v"}]}],
         "validate_only": False},
        arr([i8(2) + s("t") + arr([s("k") + i8(0) + s("v")])]) + boolean(False),
        {"throttle_time_ms": 0, "responses": [
            {"error_code": 0, "error_message": None, "resource_type": 2,
             "resource_name": "t"}]},
        i32(0) + arr([i16(0) + s(None) + i8(2) + s("t")]),
    )


def test_describe_configs_v0():
    check(
        proto.DESCRIBE_CONFIGS,
        {"resources": [{"resource_type": 4, "resource_name": "1",
                        "configuration_keys": None}]},
        arr([i8(4) + s("1") + arr(None)]),
        {"throttle_time_ms": 0, "results": [
            {"error_code": 0, "error_message": None, "resource_type": 4,
             "resource_name": "1",
             "configs": [{"name": "k", "value": "v", "read_only": False,
                          "is_default": True, "is_sensitive": False}]}]},
        i32(0) + arr([i16(0) + s(None) + i8(4) + s("1")
                      + arr([s("k") + s("v") + boolean(False) + boolean(True)
                             + boolean(False)])]),
    )


def test_alter_replica_log_dirs_v1():
    check(
        proto.ALTER_REPLICA_LOG_DIRS,
        {"dirs": [{"path": "/d", "topics": [{"name": "t", "partitions": [0]}]}]},
        arr([s("/d") + arr([s("t") + arr([i32(0)])])]),
        {"throttle_time_ms": 0, "results": [
            {"topic_name": "t", "partitions": [
                {"partition_index": 0, "error_code": 0}]}]},
        i32(0) + arr([s("t") + arr([i32(0) + i16(0)])]),
    )


def test_describe_log_dirs_v0():
    check(
        proto.DESCRIBE_LOG_DIRS,
        {"topics": None},
        arr(None),
        {"throttle_time_ms": 0, "results": [
            {"error_code": 0, "log_dir": "/d", "topics": [
                {"name": "t", "partitions": [
                    {"partition_index": 0, "partition_size": 100,
                     "offset_lag": 0, "is_future_key": False}]}]}]},
        i32(0) + arr([i16(0) + s("/d")
                      + arr([s("t") + arr([i32(0) + i64(100) + i64(0)
                                           + boolean(False)])])]),
    )


def test_sasl_handshake_v1():
    check(
        proto.SASL_HANDSHAKE,
        {"mechanism": "SCRAM-SHA-256"},
        s("SCRAM-SHA-256"),
        {"error_code": 0, "mechanisms": ["SCRAM-SHA-256", "SCRAM-SHA-512"]},
        i16(0) + arr([s("SCRAM-SHA-256"), s("SCRAM-SHA-512")]),
    )


def test_sasl_authenticate_v0():
    check(
        proto.SASL_AUTHENTICATE,
        {"auth_bytes": b"n,,n=user,r=abc"},
        by(b"n,,n=user,r=abc"),
        {"error_code": 0, "error_message": None, "auth_bytes": b"sf"},
        i16(0) + s(None) + by(b"sf"),
    )


def test_every_api_has_a_golden():
    """The checks above must cover protocol.ALL_APIS + SASL_APIS exactly —
    adding an API without pinning its bytes fails here."""
    covered = {
        "Produce", "Fetch", "ListOffsets", "CreateTopics", "ApiVersions",
        "Metadata", "AlterPartitionReassignments", "ListPartitionReassignments",
        "ElectLeaders", "IncrementalAlterConfigs", "DescribeConfigs",
        "AlterReplicaLogDirs", "DescribeLogDirs", "SaslHandshake",
        "SaslAuthenticate",
    }
    assert {a.name for a in proto.ALL_APIS + proto.SASL_APIS} == covered


def test_tagged_field_forward_compat():
    """A response carrying an unknown tagged field (a newer broker) must be
    skipped per KIP-482, not corrupt the decode."""
    tagged = uvarint(1) + uvarint(0) + uvarint(3) + b"xyz"  # 1 field, tag 0, 3 bytes
    payload = (
        i32(CID) + tagged  # response header v1 with an unknown tagged field
        + i32(0) + i16(0) + cs(None) + carr([]) + TAGS
    )
    cid, body = proto.decode_response(proto.ALTER_PARTITION_REASSIGNMENTS, payload)
    assert cid == CID
    assert body == {"throttle_time_ms": 0, "error_code": 0,
                    "error_message": None, "responses": []}


# --------------------------------------------------------------------------
# record batch v2 — spec layout, CRC anchored to the published check value
# --------------------------------------------------------------------------


def _crc32c_ref(data: bytes) -> int:
    """Independent bit-at-a-time CRC-32C (reflected, poly 0x1EDC6F41 →
    reversed 0x82F63B78) — no shared code with kafka.records."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def test_crc32c_published_check_value():
    """CRC-32C("123456789") = 0xE3069283 (RFC 3720 appendix / iSCSI check
    value) — anchors BOTH implementations to the published constant."""
    assert _crc32c_ref(b"123456789") == 0xE3069283
    assert records.crc32c(b"123456789") == 0xE3069283


def zigzag(v):
    # (v << 1) ^ (v >> 63) is non-negative for any int in two's complement
    return uvarint((v << 1) ^ (v >> 63))


def test_record_batch_v2_golden_bytes():
    """One record (key b"k", value b"v") at baseOffset 0, timestamp 1234:
    every field hand-assembled per the spec's RecordBatch layout."""
    rec = (
        b"\x00"        # record attributes
        + zigzag(0)    # timestampDelta
        + zigzag(0)    # offsetDelta
        + zigzag(1) + b"k"
        + zigzag(1) + b"v"
        + zigzag(0)    # headers
    )
    body = zigzag(len(rec)) + rec
    post = (
        i16(0)         # attributes: no compression
        + i32(0)       # lastOffsetDelta
        + i64(1234)    # baseTimestamp
        + i64(1234)    # maxTimestamp
        + i64(-1) + i16(-1) + i32(-1)  # producerId/Epoch, baseSequence
        + i32(1)       # record count
        + body
    )
    batch_len = 4 + 1 + 4 + len(post)  # leaderEpoch + magic + crc + post
    expect = (
        i64(0)                       # baseOffset
        + i32(batch_len)
        + i32(-1)                    # partitionLeaderEpoch
        + b"\x02"                    # magic
        + u32(_crc32c_ref(post))     # CRC-32C over the post-crc section
        + post
    )
    got = records.encode_batch([(b"k", b"v")], base_timestamp_ms=1234)
    assert got == expect

    decoded = records.decode_batches(expect)
    assert len(decoded) == 1
    assert decoded[0] == records.Record(offset=0, timestamp_ms=1234,
                                        key=b"k", value=b"v")


def test_record_batch_crc_rejects_corruption():
    batch = bytearray(records.encode_batch([(None, b"payload")]))
    batch[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        records.decode_batches(bytes(batch))


def test_record_batch_null_key_and_multi_record_offsets():
    """Null key encodes as zigzag(-1) = 0x01; offsetDeltas increment."""
    got = records.encode_batch([(None, b"a"), (None, b"bc")])
    decoded = records.decode_batches(got)
    assert [r.offset for r in decoded] == [0, 1]
    assert all(r.key is None for r in decoded)
    # pin the null-key byte inside the first record: length, attrs, tsDelta,
    # offsetDelta, THEN keyLen -1 -> 0x01
    post = got[21:]
    first_rec_off = 40 + len(zigzag(6))  # fixed header + record-length varint
    assert post[first_rec_off + 3] == 0x01  # keyLen: zigzag(-1)


# --------------------------------------------------------------------------
# SCRAM-SHA-256 — RFC 7677 §3 published test vector
# --------------------------------------------------------------------------

RFC7677_CLIENT_NONCE = "rOprNGfwEbeRWgbNEkqO"
RFC7677_SERVER_FIRST = (
    b"r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
    b"s=W22ZaJ0SNY7soEsUEjb6gQ==,i=4096"
)


def test_scram_sha256_rfc7677_vector():
    """Replays the RFC 7677 example conversation (user "user", password
    "pencil") byte-for-byte — client-first, client-final with the published
    proof, and verification of the published server signature."""
    client = ScramClient(
        SaslCredentials("user", "pencil", "SCRAM-SHA-256"),
        nonce=RFC7677_CLIENT_NONCE,
    )
    assert client.first() == b"n,,n=user,r=rOprNGfwEbeRWgbNEkqO"
    final = client.final(RFC7677_SERVER_FIRST)
    assert final == (
        b"c=biws,r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
        b"p=dHzbZapWIk4jUhN+Ute9ytag9zjfMHgsqmmiz7AndVQ="
    )
    # mutual auth: the published server-final signature must verify...
    client.verify(b"v=6rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4=")
    # ...and a tampered one must not
    with pytest.raises(PermissionError):
        client.verify(b"v=AAAATRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4=")


def test_scram_username_escaping_rfc5802():
    """'=' and ',' in usernames must be sent as =3D / =2C (RFC 5802 §5.1)."""
    client = ScramClient(
        SaslCredentials("u=s,er", "pw", "SCRAM-SHA-256"), nonce="abc"
    )
    assert client.first() == b"n,,n=u=3Ds=2Cer,r=abc"
