"""Request/response schemas for the Kafka APIs the executor stack needs.

Transcribed from the public protocol spec (kafka.apache.org/protocol).
One version per API, chosen as the lowest version that carries what we
need (classic encoding where possible; AlterPartitionReassignments /
ListPartitionReassignments are flexible-only, KIP-455):

  API                              key  ver  encoding  role
  ApiVersions                       18    0  classic   handshake sanity
  Metadata                           3    1  classic   topology + controller
  AlterPartitionReassignments       45    0  flexible  inter-broker moves
  ListPartitionReassignments        46    0  flexible  in-progress poll
  ElectLeaders                      43    1  classic   leadership moves
  IncrementalAlterConfigs           44    0  classic   replication throttles
  AlterReplicaLogDirs               34    1  classic   intra-broker moves
  DescribeLogDirs                   35    0  classic   logdir discovery

Reference parity: ExecutorUtils.scala:31 (reassignments; the znode bridge
is replaced by KIP-455 AlterPartitionReassignments), :95 (preferred-leader
election -> ElectLeaders), ExecutorAdminUtils.java:1 (alterReplicaLogDirs /
describeLogDirs / electLeaders via AdminClient),
ReplicationThrottleHelper.java:32 (throttle configs).
"""

from __future__ import annotations

import dataclasses

from cruise_control_tpu_torch.kafka.codec import (
    Array,
    Boolean,
    CompactArray,
    CompactNullableString,
    CompactString,
    Int8,
    Int16,
    Int32,
    Int64,
    Bytes,
    NullableBytes,
    NullableString,
    String,
    Struct,
    TagBuffer,
)


@dataclasses.dataclass(frozen=True)
class Api:
    name: str
    key: int
    version: int
    flexible: bool
    request: Struct
    response: Struct
    #: safe to re-send after an ambiguous connection failure (the broker may
    #: have executed the first attempt); Produce is NOT — duplicated batches
    #: are silent double-counted metrics
    idempotent: bool = True


# -------------------------------------------------------------- ApiVersions

API_VERSIONS = Api(
    "ApiVersions", 18, 0, False,
    request=Struct(),
    response=Struct(
        ("error_code", Int16),
        ("api_keys", Array(Struct(
            ("api_key", Int16), ("min_version", Int16), ("max_version", Int16),
        ))),
    ),
)

# ----------------------------------------------------------------- Metadata

METADATA = Api(
    "Metadata", 3, 1, False,
    request=Struct(
        ("topics", Array(String, nullable=True)),  # null -> all topics
    ),
    response=Struct(
        ("brokers", Array(Struct(
            ("node_id", Int32), ("host", String), ("port", Int32),
            ("rack", NullableString),
        ))),
        ("controller_id", Int32),
        ("topics", Array(Struct(
            ("error_code", Int16), ("name", String), ("is_internal", Boolean),
            ("partitions", Array(Struct(
                ("error_code", Int16), ("partition_index", Int32),
                ("leader_id", Int32),
                ("replica_nodes", Array(Int32)),
                ("isr_nodes", Array(Int32)),
            ))),
        ))),
    ),
)

# -------------------------------------------------------------- CreateTopics

#: used for the sample-store + reporter topics (reference auto-creates its
#: topics: CruiseControlMetricsReporter topic bootstrap, KafkaSampleStore
#: ensureTopicsCreated)
CREATE_TOPICS = Api(
    "CreateTopics", 19, 0, False,
    request=Struct(
        ("topics", Array(Struct(
            ("name", String),
            ("num_partitions", Int32),
            ("replication_factor", Int16),
            ("assignments", Array(Struct(
                ("partition_index", Int32),
                ("broker_ids", Array(Int32)),
            ))),
            ("configs", Array(Struct(
                ("name", String),
                ("value", NullableString),
            ))),
        ))),
        ("timeout_ms", Int32),
    ),
    response=Struct(
        ("topics", Array(Struct(
            ("name", String),
            ("error_code", Int16),
        ))),
    ),
)

# ---------------------------------------- AlterPartitionReassignments (KIP-455)

ALTER_PARTITION_REASSIGNMENTS = Api(
    "AlterPartitionReassignments", 45, 0, True,
    request=Struct(
        ("timeout_ms", Int32),
        ("topics", CompactArray(Struct(
            ("name", CompactString),
            ("partitions", CompactArray(Struct(
                ("partition_index", Int32),
                # null replicas = cancel the in-progress reassignment
                ("replicas", CompactArray(Int32, nullable=True)),
                ("_tags", TagBuffer),
            ))),
            ("_tags", TagBuffer),
        ))),
        ("_tags", TagBuffer),
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("error_code", Int16),
        ("error_message", CompactNullableString),
        ("responses", CompactArray(Struct(
            ("name", CompactString),
            ("partitions", CompactArray(Struct(
                ("partition_index", Int32),
                ("error_code", Int16),
                ("error_message", CompactNullableString),
                ("_tags", TagBuffer),
            ))),
            ("_tags", TagBuffer),
        ))),
        ("_tags", TagBuffer),
    ),
)

LIST_PARTITION_REASSIGNMENTS = Api(
    "ListPartitionReassignments", 46, 0, True,
    request=Struct(
        ("timeout_ms", Int32),
        ("topics", CompactArray(Struct(
            ("name", CompactString),
            ("partition_indexes", CompactArray(Int32)),
            ("_tags", TagBuffer),
        ), nullable=True)),  # null -> every in-progress reassignment
        ("_tags", TagBuffer),
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("error_code", Int16),
        ("error_message", CompactNullableString),
        ("topics", CompactArray(Struct(
            ("name", CompactString),
            ("partitions", CompactArray(Struct(
                ("partition_index", Int32),
                ("replicas", CompactArray(Int32)),
                ("adding_replicas", CompactArray(Int32)),
                ("removing_replicas", CompactArray(Int32)),
                ("_tags", TagBuffer),
            ))),
            ("_tags", TagBuffer),
        ))),
        ("_tags", TagBuffer),
    ),
)

# ------------------------------------------------------------- ElectLeaders

#: election_type 0 = PREFERRED (KIP-460)
ELECT_LEADERS = Api(
    "ElectLeaders", 43, 1, False,
    request=Struct(
        ("election_type", Int8),
        ("topic_partitions", Array(Struct(
            ("topic", String),
            ("partition_ids", Array(Int32)),
        ), nullable=True)),
        ("timeout_ms", Int32),
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("error_code", Int16),  # top-level error added in v1 (protocol spec)
        ("replica_election_results", Array(Struct(
            ("topic", String),
            ("partition_results", Array(Struct(
                ("partition_id", Int32),
                ("error_code", Int16),
                ("error_message", NullableString),
            ))),
        ))),
    ),
)

# -------------------------------------------------- IncrementalAlterConfigs

#: resource_type 2 = TOPIC, 4 = BROKER; op 0 = SET, 1 = DELETE (KIP-339)
INCREMENTAL_ALTER_CONFIGS = Api(
    "IncrementalAlterConfigs", 44, 0, False,
    request=Struct(
        ("resources", Array(Struct(
            ("resource_type", Int8),
            ("resource_name", String),
            ("configs", Array(Struct(
                ("name", String),
                ("config_operation", Int8),
                ("value", NullableString),
            ))),
        ))),
        ("validate_only", Boolean),
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("responses", Array(Struct(
            ("error_code", Int16),
            ("error_message", NullableString),
            ("resource_type", Int8),
            ("resource_name", String),
        ))),
    ),
)

# ------------------------------------------------------------ Produce/Fetch

#: data-plane APIs for the reporter topic + sample-store topics (reference
#: CruiseControlMetricsReporter producer, KafkaSampleStore.java:117-128,
#: CruiseControlMetricsReporterSampler.java:101 consumer poll loop)
PRODUCE = Api(
    "Produce", 0, 3, False, idempotent=False,
    request=Struct(
        ("transactional_id", NullableString),
        ("acks", Int16),
        ("timeout_ms", Int32),
        ("topic_data", Array(Struct(
            ("name", String),
            ("partition_data", Array(Struct(
                ("index", Int32),
                ("records", NullableBytes),  # one v2 record batch
            ))),
        ))),
    ),
    response=Struct(
        ("responses", Array(Struct(
            ("name", String),
            ("partition_responses", Array(Struct(
                ("index", Int32),
                ("error_code", Int16),
                ("base_offset", Int64),
                ("log_append_time_ms", Int64),
            ))),
        ))),
        ("throttle_time_ms", Int32),
    ),
)

FETCH = Api(
    "Fetch", 1, 4, False,
    request=Struct(
        ("replica_id", Int32),  # -1 = consumer
        ("max_wait_ms", Int32),
        ("min_bytes", Int32),
        ("max_bytes", Int32),
        ("isolation_level", Int8),
        ("topics", Array(Struct(
            ("topic", String),
            ("partitions", Array(Struct(
                ("partition", Int32),
                ("fetch_offset", Int64),
                ("partition_max_bytes", Int32),
            ))),
        ))),
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("responses", Array(Struct(
            ("topic", String),
            ("partitions", Array(Struct(
                ("partition_index", Int32),
                ("error_code", Int16),
                ("high_watermark", Int64),
                ("last_stable_offset", Int64),
                ("aborted_transactions", Array(Struct(
                    ("producer_id", Int64), ("first_offset", Int64),
                ), nullable=True)),
                ("records", NullableBytes),
            ))),
        ))),
    ),
)

LIST_OFFSETS = Api(
    "ListOffsets", 2, 1, False,
    request=Struct(
        ("replica_id", Int32),
        ("topics", Array(Struct(
            ("name", String),
            ("partitions", Array(Struct(
                ("partition_index", Int32),
                ("timestamp", Int64),  # -1 latest, -2 earliest
            ))),
        ))),
    ),
    response=Struct(
        ("topics", Array(Struct(
            ("name", String),
            ("partitions", Array(Struct(
                ("partition_index", Int32),
                ("error_code", Int16),
                ("timestamp", Int64),
                ("offset", Int64),
            ))),
        ))),
    ),
)

# ----------------------------------------------------------- DescribeConfigs

DESCRIBE_CONFIGS = Api(
    "DescribeConfigs", 32, 0, False,
    request=Struct(
        ("resources", Array(Struct(
            ("resource_type", Int8),
            ("resource_name", String),
            ("configuration_keys", Array(String, nullable=True)),
        ))),
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("results", Array(Struct(
            ("error_code", Int16),
            ("error_message", NullableString),
            ("resource_type", Int8),
            ("resource_name", String),
            ("configs", Array(Struct(
                ("name", String),
                ("value", NullableString),
                ("read_only", Boolean),
                ("is_default", Boolean),
                ("is_sensitive", Boolean),
            ))),
        ))),
    ),
)

# ------------------------------------------------------ AlterReplicaLogDirs

ALTER_REPLICA_LOG_DIRS = Api(
    "AlterReplicaLogDirs", 34, 1, False,
    request=Struct(
        ("dirs", Array(Struct(
            ("path", String),
            ("topics", Array(Struct(
                ("name", String),
                ("partitions", Array(Int32)),
            ))),
        ))),
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("results", Array(Struct(
            ("topic_name", String),
            ("partitions", Array(Struct(
                ("partition_index", Int32),
                ("error_code", Int16),
            ))),
        ))),
    ),
)

DESCRIBE_LOG_DIRS = Api(
    "DescribeLogDirs", 35, 0, False,
    request=Struct(
        ("topics", Array(Struct(
            ("topic", String),
            ("partitions", Array(Int32)),
        ), nullable=True)),  # null -> all
    ),
    response=Struct(
        ("throttle_time_ms", Int32),
        ("results", Array(Struct(
            ("error_code", Int16),
            ("log_dir", String),
            ("topics", Array(Struct(
                ("name", String),
                ("partitions", Array(Struct(
                    ("partition_index", Int32),
                    ("partition_size", Int64),
                    ("offset_lag", Int64),
                    ("is_future_key", Boolean),
                ))),
            ))),
        ))),
    ),
)

# ------------------------------------------------------------------- SASL

#: SaslHandshake v1 + SaslAuthenticate v0 (KIP-152 framed authentication;
#: the reference rides the JVM client's identical exchange via JAAS,
#: config/cruise_control_jaas.conf_template)
SASL_HANDSHAKE = Api(
    "SaslHandshake", 17, 1, False,
    request=Struct(("mechanism", String)),
    response=Struct(
        ("error_code", Int16),
        ("mechanisms", Array(String)),
    ),
)

SASL_AUTHENTICATE = Api(
    "SaslAuthenticate", 36, 0, False,
    request=Struct(("auth_bytes", Bytes)),
    response=Struct(
        ("error_code", Int16),
        ("error_message", NullableString),
        ("auth_bytes", Bytes),
    ),
)

ALL_APIS = [
    PRODUCE, FETCH, LIST_OFFSETS, CREATE_TOPICS,
    API_VERSIONS, METADATA, ALTER_PARTITION_REASSIGNMENTS,
    LIST_PARTITION_REASSIGNMENTS, ELECT_LEADERS, INCREMENTAL_ALTER_CONFIGS,
    DESCRIBE_CONFIGS, ALTER_REPLICA_LOG_DIRS, DESCRIBE_LOG_DIRS,
]

#: negotiated only when SASL is configured — deliberately NOT part of the
#: check_api_support sweep (a PLAINTEXT listener does not advertise them)
SASL_APIS = [SASL_HANDSHAKE, SASL_AUTHENTICATE]

BY_KEY_VERSION = {(a.key, a.version): a for a in ALL_APIS + SASL_APIS}


# ------------------------------------------------------------------ headers

REQUEST_HEADER_V1 = Struct(  # classic APIs
    ("api_key", Int16), ("api_version", Int16),
    ("correlation_id", Int32), ("client_id", NullableString),
)
REQUEST_HEADER_V2 = Struct(  # flexible APIs (KIP-482)
    ("api_key", Int16), ("api_version", Int16),
    ("correlation_id", Int32), ("client_id", NullableString),
    ("_tags", TagBuffer),
)
RESPONSE_HEADER_V0 = Struct(("correlation_id", Int32))
RESPONSE_HEADER_V1 = Struct(("correlation_id", Int32), ("_tags", TagBuffer))


def encode_request(api: Api, correlation_id: int, client_id: str, body: dict) -> bytes:
    header = REQUEST_HEADER_V2 if api.flexible else REQUEST_HEADER_V1
    out = bytearray()
    header.write(out, {
        "api_key": api.key, "api_version": api.version,
        "correlation_id": correlation_id, "client_id": client_id,
    })
    api.request.write(out, body)
    framed = bytearray()
    Int32.write(framed, len(out))
    framed += out
    return bytes(framed)


def decode_response(api: Api, payload: bytes) -> tuple[int, dict]:
    """payload excludes the length frame; returns (correlation_id, body)."""
    header = RESPONSE_HEADER_V1 if api.flexible else RESPONSE_HEADER_V0
    h, off = header.read(payload, 0)
    body, off = api.response.read(payload, off)
    return h["correlation_id"], body


def decode_request(payload: bytes) -> tuple[Api, int, str, dict]:
    """Server side (fake broker): payload excludes the length frame."""
    # api_key/api_version determine the header+body schema
    api_key, _ = Int16.read(payload, 0)
    api_version, _ = Int16.read(payload, 2)
    api = BY_KEY_VERSION.get((api_key, api_version))
    if api is None:
        raise ValueError(f"unsupported api {api_key} v{api_version}")
    header = REQUEST_HEADER_V2 if api.flexible else REQUEST_HEADER_V1
    h, off = header.read(payload, 0)
    body, off = api.request.read(payload, off)
    return api, h["correlation_id"], h["client_id"], body


def encode_response(api: Api, correlation_id: int, body: dict) -> bytes:
    header = RESPONSE_HEADER_V1 if api.flexible else RESPONSE_HEADER_V0
    out = bytearray()
    header.write(out, {"correlation_id": correlation_id})
    api.response.write(out, body)
    framed = bytearray()
    Int32.write(framed, len(out))
    framed += out
    return bytes(framed)
