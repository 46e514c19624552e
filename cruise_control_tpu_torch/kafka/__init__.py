"""Real-cluster adapters: a dependency-free Kafka wire-protocol client.

The reference talks to the cluster through the JVM Kafka clients and a
Scala ZooKeeper bridge (executor/ExecutorUtils.scala:31,
executor/ExecutorAdminUtils.java:1, common/MetadataClient.java:1).  Modern
Kafka exposes every operation the executor needs over the broker wire
protocol itself (KIP-455 reassignment, KIP-460 elections, KIP-113 logdir
moves), so this package implements a minimal binary-protocol AdminClient in
pure Python — no kafka-python/confluent dependency — and adapts it to the
framework's ClusterAdmin / MetadataProvider SPIs.

Modules:
  codec.py     — primitive + schema (classic & compact/flexible) encoding
  protocol.py  — request/response schemas for the 8 APIs the executor uses
  client.py    — blocking socket client with controller routing
  admin.py     — KafkaClusterAdmin / KafkaMetadataProvider SPI adapters

Contract tests (tests/test_kafka_admin.py) run the SAME suite against
SimulatedClusterAdmin and KafkaClusterAdmin-against-a-fake-broker
(cruise_control_tpu_torch/testing/fake_kafka.py), the in-process analog of the
reference's embedded-cluster harness (CCKafkaIntegrationTestHarness).
"""

from cruise_control_tpu_torch.kafka.admin import KafkaClusterAdmin, KafkaMetadataProvider
from cruise_control_tpu_torch.kafka.client import KafkaAdminClient, KafkaProtocolError

__all__ = [
    "KafkaAdminClient",
    "KafkaClusterAdmin",
    "KafkaMetadataProvider",
    "KafkaProtocolError",
]
