"""TopicConfigProvider SPI — per-topic Kafka configs for detectors/goals.

Reference: config/TopicConfigProvider.java (pluggable via
topic.config.provider.class).  The primary consumer here is the
replication-factor anomaly finder, which needs each topic's
min.insync.replicas: a topic whose RF is below (minISR + 1) cannot
tolerate a broker loss without going under min-ISR, so the finder flags
it even when RF meets the global target
(reference detector/TopicReplicationFactorAnomalyFinder.java uses the
provider the same way).
"""

from __future__ import annotations

from typing import Protocol


class TopicConfigProvider(Protocol):
    def topic_configs(self, topics: list[str]) -> dict[str, dict[str, str]]:
        """{topic: {config name: value}} for the requested topics."""
        ...


class StaticTopicConfigProvider:
    """Fixed config map (tests / clusters without a config channel)."""

    def __init__(self, configs: dict[str, dict[str, str]] | None = None):
        self._configs = configs or {}

    def topic_configs(self, topics: list[str]) -> dict[str, dict[str, str]]:
        return {t: self._configs.get(t, {}) for t in topics}


class KafkaTopicConfigProvider:
    """Reads topic configs over the wire client's DescribeConfigs
    (reference KafkaAdminTopicConfigProvider).

    Constructed by the facade as cls(config, admin) — the provider pulls
    the wire client off the cluster admin; direct construction may pass
    client= instead."""

    _TOPIC_RESOURCE = 2  # ConfigResource type TOPIC

    def __init__(self, config=None, admin=None, *, client=None):
        if client is None:
            client = getattr(admin, "client", None)
        if client is None or not hasattr(client, "describe_configs"):
            raise ValueError(
                "KafkaTopicConfigProvider needs a wire client "
                "(a KafkaClusterAdmin admin, or client=)"
            )
        self.client = client

    def topic_configs(self, topics: list[str]) -> dict[str, dict[str, str]]:
        if not topics:
            return {}
        described = self.client.describe_configs(
            [(self._TOPIC_RESOURCE, t) for t in topics]
        )
        return {
            name: dict(cfg)
            for (rtype, name), cfg in described.items()
            if rtype == self._TOPIC_RESOURCE
        }


def min_insync_replicas_map(
    provider: TopicConfigProvider | None, topics: list[str]
) -> dict[str, int]:
    """{topic: min.insync.replicas} in ONE batch provider call — per-topic
    fetches would turn a detection tick into thousands of admin RPCs."""
    if provider is None or not topics:
        return {t: 1 for t in topics}
    try:
        configs = provider.topic_configs(list(topics))
    except Exception:  # noqa: BLE001 — config channel failure must not kill detection
        return {t: 1 for t in topics}
    out = {}
    for t in topics:
        try:
            out[t] = int(configs.get(t, {}).get("min.insync.replicas", 1))
        except (TypeError, ValueError):
            out[t] = 1
    return out
