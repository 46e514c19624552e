"""Anomaly notifiers: decide FIX vs CHECK vs IGNORE; alert integrations.

Reference: detector/notifier/AnomalyNotifier.java (SPI),
AnomalyNotificationResult.java, SelfHealingNotifier.java:68-104 (per-type
self-healing switches; broker failures alert after
`broker.failure.alert.threshold.ms` and self-heal after
`broker.failure.self.healing.threshold.ms`), SlackSelfHealingNotifier.java
(webhook alerting — modeled as a pluggable alert callback since this
environment has no egress).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Protocol

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    ExecutionStuck,
    FleetLeaseLost,
    OptimizerDegraded,
)


class Action(enum.Enum):
    """Reference AnomalyNotificationResult.Action."""

    FIX = "FIX"
    CHECK = "CHECK"
    IGNORE = "IGNORE"


@dataclasses.dataclass(frozen=True)
class AnomalyNotificationResult:
    action: Action
    delay_ms: int = 0

    @staticmethod
    def fix() -> "AnomalyNotificationResult":
        return AnomalyNotificationResult(Action.FIX)

    @staticmethod
    def check(delay_ms: int) -> "AnomalyNotificationResult":
        return AnomalyNotificationResult(Action.CHECK, delay_ms)

    @staticmethod
    def ignore() -> "AnomalyNotificationResult":
        return AnomalyNotificationResult(Action.IGNORE)


class AnomalyNotifier(Protocol):
    def on_anomaly(self, anomaly: Anomaly) -> AnomalyNotificationResult:
        ...

    def self_healing_enabled(self) -> dict[AnomalyType, bool]:
        ...


class SelfHealingNotifier:
    """Reference detector/notifier/SelfHealingNotifier.java.

    Broker failures are special-cased: alert after alert_threshold_ms from
    the earliest failure, FIX only after self_healing_threshold_ms — giving
    ops a window to bring a broker back before replicas are rebuilt.
    """

    def __init__(
        self,
        *,
        self_healing: dict[AnomalyType, bool] | None = None,
        broker_failure_alert_threshold_ms: int = 15 * 60 * 1000,
        broker_failure_self_healing_threshold_ms: int = 30 * 60 * 1000,
        alert_handler: Callable[[Anomaly, bool], None] | None = None,
        now_ms: Callable[[], int] | None = None,
    ):
        self._enabled = {t: False for t in AnomalyType}
        if self_healing:
            self._enabled.update(self_healing)
        self.alert_threshold_ms = broker_failure_alert_threshold_ms
        self.self_healing_threshold_ms = broker_failure_self_healing_threshold_ms
        self._alert = alert_handler or (lambda anomaly, auto_fix: None)
        self._now = now_ms or (lambda: int(time.time() * 1000))
        self.alerts: list[tuple[Anomaly, bool]] = []

    def self_healing_enabled(self) -> dict[AnomalyType, bool]:
        return dict(self._enabled)

    def set_self_healing(self, anomaly_type: AnomalyType, enabled: bool):
        self._enabled[anomaly_type] = enabled

    def _send_alert(self, anomaly: Anomaly, auto_fix: bool):
        self.alerts.append((anomaly, auto_fix))
        self._alert(anomaly, auto_fix)

    def on_anomaly(self, anomaly: Anomaly) -> AnomalyNotificationResult:
        if isinstance(anomaly, BrokerFailures):
            return self._on_broker_failure(anomaly)
        if isinstance(anomaly, (OptimizerDegraded, ExecutionStuck,
                                FleetLeaseLost)):
            # nothing to fix (the supervisor's half-open probe / the
            # executor's reaper / the lease heartbeat's re-acquisition
            # already IS the recovery path) but operators must hear about
            # it immediately — alert, then ignore
            self._send_alert(anomaly, False)
            return AnomalyNotificationResult.ignore()
        if not self._enabled.get(anomaly.anomaly_type, False) or not anomaly.fixable:
            return AnomalyNotificationResult.ignore()
        self._send_alert(anomaly, True)
        return AnomalyNotificationResult.fix()

    def _on_broker_failure(self, anomaly: BrokerFailures) -> AnomalyNotificationResult:
        """Reference SelfHealingNotifier.onBrokerFailure:68-104."""
        if not anomaly.failed_brokers:
            return AnomalyNotificationResult.ignore()
        earliest = min(anomaly.failed_brokers.values())
        now = self._now()
        alert_time = earliest + self.alert_threshold_ms
        fix_time = earliest + self.self_healing_threshold_ms
        if now < alert_time:
            return AnomalyNotificationResult.check(alert_time - now)
        heal = self._enabled.get(AnomalyType.BROKER_FAILURE, False)
        if now < fix_time:
            self._send_alert(anomaly, False)
            return AnomalyNotificationResult.check(fix_time - now)
        self._send_alert(anomaly, heal)
        return AnomalyNotificationResult.fix() if heal else AnomalyNotificationResult.ignore()


class SlackSelfHealingNotifier(SelfHealingNotifier):
    """SelfHealingNotifier that POSTs alerts to a Slack incoming webhook
    (reference detector/notifier/SlackSelfHealingNotifier.java).

    The HTTP POST rides `poster` (injectable for tests / alternate
    webhook-compatible sinks); delivery failures are swallowed — alerting
    must never break anomaly handling (the reference logs and continues).
    """

    def __init__(
        self,
        webhook_url: str,
        *,
        channel: str | None = None,
        username: str = "cruise-control-tpu",
        poster: Callable[[str, bytes], None] | None = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.webhook_url = webhook_url
        self.channel = channel
        self.username = username
        self._post = poster or self._default_post
        self._alert = self._slack_alert  # route SelfHealingNotifier alerts

    @staticmethod
    def _default_post(url: str, body: bytes) -> None:
        import urllib.request

        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"}
        )
        urllib.request.urlopen(req, timeout=10).read()

    def _slack_alert(self, anomaly: Anomaly, auto_fix: bool) -> None:
        import json

        text = (
            f":warning: {anomaly.anomaly_type.name}: {anomaly.description()} "
            f"(self-healing {'STARTED' if auto_fix else 'disabled'})"
        )
        payload: dict = {"text": text, "username": self.username}
        if self.channel:
            payload["channel"] = self.channel
        try:
            self._post(self.webhook_url, json.dumps(payload).encode())
        except Exception:  # noqa: BLE001 — alert delivery is best-effort
            pass


class NoopNotifier:
    """Ignore everything (reference NoopNotifier)."""

    def on_anomaly(self, anomaly: Anomaly) -> AnomalyNotificationResult:
        return AnomalyNotificationResult.ignore()

    def self_healing_enabled(self) -> dict[AnomalyType, bool]:
        return {t: False for t in AnomalyType}
