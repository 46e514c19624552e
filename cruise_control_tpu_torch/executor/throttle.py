"""Replication throttling around an execution.

Reference: executor/ReplicationThrottleHelper.java:32-47 — sets
leader/follower throttled rates + throttled-replica lists on the brokers
and topics involved in an execution, and cleans them up afterwards (even
on failure).

Every set/clear is recorded in the execution journal when one is attached
(executor/journal.py), so a restarted executor can sweep throttles a
crashed predecessor leaked onto the brokers.
"""

from __future__ import annotations

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.admin import ClusterAdmin


class ReplicationThrottleHelper:
    def __init__(
        self,
        admin: ClusterAdmin,
        throttle_rate_bytes_per_s: float | None,
        *,
        journal=None,
    ):
        self.admin = admin
        self.rate = throttle_rate_bytes_per_s
        self.journal = journal
        self._active = False

    def set_throttles(self, proposals: list[ExecutionProposal], topic_names: dict[int, str]):
        if self.rate is None:
            return
        topics = {
            topic_names.get(p.topic, str(p.topic))
            for p in proposals
            if p.has_replica_action
        }
        if topics:
            # journal FIRST: a crash between the journal write and the
            # broker config change sweeps a throttle that never landed
            # (harmless); the reverse order would leak one silently
            if self.journal is not None:
                self.journal.append(
                    {"t": "throttle_set", "rate": self.rate,
                     "topics": sorted(topics)}
                )
            self.admin.set_replication_throttle(self.rate, topics)
            self._active = True

    def clear_throttles(self):
        if self._active:
            self.admin.clear_replication_throttle()
            self._active = False
            if self.journal is not None:
                self.journal.append({"t": "throttle_cleared"})
