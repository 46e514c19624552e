"""Pluggable replica-movement ordering strategies.

Reference: executor/strategy/ReplicaMovementStrategy.java (SPI),
BaseReplicaMovementStrategy.java (execution-id order),
PrioritizeLargeReplicaMovementStrategy / PrioritizeSmallReplicaMovementStrategy,
PostponeUrpReplicaMovementStrategy (URP moves last).  Strategies chain:
`a.chain(b)` sorts by a's key, breaking ties with b's (reference
ReplicaMovementStrategy.chain).
"""

from __future__ import annotations

from cruise_control_tpu_torch.executor.tasks import ExecutionTask


class ReplicaMovementStrategy:
    """Returns a sort key per task; lower sorts (executes) first."""

    name = "BaseReplicaMovementStrategy"

    def key(self, task: ExecutionTask, context: dict):
        return task.execution_id

    def chain(self, nxt: "ReplicaMovementStrategy") -> "ReplicaMovementStrategy":
        outer = self

        class _Chained(ReplicaMovementStrategy):
            name = f"{outer.name}->{nxt.name}"

            def key(self, task, context):
                return (outer.key(task, context), nxt.key(task, context))

        return _Chained()

    def order(self, tasks: list[ExecutionTask], context: dict | None = None) -> list[ExecutionTask]:
        context = context or {}
        return sorted(tasks, key=lambda t: (self.key(t, context), t.execution_id))


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    pass


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    """Biggest data movements first (reference
    executor/strategy/PrioritizeLargeReplicaMovementStrategy.java)."""

    name = "PrioritizeLargeReplicaMovementStrategy"

    def key(self, task, context):
        return -task.proposal.inter_broker_data_to_move


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    name = "PrioritizeSmallReplicaMovementStrategy"

    def key(self, task, context):
        return task.proposal.inter_broker_data_to_move


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move partitions without under-replicated replicas first (reference
    executor/strategy/PostponeUrpReplicaMovementStrategy.java).  Context key
    'urp_partitions' is a set of (topic, partition)."""

    name = "PostponeUrpReplicaMovementStrategy"

    def key(self, task, context):
        urp = context.get("urp_partitions", set())
        return 1 if (task.proposal.topic, task.proposal.partition) in urp else 0


STRATEGIES_BY_NAME = {
    s.name: s
    for s in (
        BaseReplicaMovementStrategy(),
        PrioritizeLargeReplicaMovementStrategy(),
        PrioritizeSmallReplicaMovementStrategy(),
        PostponeUrpReplicaMovementStrategy(),
    )
}


def resolve_strategy_chain(
    names: list[str], allowed: set[str] | None = None
) -> ReplicaMovementStrategy:
    """Resolve an ordered strategy-name list into one chained strategy
    (reference ExecutorConfig default.replica.movement.strategies +
    per-request replica_movement_strategies).

    Names resolve from the builtin registry or as dotted paths to custom
    classes; `allowed` (reference replica.movement.strategies — the pool of
    supported strategies) restricts what callers may reference."""
    if not names:
        raise ValueError("empty strategy list")
    resolved = []
    for n in names:
        if allowed is not None and n not in allowed:
            raise ValueError(
                f"strategy {n!r} is not in replica.movement.strategies {sorted(allowed)}"
            )
        if n in STRATEGIES_BY_NAME:
            resolved.append(STRATEGIES_BY_NAME[n])
            continue
        if "." in n:
            import importlib

            mod, _, cls = n.rpartition(".")
            resolved.append(getattr(importlib.import_module(mod), cls)())
            continue
        raise ValueError(
            f"unknown replica movement strategy {n!r}; "
            f"builtins: {sorted(STRATEGIES_BY_NAME)}"
        )
    chain = resolved[0]
    for s in resolved[1:]:
        chain = chain.chain(s)
    return chain
