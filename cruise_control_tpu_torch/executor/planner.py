"""Execution task planning: proposals -> strategy-ordered task queues with
per-broker concurrency-aware draining.

Reference: executor/ExecutionTaskPlanner.java:63 (addExecutionProposals),
:280-295 (leadership drain), :314+ (getInterBrokerReplicaMovementTasks —
round-robin over ready brokers so no broker starves).
"""

from __future__ import annotations

import dataclasses

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.strategy import (
    BaseReplicaMovementStrategy,
    ReplicaMovementStrategy,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskType


class ExecutionTaskPlanner:
    def __init__(self, strategy: ReplicaMovementStrategy | None = None):
        self.strategy = strategy or BaseReplicaMovementStrategy()
        self._next_id = 0
        self._inter: list[ExecutionTask] = []
        self._intra: list[ExecutionTask] = []
        self._leadership: list[ExecutionTask] = []
        #: execution id -> (proposal, partition key, involved brokers) of
        #: the queued inter-broker tasks (`_involved`)
        self._involved_of: dict[int, tuple] = {}

    def _task(self, proposal: ExecutionProposal, tt: TaskType) -> ExecutionTask:
        t = ExecutionTask(self._next_id, proposal, tt)
        self._next_id += 1
        return t

    def add_execution_proposals(
        self, proposals: list[ExecutionProposal], context: dict | None = None
    ) -> list[ExecutionTask]:
        """Split proposals into typed tasks (reference addExecutionProposals:63)."""
        all_tasks = []
        for p in proposals:
            if p.has_replica_action:
                all_tasks.append(self._task(p, TaskType.INTER_BROKER_REPLICA_ACTION))
            elif p.disk_moves:
                all_tasks.append(self._task(p, TaskType.INTRA_BROKER_REPLICA_ACTION))
            if p.has_leader_action:
                # leadership settles in phase 2 via preferred-leader election,
                # after any replica move of the same partition completed
                # (reference runs moveLeaderships after interBrokerMoveReplicas,
                # Executor.java:749)
                all_tasks.append(self._task(p, TaskType.LEADER_ACTION))
        self._inter += [t for t in all_tasks if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION]
        self._intra += [t for t in all_tasks if t.task_type == TaskType.INTRA_BROKER_REPLICA_ACTION]
        self._leadership += [t for t in all_tasks if t.task_type == TaskType.LEADER_ACTION]
        self._inter = self.strategy.order(self._inter, context)
        return all_tasks

    def adopt_tasks(self, tasks: list[ExecutionTask], context: dict | None = None):
        """Re-queue PRE-BUILT tasks (journal recovery): ids are preserved —
        a recovered task must journal under the id it started with — and
        the id counter jumps past them so later additions cannot collide."""
        for t in tasks:
            self._next_id = max(self._next_id, t.execution_id + 1)
        self._inter += [t for t in tasks if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION]
        self._intra += [t for t in tasks if t.task_type == TaskType.INTRA_BROKER_REPLICA_ACTION]
        self._leadership += [t for t in tasks if t.task_type == TaskType.LEADER_ACTION]
        self._inter = self.strategy.order(self._inter, context)

    # ------------------------------------------------------------------

    @property
    def remaining_inter_broker_moves(self) -> list[ExecutionTask]:
        return list(self._inter)

    @property
    def remaining_intra_broker_moves(self) -> list[ExecutionTask]:
        return list(self._intra)

    @property
    def remaining_leadership_moves(self) -> list[ExecutionTask]:
        return list(self._leadership)

    def get_leadership_movement_tasks(self, num_tasks: int) -> list[ExecutionTask]:
        """Reference getLeadershipMovementTasks:295."""
        out, self._leadership = self._leadership[:num_tasks], self._leadership[num_tasks:]
        return out

    def get_intra_broker_replica_movement_tasks(
        self, ready_brokers: dict[int, int], max_total: int | None = None
    ) -> list[ExecutionTask]:
        out = []
        rest = []
        for t in self._intra:
            # slots are charged on the brokers actually COPYING between
            # logdirs (one per disk move), not the replica list
            brokers = {b for (b, _old, _new) in t.proposal.disk_moves}
            if not brokers and t.proposal.new_replicas:
                brokers = {t.proposal.new_replicas[0]}
            if (
                brokers
                and all(ready_brokers.get(b, 0) > 0 for b in brokers)
                and (max_total is None or len(out) < max_total)
            ):
                for b in brokers:
                    ready_brokers[b] -= 1
                out.append(t)
            else:
                rest.append(t)
        self._intra = rest
        return out

    def _involved(self, t: ExecutionTask) -> tuple[tuple[int, int], frozenset[int]]:
        """(partition key, brokers a replica is added to or dropped from)
        of an inter-broker task, computed once a task: its proposal is
        frozen."""
        p = t.proposal
        got = self._involved_of.get(t.execution_id)
        if got is None or got[0] is not p:
            old, new = set(p.old_replicas), set(p.new_replicas)
            got = (p, (p.topic, p.partition), frozenset((new - old) | (old - new)))
            self._involved_of[t.execution_id] = got
        return got[1], got[2]

    def get_inter_broker_replica_movement_tasks(
        self,
        ready_brokers: dict[int, int],
        in_progress_partitions: set[tuple[int, int]],
        max_total: int | None = None,
    ) -> list[ExecutionTask]:
        """Drain tasks whose source AND destination brokers have slots,
        round-robin across brokers so slots aren't starved
        (reference getInterBrokerReplicaMovementTasks:314).  max_total
        bounds the drain so the executor's global
        max.num.cluster.movements budget is honored.

        Each broker scans its own tasks (those involving it, in `_inter`
        order) from a cursor that only moves forward within the call,
        which makes exactly the choices of a scan of all tasks from the
        start for every broker visit.  Within one call `slots` only
        decrease and the chosen set and `partitions_involved` only grow,
        so a task skipped at a broker's visit (chosen, its partition
        already involved, or an involved broker out of slots) stays
        ineligible until the call returns; the tasks before the cursor
        are all such.  A task with an involved broker that has no slot at
        the start can never be taken and joins no queue.  The per-pass
        broker order stays `list(slots)` and `brokers_involved` resets
        every pass, as in the full scan.  A call costs the remaining
        tasks' involved brokers plus brokers x passes, where the full scan
        cost brokers x tasks each pass."""
        slots = dict(ready_brokers)
        chosen: list[ExecutionTask] = []
        chosen_ids: set[int] = set()
        partitions_involved = set(in_progress_partitions)
        queues: dict[int, list[ExecutionTask]] = {b: [] for b, n in slots.items() if n > 0}
        for t in self._inter:
            _key, involved = self._involved(t)
            if all(b in queues for b in involved):
                for b in involved:
                    queues[b].append(t)
        cursor = dict.fromkeys(queues, 0)

        new_task_added = True
        while new_task_added and (max_total is None or len(chosen) < max_total):
            new_task_added = False
            brokers_involved: set[int] = set()
            for broker_id in list(slots):
                if max_total is not None and len(chosen) >= max_total:
                    break
                if broker_id in brokers_involved or slots.get(broker_id, 0) <= 0:
                    continue
                queue = queues[broker_id]
                i = cursor[broker_id]
                while i < len(queue):
                    t = queue[i]
                    i += 1
                    if t.execution_id in chosen_ids:
                        continue
                    key, involved = self._involved(t)
                    if key in partitions_involved:
                        continue
                    if any(slots.get(b, 0) <= 0 for b in involved):
                        continue
                    for b in involved:
                        slots[b] -= 1
                        brokers_involved.add(b)
                    partitions_involved.add(key)
                    chosen.append(t)
                    chosen_ids.add(t.execution_id)
                    new_task_added = True
                    break
                cursor[broker_id] = i
        if chosen_ids:
            self._inter = [t for t in self._inter if t.execution_id not in chosen_ids]
            for eid in chosen_ids:
                self._involved_of.pop(eid, None)
        return chosen
