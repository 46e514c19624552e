"""Execution proposals — the optimizer's output contract.

Reference: executor/ExecutionProposal.java:25 (old/new replica lists +
data-to-move) and analyzer/AnalyzerUtils.getDiff:50-117 (distribution diff
between pre- and post-optimization cluster models).  Here the diff is an
array comparison between two ClusterStates sharing the same replica axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.models.state import ClusterState, replica_members


@dataclasses.dataclass(frozen=True)
class ExecutionProposal:
    """One partition's reassignment (reference executor/ExecutionProposal.java:25).

    Replica lists are broker ids, leader first (the reference keeps the new
    leader at the head of the new replica list).
    """

    partition: int
    topic: int
    old_leader: int
    new_leader: int
    old_replicas: tuple[int, ...]
    new_replicas: tuple[int, ...]
    #: per-replica (broker, old_disk, new_disk) intra-broker moves (JBOD)
    disk_moves: tuple[tuple[int, int, int], ...] = ()
    #: bytes of replica data crossing broker boundaries
    inter_broker_data_to_move: float = 0.0
    #: bytes of replica data moving between a broker's own logdirs
    intra_broker_data_to_move: float = 0.0

    @property
    def has_replica_action(self) -> bool:
        return set(self.old_replicas) != set(self.new_replicas)

    @property
    def has_leader_action(self) -> bool:
        return self.old_leader != self.new_leader

    def to_json(self) -> dict:
        return {
            "topicPartition": {"topic": int(self.topic), "partition": int(self.partition)},
            "oldLeader": int(self.old_leader),
            "oldReplicas": [int(b) for b in self.old_replicas],
            "newReplicas": [int(b) for b in self.new_replicas],
        }


BEFORE_HOST_KEYS = (
    "replica_valid", "replica_topic", "replica_broker", "replica_is_leader",
    "replica_disk", "replica_partition", "replica_pos",
)


def fetch_before_host(state: ClusterState) -> dict:
    """Host numpy copies of everything extract_proposals needs from the
    BEFORE state (only the DISK column of the [R, 4] leader loads)."""
    out = {k: getattr(state, k).cpu().numpy() for k in BEFORE_HOST_KEYS}
    out["replica_disk_bytes"] = state.replica_load_leader[:, int(Resource.DISK)].cpu().numpy()
    return out


class ProposalSet:
    """Columnar proposal set with LAZY ExecutionProposal materialization.

    The optimizer's native diff output is columnar (per-touched-partition
    numpy rows); building ~100k Python dataclass instances costs more than
    an entire device annealing round at north-star scale.  This sequence
    keeps the columns and materializes objects only when a consumer
    actually iterates (the executor at execution start, REST serializing
    its first-100 preview) — aggregate stats (move counts, data to move)
    come straight off the arrays.

    Quacks like the list the rest of the stack always consumed: len(),
    iteration, indexing/slicing, bool, list() all work.
    """

    def __init__(self, columns: dict, disk_rows: dict):
        self._c = columns
        self._disk_rows = disk_rows
        self._all: list[ExecutionProposal] | None = None

    # ---------------------------------------------------- aggregate stats

    def __len__(self) -> int:
        return len(self._c["touched"])

    def __bool__(self) -> bool:
        return len(self) > 0

    @property
    def num_inter_broker_moves(self) -> int:
        """Rows whose replica SET changed (ExecutionProposal.has_replica_action)."""
        return int(self._c["set_changed"].sum())

    @property
    def num_leadership_moves(self) -> int:
        c = self._c
        return int(((c["old_leader"] != c["new_leader"]) & ~c["set_changed"]).sum())

    @property
    def data_to_move(self) -> float:
        return float(self._c["data"].sum())

    @property
    def intra_data_to_move(self) -> float:
        return float(self._c["intra_data"].sum())

    @property
    def source_brokers(self) -> set[int]:
        """Brokers shipping replica data away (execution-ETA input)."""
        c = self._c
        src = c["tb_old"][c["moved"]]
        return {int(b) for b in np.unique(src)}

    def destination_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(topic_id, destination_broker) pairs of replica MOVES — brokers
        receiving a replica of the partition they did not hold before.
        The observation unit of the learned move-acceptance prior
        (controller/prior.py); columnar, no object materialization."""
        c = self._c
        nb, ob = c["nb"], c["ob"]  # [N, max_rf], -1 pads
        incoming = (nb >= 0) & ~(nb[:, :, None] == ob[:, None, :]).any(-1)
        rows, cols = np.nonzero(incoming)
        return (
            c["topic"][rows].astype(np.int64),
            nb[rows, cols].astype(np.int64),
        )

    # ---------------------------------------------------- materialization

    def _rows(self, ks) -> list[ExecutionProposal]:
        c = self._c
        # the values tuple below is hand-ordered to match — this assert
        # makes a field reorder/insert in ExecutionProposal fail loudly
        # here instead of silently scrambling every proposal
        fields = tuple(f.name for f in dataclasses.fields(ExecutionProposal))
        assert fields == (
            "partition", "topic", "old_leader", "new_leader",
            "old_replicas", "new_replicas", "disk_moves",
            "inter_broker_data_to_move", "intra_broker_data_to_move",
        ), fields
        new = ExecutionProposal.__new__
        cls = ExecutionProposal
        disk_rows = self._disk_rows
        empty: tuple = ()
        out: list[ExecutionProposal] = []
        append = out.append
        for k, (p, t, olr, nlr, obk, nbk, nv, dt, idt) in zip(ks, zip(
            c["touched"][ks].tolist(), c["topic"][ks].tolist(),
            c["old_leader"][ks].tolist(), c["new_leader"][ks].tolist(),
            c["ob"][ks].tolist(), c["nb"][ks].tolist(),
            c["n_valid"][ks].tolist(), c["data"][ks].tolist(),
            c["intra_data"][ks].tolist(),
        )):
            o = new(cls)
            # frozen dataclass: populate __dict__ directly —
            # object.__setattr__ per field costs ~4x across ~100k proposals
            o.__dict__.update(zip(fields, (
                p, t, olr, nlr, tuple(obk[:nv]), tuple(nbk[:nv]),
                disk_rows.get(int(k), empty), dt, idt,
            )))
            append(o)
        return out

    def rows_at(self, indices) -> list[ExecutionProposal]:
        """Materialize ONLY the given rows (decision-ledger top-moves
        featurization: the top-N-by-data rows of a 100k-move plan must
        not force the whole set into Python objects)."""
        if self._all is not None:
            return [self._all[int(i)] for i in indices]
        return self._rows(np.asarray(indices, np.int64))

    def top_by_data(self, n: int) -> list[ExecutionProposal]:
        """The `n` proposals moving the most inter-broker data, selected
        on the columns (no materialization beyond the returned rows) —
        the decision ledger's top-moves accessor."""
        data = np.asarray(self._c["data"])
        return self.rows_at(np.argsort(-data)[: max(0, n)])

    def _materialize(self) -> list[ExecutionProposal]:
        if self._all is None:
            self._all = self._rows(np.arange(len(self)))
        return self._all

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, item):
        if isinstance(item, slice):
            if self._all is not None:
                return self._all[item]
            return self._rows(np.arange(len(self))[item])
        return self._materialize()[item]

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            return self._materialize() == list(other)
        if isinstance(other, ProposalSet):
            return self._materialize() == other._materialize()
        return NotImplemented

    def __repr__(self) -> str:
        return f"ProposalSet({len(self)} proposals)"


def _empty_proposal_set() -> ProposalSet:
    z = np.zeros(0, np.int64)
    return ProposalSet(
        dict(touched=z, topic=z, old_leader=z, new_leader=z,
             ob=np.zeros((0, 1), np.int64), nb=np.zeros((0, 1), np.int64),
             n_valid=z, data=np.zeros(0), intra_data=np.zeros(0),
             set_changed=np.zeros(0, bool), moved=np.zeros((0, 1), bool),
             tb_old=np.zeros((0, 1), np.int64)),
        {},
    )


def extract_proposals(
    before: ClusterState,
    after: ClusterState,
    before_host: dict | None = None,
    after_host: dict | None = None,
) -> ProposalSet:
    """Diff two placements into per-partition proposals
    (reference analyzer/AnalyzerUtils.getDiff:50-117).

    Vectorized over a padded [P, max_rf] partition-replica table: at
    LinkedIn scale a rebalance touches >100k partitions and per-partition
    numpy slicing would dominate the optimizer wall-clock.  Returns a
    columnar ProposalSet; ExecutionProposal objects materialize lazily.

    before_host: pre-fetched numpy copies of the before-state arrays
    (fetch_before_host) — skips re-transferring them.  after_host: numpy
    copies of the after placement (replica_broker, replica_is_leader,
    replica_disk; a reported run's payload) — likewise.
    """
    if before_host is None:
        before_host = fetch_before_host(before)
    valid = before_host["replica_valid"]
    topic = before_host["replica_topic"]
    b_old = before_host["replica_broker"]
    l_old = before_host["replica_is_leader"]
    d_old = before_host["replica_disk"]
    disk_bytes = before_host["replica_disk_bytes"]
    part_arr = before_host["replica_partition"]
    pos_arr = before_host["replica_pos"]
    if after_host is None:
        after_host = {k: getattr(after, k).cpu().numpy()
                      for k in ("replica_broker", "replica_is_leader", "replica_disk")}
    b_new = after_host["replica_broker"]
    l_new = after_host["replica_is_leader"]
    d_new = after_host["replica_disk"]

    changed = valid & ((b_old != b_new) | (l_old != l_new) | (d_old != d_new))
    if not changed.any():
        return _empty_proposal_set()
    touched = np.unique(part_arr[changed])

    # padded per-partition replica rows, already in preferred (pos) order
    table = replica_members(valid, part_arr, pos_arr, before.shape)[touched]
    R = before.shape.R
    mask = table < R  # [N, max_rf]
    rows = np.minimum(table, R - 1)

    tb_old = np.where(mask, b_old[rows], -1)
    tb_new = np.where(mask, b_new[rows], -1)
    tl_old = np.where(mask, l_old[rows], False)
    tl_new = np.where(mask, l_new[rows], False)
    td_old = np.where(mask, d_old[rows], 0)
    td_new = np.where(mask, d_new[rows], 0)
    old_leader = np.where(
        tl_old.any(1), tb_old[np.arange(len(touched)), tl_old.argmax(1)], -1
    )
    new_leader = np.where(
        tl_new.any(1), tb_new[np.arange(len(touched)), tl_new.argmax(1)], -1
    )
    moved = mask & (tb_old != tb_new)
    data = np.where(moved, disk_bytes[rows], 0.0).sum(1)
    disk_changed = mask & (tb_old == tb_new) & (td_old != td_new)
    t_topic = topic[rows[:, 0]]

    # leader-first ordering, vectorized: stable sort on (2=pad, 1=follower,
    # 0=leader) keeps the preferred order among followers while hoisting the
    # leader to the head — then materialize via tolist() (numpy scalar
    # indexing inside a 100k-row loop would dominate the optimizer wall)
    def reorder(tb, leader):
        key = np.where(tb < 0, 2, np.where(tb == leader[:, None], 0, 1))
        idx = np.argsort(key, axis=1, kind="stable")
        return np.take_along_axis(tb, idx, axis=1)

    n_valid = mask.sum(1)
    ob = reorder(tb_old, old_leader)
    nb = reorder(tb_new, new_leader)
    has_disk = disk_changed.any(1)
    disk_rows = {
        int(k): tuple(
            (int(tb_new[k, j]), int(td_old[k, j]), int(td_new[k, j]))
            for j in np.nonzero(disk_changed[k])[0]
        )
        for k in np.nonzero(has_disk)[0]
    }

    intra_data = np.where(disk_changed, disk_bytes[rows], 0.0).sum(1)
    # replica SET change per row (has_replica_action semantics: a
    # within-partition slot swap is not a membership change)
    set_changed = (np.sort(tb_old, axis=1) != np.sort(tb_new, axis=1)).any(1)

    return ProposalSet(
        dict(
            touched=touched, topic=t_topic, old_leader=old_leader,
            new_leader=new_leader, ob=ob, nb=nb, n_valid=n_valid,
            data=data, intra_data=intra_data, set_changed=set_changed,
            moved=moved, tb_old=tb_old,
        ),
        disk_rows,
    )
