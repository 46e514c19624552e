"""What-if mutation primitives over the flattened ClusterState tensors.

The scenario planner evaluates hypothetical futures (lose a rack, add three
brokers, double a topic's traffic) without touching the live cluster.
Every hypothetical is a host-side edit of the SAME padded arrays the
optimizer already consumes, so a mutated state rides the engine and goal
machinery of a real model generation.

The editing model: `HostState.of(state)` copies every churn-prone tensor to
host numpy, the edit functions below mutate the copies, and
`HostState.to_state()` re-materializes a ClusterState of the same shape.
Broker ADDS consume `broker_valid=False` padding rows that
ShapeBucketPolicy already reserves, so scenarios of one base cluster keep
one ClusterShape and share one engine.

`LiveState` is the streaming cycle's view of the REAL cluster: the padded
tensors stay on the device across metric windows, and each window scatters
only the changed replicas' loads into them, in place (kernels/scatter.py).

The JAX package's models/whatif.py; the HostState edits are its numpy code
as it stands, kept here as their own copy (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.common.dispatch import count_dispatch
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.kernels.scatter import scatter_loads
from cruise_control_tpu_torch.models.state import ClusterShape, ClusterState

#: ClusterState fields a what-if edit may touch, in declaration order
_REPLICA_FIELDS = (
    "replica_broker", "replica_partition", "replica_topic", "replica_pos",
    "replica_is_leader", "replica_valid", "replica_orig_broker",
    "replica_offline", "replica_disk", "replica_load_leader",
    "replica_load_follower",
)
_BROKER_FIELDS = (
    "broker_capacity", "broker_rack", "broker_host", "broker_alive",
    "broker_new", "broker_valid", "disk_capacity", "disk_alive",
)
#: the fields ClusterState.members is built from
_MEMBER_FIELDS = frozenset(("replica_valid", "replica_partition", "replica_pos"))


@dataclasses.dataclass
class HostState:
    """Mutable host-side (numpy) copy of one ClusterState's tensors.

    Mutators record which fields they touched (`dirty`); `to_state`
    re-materializes ONLY those, so every untouched field of every scenario
    state IS the base state's tensor (same object).
    """

    shape: ClusterShape
    arrays: dict  # field name -> np.ndarray (writable copies)
    dirty: set = dataclasses.field(default_factory=set)

    @staticmethod
    def of(state: ClusterState) -> "HostState":
        fields = _REPLICA_FIELDS + _BROKER_FIELDS
        return HostState(
            shape=state.shape,
            arrays={f: getattr(state, f).cpu().numpy().copy() for f in fields},
        )

    def __getitem__(self, name: str) -> np.ndarray:
        return self.arrays[name]

    def touch(self, *names: str) -> np.ndarray | None:
        """Mark fields as mutated; returns the first's array for writing."""
        self.dirty.update(names)
        return self.arrays[names[0]] if names else None

    def to_state(self, base: ClusterState) -> ClusterState:
        """Re-materialize a ClusterState (same shape as `base`) on `base`'s
        device; only the mutated fields become new tensors, the rest are
        `base`'s.  An edit that leaves the replica rows' partition,
        position and validity alone shares `base`'s member table (built
        once per base), so a batch of scenario states builds it once."""
        kw = {f: torch.from_numpy(self.arrays[f].copy()).to(base.device)
              for f in sorted(self.dirty)}
        if not kw:
            return base
        out = dataclasses.replace(base, **kw)
        if not self.dirty & _MEMBER_FIELDS:
            vars(out)["members"] = base.members  # the cached_property's slot
        return out

    # ------------------------------------------------------------------
    # derived views
    # ------------------------------------------------------------------

    def real_broker_count(self) -> int:
        return int(self["broker_valid"].sum())

    def real_rack_count(self) -> int:
        bv = self["broker_valid"]
        return int(self["broker_rack"][bv].max()) + 1 if bv.any() else 0

    def real_host_count(self) -> int:
        bv = self["broker_valid"]
        return int(self["broker_host"][bv].max()) + 1 if bv.any() else 0

    def alive_mask(self) -> np.ndarray:
        return self["broker_valid"] & self["broker_alive"]

    # ------------------------------------------------------------------
    # topology edits
    # ------------------------------------------------------------------

    def add_broker(
        self,
        *,
        rack_id: int,
        host_id: int | None = None,
        capacity: np.ndarray | None = None,
        disk_capacities: np.ndarray | None = None,
    ) -> int:
        """Activate one padding row as a live NEW broker; returns its id.

        Raises when no padding row is left (the caller planned the shared
        shape too tight) or when rack/host ids exceed the shape's axes —
        the rack axis sizes the engine's [P, num_racks] rack-count table,
        so an out-of-range id would silently corrupt rack-awareness.
        """
        bv = self["broker_valid"]
        free = np.nonzero(~bv)[0]
        if free.size == 0:
            raise ValueError(
                f"no padding broker rows left in shape B={self.shape.B}; "
                "plan the scenario batch shape with room for broker adds"
            )
        b = int(free[0])
        self.touch(
            "broker_valid", "broker_alive", "broker_new", "broker_rack",
            "broker_host", "broker_capacity", "disk_capacity", "disk_alive",
        )
        if not 0 <= rack_id < self.shape.num_racks:
            raise ValueError(
                f"rack id {rack_id} outside shape num_racks={self.shape.num_racks}"
            )
        if host_id is None:
            host_id = self.real_host_count()
        if not 0 <= host_id < self.shape.num_hosts:
            raise ValueError(
                f"host id {host_id} outside shape num_hosts={self.shape.num_hosts}"
            )
        if capacity is None:
            capacity = default_capacity_profile(self)
        cap = np.asarray(capacity, np.float32)
        self["broker_valid"][b] = True
        self["broker_alive"][b] = True
        self["broker_new"][b] = True
        self["broker_rack"][b] = rack_id
        self["broker_host"][b] = host_id
        dc = self["disk_capacity"]
        da = self["disk_alive"]
        if disk_capacities is not None:
            disks = np.asarray(disk_capacities, np.float32)
            if disks.size > dc.shape[1]:
                raise ValueError(
                    f"{disks.size} logdirs exceed shape max_disks_per_broker="
                    f"{dc.shape[1]}"
                )
            dc[b, : disks.size] = disks
            da[b, : disks.size] = True
            cap = cap.copy()
            cap[Resource.DISK] = float(disks.sum())
        else:
            dc[b, 0] = cap[Resource.DISK]
            da[b, 0] = True
        self["broker_capacity"][b] = cap
        return b

    def kill_brokers(self, broker_ids) -> None:
        """Mark brokers dead; their replicas become offline (the exact
        semantics of the facade's remove-broker model edit)."""
        ids = [int(b) for b in broker_ids]
        if not ids:
            return
        bv = self["broker_valid"]
        unknown = [b for b in ids if not (0 <= b < bv.size and bv[b])]
        if unknown:
            raise ValueError(f"broker ids {unknown} are not in the cluster model")
        self.touch("broker_alive", "replica_offline")
        self["broker_alive"][ids] = False
        on_dead = np.isin(self["replica_broker"], ids)
        self["replica_offline"][:] = (
            self["replica_offline"] | on_dead
        ) & self["replica_valid"]

    def kill_racks(self, rack_ids) -> list[int]:
        """Kill every broker on the given racks; returns the broker ids."""
        rids = {int(r) for r in rack_ids}
        bv = self["broker_valid"]
        victims = [
            int(b) for b in np.nonzero(bv)[0] if int(self["broker_rack"][b]) in rids
        ]
        self.kill_brokers(victims)
        return victims

    def demote_brokers(self, broker_ids) -> int:
        """Move leadership off the given brokers onto the lowest-position
        alive replica elsewhere (PreferredLeaderElectionGoal semantics);
        returns the number of leaderships moved.  Partitions with no
        eligible replica keep their leader (the executor would fail the
        election the same way)."""
        demoted = {int(b) for b in broker_ids}
        if not demoted:
            return 0
        valid = self["replica_valid"]
        lead = self["replica_is_leader"]
        brk = self["replica_broker"]
        part = self["replica_partition"]
        pos = self["replica_pos"]
        alive = self.alive_mask()
        self.touch("replica_is_leader")
        moved = 0
        on_demoted = valid & lead & np.isin(brk, list(demoted))
        for p in np.unique(part[on_demoted]):
            rows = np.nonzero(valid & (part == p))[0]
            rows = rows[np.argsort(pos[rows])]
            cands = [
                r for r in rows
                if int(brk[r]) not in demoted and alive[brk[r]]
            ]
            if not cands:
                continue
            lead[rows] = False
            lead[cands[0]] = True
            moved += 1
        return moved

    # ------------------------------------------------------------------
    # load edits
    # ------------------------------------------------------------------

    def scale_topic_load(self, topic_id: int, factors) -> None:
        """Scale a topic's per-replica loads; `factors` is a scalar or a
        per-resource [4] vector."""
        f = np.broadcast_to(
            np.asarray(factors, np.float32), (NUM_RESOURCES,)
        )
        self.touch("replica_load_leader", "replica_load_follower")
        rows = self["replica_valid"] & (self["replica_topic"] == int(topic_id))
        self["replica_load_leader"][rows] *= f
        self["replica_load_follower"][rows] *= f

    def scale_all_load(self, factor) -> None:
        f = np.broadcast_to(np.asarray(factor, np.float32), (NUM_RESOURCES,))
        self.touch("replica_load_leader", "replica_load_follower")
        rows = self["replica_valid"]
        self["replica_load_leader"][rows] *= f
        self["replica_load_follower"][rows] *= f

    def add_load_delta(self, delta) -> None:
        """Add an absolute per-resource [4] delta to every valid replica's
        leader load (clipped at 0).  Followers receive only the NW_IN and
        DISK components (replication traffic and storage track the leader;
        follower CPU stays modeled, follower NW_OUT stays 0 — the
        invariant the builder establishes)."""
        d = np.asarray(delta, np.float32).reshape(NUM_RESOURCES)
        self.touch("replica_load_leader", "replica_load_follower")
        rows = self["replica_valid"]
        ll = self["replica_load_leader"]
        fl = self["replica_load_follower"]
        ll[rows] = np.maximum(ll[rows] + d, 0.0)
        fd = np.zeros(NUM_RESOURCES, np.float32)
        fd[Resource.NW_IN] = d[Resource.NW_IN]
        fd[Resource.DISK] = d[Resource.DISK]
        fl[rows] = np.maximum(fl[rows] + fd, 0.0)


# ----------------------------------------------------------------------
# live-state primitives (streaming cycle)
# ----------------------------------------------------------------------


def _round_up_pow2(n: int, floor: int = 64) -> int:
    n = max(int(n), 1)
    b = floor
    while b < n:
        b <<= 1
    return b


class LiveState:
    """Device-resident flattened ClusterState + IN-PLACE delta primitives.

    Where HostState serves the planner's hypothetical futures (host copy,
    mutate, re-materialize a scenario state), LiveState is the streaming
    cycle's view of the REAL cluster: the padded tensors stay on the
    device across metric windows and each window roll scatters only the
    changed cells into them, so no full model re-flatten happens while the
    shape bucket holds.

    Ownership contract: each update rewrites exactly the tensors it
    changes, in place (never the whole state).  After
    `set_partition_loads`, or after a streaming cycle, the live state's
    load tensors are the only live copy of the loads: anything published
    earlier that rides these tensors (an OptimizerResult's state_before)
    sees the new values, so it must be consumed through host-side fields
    (summary, proposals) only.  The live state is the sole owner of its
    load tensors; the engine keeps buffers of its own and never hands them
    out.

    A window's scatter runs one kernel whatever its width (the count is
    read on the device); the returned width is the JAX package's
    power-of-two bucket of the window, kept for observability.
    """

    def __init__(self, state: ClusterState):
        self.state = state

    @property
    def shape(self) -> ClusterShape:
        return self.state.shape

    def set_partition_loads(
        self, rows: np.ndarray, leader_loads: np.ndarray,
        follower_loads: np.ndarray,
    ) -> int:
        """Scatter new ABSOLUTE per-replica loads (leader + follower
        variants) into the live tensors, in place; rows are replica indices
        (rows in [-R, 0) count from the end, as a JAX index does; any other
        row outside [0, R), the sentinel R among them, is dropped).  Rows
        of one window are unique: duplicates have no defined winner.
        Returns the padded
        scatter width (observability: the JAX package's compiled-program
        bucket of this window)."""
        st = self.state
        rows = np.asarray(rows, np.int32).reshape(-1)
        n = int(rows.size)
        width = _round_up_pow2(max(n, 1))
        ll = np.asarray(leader_loads, np.float32).reshape(n, NUM_RESOURCES)
        fl = np.asarray(follower_loads, np.float32).reshape(n, NUM_RESOURCES)
        count_dispatch("livestate.scatter")
        if n:
            dev = st.device
            scatter_loads(st.replica_load_leader, st.replica_load_follower,
                          torch.from_numpy(rows).to(dev), torch.from_numpy(ll).to(dev),
                          torch.from_numpy(fl).to(dev),
                          torch.tensor([n], dtype=torch.int32, device=dev))
        return width

    def adopt_loads(self, ll: torch.Tensor, fl: torch.Tensor) -> None:
        """Adopt already-scattered load tensors as the live ones: the
        streaming cycle's hand-back (GoalOptimizer.optimize_streaming_cycle
        returns the live pair it scattered in place, so this is a no-op
        for its own result)."""
        self.state = dataclasses.replace(
            self.state, replica_load_leader=ll, replica_load_follower=fl
        )

    def set_broker_liveness(self, alive: np.ndarray) -> None:
        """Replace the broker_alive vector and re-derive replica_offline
        from it (a broker death or revival between windows is a topology
        delta that needs no re-flatten): new tensors for both fields, so a
        cached engine sees new statics."""
        st = self.state
        alive = torch.as_tensor(np.asarray(alive, bool), device=st.device)
        count_dispatch("livestate.liveness")
        rb, rd = st.replica_broker.long(), st.replica_disk.long()
        off = st.replica_valid & ~(alive[rb] & st.disk_alive[rb, rd])
        self.state = dataclasses.replace(st, broker_alive=alive, replica_offline=off)


def default_capacity_profile(h: HostState) -> np.ndarray:
    """Capacity for an added broker with no explicit profile: the
    per-resource MEDIAN over live brokers — the honest 'another one like
    the ones we have' assumption (robust to one outsized broker)."""
    alive = h.alive_mask()
    if not alive.any():
        alive = h["broker_valid"]
    if not alive.any():
        return np.asarray([100.0, 1e5, 1e5, 1e6], np.float32)
    return np.median(h["broker_capacity"][alive], axis=0).astype(np.float32)
