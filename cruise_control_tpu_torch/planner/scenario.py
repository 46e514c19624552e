"""Declarative, JSON-round-trippable what-if scenarios.

A `Scenario` names a hypothetical future of one base cluster: brokers
added (with capacity profiles), brokers or whole racks lost, brokers
demoted, per-topic load scaled, an absolute load delta applied.
`apply_scenario` compiles it into an edited ClusterState via the
models/whatif.py primitives; `plan_shape` sizes ONE shared (bucketed)
ClusterShape for a whole scenario batch so every mutated state reuses a
single engine and a single batch graph (ShapeBucketPolicy padding rows
become the scenario's added brokers).

All of it is host numpy over `HostState`: the edited fields are uploaded
to the base state's device once, and every field a scenario leaves alone
IS the base state's tensor, which the batched evaluator
(analyzer/scenario_eval.py) reads once for the whole batch.

The JAX package's planner/scenario.py, kept here as its own copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.models.builder import pad_state
from cruise_control_tpu_torch.models.state import (
    DEFAULT_BUCKET_POLICY,
    ClusterShape,
    ClusterState,
    ShapeBucketPolicy,
)
from cruise_control_tpu_torch.models.whatif import HostState


@dataclasses.dataclass(frozen=True)
class BrokerAdd:
    """One group of identical brokers to add.

    rack: rack NAME (resolved via the catalog) or int rack id; None
    spreads the group round-robin over existing racks (the placement a
    capacity plan usually wants).  capacity: per-resource [4] profile;
    None clones the live brokers' median profile.
    """

    count: int = 1
    rack: str | int | None = None
    capacity: tuple | None = None  # [CPU, NW_IN, NW_OUT, DISK]
    disk_capacities: tuple | None = None  # JBOD logdir split

    def to_json(self) -> dict:
        out: dict = {"count": self.count}
        if self.rack is not None:
            out["rack"] = self.rack
        if self.capacity is not None:
            out["capacity"] = list(self.capacity)
        if self.disk_capacities is not None:
            out["diskCapacities"] = list(self.disk_capacities)
        return out

    @staticmethod
    def from_json(d: dict) -> "BrokerAdd":
        return BrokerAdd(
            count=int(d.get("count", 1)),
            rack=d.get("rack"),
            capacity=tuple(d["capacity"]) if d.get("capacity") else None,
            disk_capacities=(
                tuple(d["diskCapacities"]) if d.get("diskCapacities") else None
            ),
        )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One hypothetical future.  Every field defaults to "no change", so
    `Scenario()` is the identity: applying it is observably invisible."""

    name: str = "scenario"
    add_brokers: tuple = ()  # tuple[BrokerAdd, ...]
    remove_brokers: tuple = ()  # broker ids to lose (dead, not drained)
    demote_brokers: tuple = ()  # broker ids to move leadership off
    kill_racks: tuple = ()  # rack names (or int ids) to lose entirely
    #: topic name (or int id) -> load multiplier (scalar or per-resource [4])
    topic_load_factors: dict = dataclasses.field(default_factory=dict)
    load_factor: float = 1.0  # global load multiplier
    load_delta: tuple | None = None  # absolute per-resource [4] delta

    @property
    def is_identity(self) -> bool:
        return (
            not self.add_brokers
            and not self.remove_brokers
            and not self.demote_brokers
            and not self.kill_racks
            and not self.topic_load_factors
            and self.load_factor == 1.0
            and self.load_delta is None
        )

    @property
    def brokers_added(self) -> int:
        return sum(a.count for a in self.add_brokers)

    def to_json(self) -> dict:
        out: dict = {"name": self.name}
        if self.add_brokers:
            out["addBrokers"] = [a.to_json() for a in self.add_brokers]
        if self.remove_brokers:
            out["removeBrokers"] = list(self.remove_brokers)
        if self.demote_brokers:
            out["demoteBrokers"] = list(self.demote_brokers)
        if self.kill_racks:
            out["killRacks"] = list(self.kill_racks)
        if self.topic_load_factors:
            out["topicLoadFactors"] = {
                str(k): (list(v) if isinstance(v, (list, tuple, np.ndarray)) else v)
                for k, v in self.topic_load_factors.items()
            }
        if self.load_factor != 1.0:
            out["loadFactor"] = self.load_factor
        if self.load_delta is not None:
            out["loadDelta"] = list(self.load_delta)
        return out

    @staticmethod
    def from_json(d: dict) -> "Scenario":
        """Parse one scenario dict; unknown keys fail loudly (a typo'd
        `removeBrokres` silently evaluating the identity would report a
        healthy cluster for a broken plan)."""
        known = {
            "name", "addBrokers", "removeBrokers", "demoteBrokers",
            "killRacks", "topicLoadFactors", "loadFactor", "loadDelta",
        }
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown scenario fields {sorted(unknown)} (accepted: {sorted(known)})"
            )
        factors = {}
        for k, v in (d.get("topicLoadFactors") or {}).items():
            factors[k] = tuple(v) if isinstance(v, (list, tuple)) else float(v)
        return Scenario(
            name=str(d.get("name", "scenario")),
            add_brokers=tuple(
                BrokerAdd.from_json(a) for a in d.get("addBrokers") or ()
            ),
            remove_brokers=tuple(int(b) for b in d.get("removeBrokers") or ()),
            demote_brokers=tuple(int(b) for b in d.get("demoteBrokers") or ()),
            kill_racks=tuple(d.get("killRacks") or ()),
            topic_load_factors=factors,
            load_factor=float(d.get("loadFactor", 1.0)),
            load_delta=(
                tuple(float(x) for x in d["loadDelta"])
                if d.get("loadDelta") is not None
                else None
            ),
        )

    def compose(self, other: "Scenario", *, name: str | None = None) -> "Scenario":
        """This scenario with `other` applied on top (the rightsizer lays
        its broker-count change over a forecast load scenario)."""
        factors = dict(self.topic_load_factors)
        for k, v in other.topic_load_factors.items():
            if k in factors:
                a = np.broadcast_to(np.asarray(factors[k], np.float64), (4,))
                b = np.broadcast_to(np.asarray(v, np.float64), (4,))
                factors[k] = tuple((a * b).tolist())
            else:
                factors[k] = v
        delta = self.load_delta
        if other.load_delta is not None:
            delta = tuple(
                (np.asarray(delta or (0.0,) * 4) + np.asarray(other.load_delta)).tolist()
            )
        return Scenario(
            name=name or f"{self.name}+{other.name}",
            add_brokers=self.add_brokers + other.add_brokers,
            remove_brokers=self.remove_brokers + other.remove_brokers,
            demote_brokers=self.demote_brokers + other.demote_brokers,
            kill_racks=self.kill_racks + other.kill_racks,
            topic_load_factors=factors,
            load_factor=self.load_factor * other.load_factor,
            load_delta=delta,
        )


# ----------------------------------------------------------------------
# name resolution against the catalog
# ----------------------------------------------------------------------


def _rack_id(rack, catalog, n_real_racks: int) -> int:
    if isinstance(rack, (int, np.integer)):
        return int(rack)
    racks = tuple(getattr(catalog, "racks", ()) or ())
    if rack in racks:
        return racks.index(rack)
    raise ValueError(f"unknown rack {rack!r} (known: {list(racks) or range(n_real_racks)})")


def _topic_id(topic, catalog) -> int:
    if isinstance(topic, (int, np.integer)):
        return int(topic)
    if catalog is not None:
        # the catalog NAME wins: Kafka allows digit-only topic names, so a
        # topic literally called "123" must resolve by name, not as id 123
        try:
            return catalog.topic_id(topic)
        except KeyError:
            pass
    if isinstance(topic, str) and topic.isdigit():
        return int(topic)  # JSON object keys are strings; int ids survive
    raise ValueError(
        f"unknown topic {topic!r}"
        + ("" if catalog is not None else " (no catalog; use the int topic id)")
    )


# ----------------------------------------------------------------------
# shape planning + application
# ----------------------------------------------------------------------


def plan_shape(
    state: ClusterState,
    scenarios,
    *,
    bucket: ShapeBucketPolicy | None = None,
) -> ClusterShape:
    """ONE shared shape accommodating every scenario of a batch.

    Broker adds consume padding rows; only when a batch adds more brokers
    (or hosts) than the current padding holds does an axis grow — rounded
    by the bucket policy so the grown shape is itself engine-cache
    friendly.  Replica/partition/topic/rack axes never grow here (adds
    create no replicas; new brokers join existing racks)."""
    bucket = bucket if bucket is not None else DEFAULT_BUCKET_POLICY
    s = state.shape
    bv = state.broker_valid.cpu().numpy()
    n_real_b = int(bv.sum())
    bh = state.broker_host.cpu().numpy()
    n_real_h = int(bh[bv].max()) + 1 if n_real_b else 0
    max_add = max((sum(a.count for a in sc.add_brokers) for sc in scenarios), default=0)

    def axis(current: int, needed: int) -> int:
        # keep the CURRENT axis whenever its padding already fits: the
        # identity scenario (and any batch inside the padding) must not
        # change shape, so evaluation rides the engine already built for
        # the live model
        return current if needed <= current else bucket.bucket(needed)

    return ClusterShape(
        num_replicas=s.num_replicas,
        num_brokers=axis(s.num_brokers, n_real_b + max_add),
        num_partitions=s.num_partitions,
        num_topics=s.num_topics,
        num_racks=s.num_racks,
        num_hosts=axis(s.num_hosts, n_real_h + max_add),
        max_disks_per_broker=s.max_disks_per_broker,
    )


def apply_scenario(
    state: ClusterState,
    scenario: Scenario,
    catalog=None,
    *,
    shape: ClusterShape | None = None,
    bucket: ShapeBucketPolicy | None = None,
) -> ClusterState:
    """Edit the flattened model arrays per `scenario` -> new ClusterState.

    `shape`: the batch-shared target shape from plan_shape (padded to
    before editing); None plans for this scenario alone.  The result is
    array-for-array identical to the input for the identity scenario, so
    scenario evaluation inherits every masking/parity guarantee of the
    bucketing layer.
    """
    return _apply(state, scenario, catalog, shape=shape, bucket=bucket)[0]


def _apply(state, scenario, catalog=None, *, shape=None, bucket=None, host=None):
    """`apply_scenario`, also returning the edited HostState.  `host`, a
    HostState of `state` fetched once by the caller, is copied instead of
    fetching the state again (a batch fetches its base once)."""
    if shape is None:
        shape = plan_shape(state, [scenario], bucket=bucket)
    if shape != state.shape:
        state = pad_state(state, shape)
        host = None
    if host is None:
        h = HostState.of(state)
    else:
        h = HostState(shape=host.shape, arrays={f: a.copy() for f, a in host.arrays.items()})
    n_real_racks = h.real_rack_count()

    # --- topology: losses first (adds must not land on a dying rack id
    #     by surprise: the scenario author sees losses applied to the
    #     base cluster, adds placed on what survives) ---
    if scenario.kill_racks:
        h.kill_racks(
            _rack_id(r, catalog, n_real_racks) for r in scenario.kill_racks
        )
    if scenario.remove_brokers:
        h.kill_brokers(scenario.remove_brokers)
    if scenario.demote_brokers:
        h.demote_brokers(scenario.demote_brokers)
    if scenario.add_brokers:
        alive_racks = np.unique(h["broker_rack"][h.alive_mask()])
        if alive_racks.size == 0:
            alive_racks = np.unique(h["broker_rack"][h["broker_valid"]])
        rr = 0
        for grp in scenario.add_brokers:
            for _ in range(grp.count):
                if grp.rack is None:
                    rack_id = int(alive_racks[rr % alive_racks.size])
                    rr += 1
                else:
                    rack_id = _rack_id(grp.rack, catalog, n_real_racks)
                h.add_broker(
                    rack_id=rack_id,
                    capacity=(
                        np.asarray(grp.capacity, np.float32)
                        if grp.capacity is not None
                        else None
                    ),
                    disk_capacities=(
                        np.asarray(grp.disk_capacities, np.float32)
                        if grp.disk_capacities is not None
                        else None
                    ),
                )

    # --- load ---
    for topic, factors in scenario.topic_load_factors.items():
        h.scale_topic_load(_topic_id(topic, catalog), factors)
    if scenario.load_factor != 1.0:
        h.scale_all_load(scenario.load_factor)
    if scenario.load_delta is not None:
        h.add_load_delta(scenario.load_delta)

    return h.to_state(state), h
