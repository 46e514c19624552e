"""Metric-window delta extraction over WindowedHistory snapshots.

The streaming controller (controller/streaming.py) keeps the flattened
ClusterState device-resident and, on every window roll, wants to ship
ONLY what changed — not rebuild the whole model.  This module diffs two
read-only `WindowedHistory` snapshots of the partition aggregator
(monitor/aggregator.py) into a per-entity load update plus the
generation-level facts that force a full re-flatten (entities appearing
or vanishing mid-stream = topics created/deleted).

Completeness discipline: the reduction honors the history's `complete`
mask, never the raw values — a half-sampled window (the current window
just rolled, a fetcher hiccup) holds a partial SUM-derived average whose
value is biased low, and folding it in would read as a traffic drop and
trigger spurious re-anneals toward a phantom load profile.  Entities with
NO fully-sampled window in the snapshot are reported `stale` (hold their
previous loads) rather than updated.

Resource semantics mirror LoadMonitor._window_reduced_loads: CPU/NW_IN/
NW_OUT average over (complete) windows, DISK takes the newest complete
window (LATEST strategy — disk usage is a level, not a rate).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.monitor.aggregator import WindowedHistory
from cruise_control_tpu_torch.monitor.metricdef import MetricDef


@dataclasses.dataclass(frozen=True)
class ReducedLoads:
    """Per-entity [4] loads reduced from one WindowedHistory snapshot."""

    entities: tuple
    loads: np.ndarray  # f32[E, 4] in Resource order
    usable: np.ndarray  # bool[E] entity had >= 1 complete window


@dataclasses.dataclass(frozen=True)
class WindowDelta:
    """What changed between two WindowedHistory snapshots.

    `entities`/`loads` cover every entity (present in BOTH snapshots) with
    at least one complete window in the newer snapshot — new ABSOLUTE
    loads, not increments, so the consumer scatters idempotently.
    `changed` marks the subset whose reduced loads actually moved.
    `added`/`removed` are entity-set diffs (mid-stream topic or partition
    create/delete): the delta path cannot express them in place, so the
    consumer must re-flatten.  `stale` entities had no complete window and
    keep their previous loads.
    """

    entities: tuple
    loads: np.ndarray  # f32[N, 4] Resource order (absolute)
    changed: np.ndarray  # bool[N]
    added: tuple
    removed: tuple
    stale: tuple
    windows_advanced: int
    #: the NEW snapshot's ReducedLoads — the consumer caches it and hands
    #: it back as `prev_reduced` next cycle, so an always-on loop never
    #: re-reduces the same [E, W, 4] tensor twice
    reduced: "ReducedLoads | None" = None

    @property
    def requires_reflatten(self) -> bool:
        return bool(self.added or self.removed)


def _load_columns(metric_def: MetricDef) -> list[int]:
    return [
        metric_def.metric_id("CPU_USAGE"),
        metric_def.metric_id("LEADER_BYTES_IN"),
        metric_def.metric_id("LEADER_BYTES_OUT"),
        metric_def.metric_id("DISK_USAGE"),
    ]


def reduce_windowed_loads(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[E, W, 4] per-window load columns (CPU, NW_IN, NW_OUT, DISK — the
    `_load_columns` slice order) + bool[E, W] usable-window mask ->
    f32[E, 4] in Resource order: the AVG resources average over masked
    windows, DISK takes the NEWEST masked window (LATEST strategy — disk
    usage is a level, not a rate; window axis is newest -> oldest).

    The ONE reduction both the full model build
    (LoadMonitor._window_reduced_loads, masked by aggregate validity) and
    the streaming delta path (reduce_complete_loads, masked by raw
    completeness) apply — a strategy change lands in both or neither.
    Rows with an all-False mask reduce to 0 mean / window-0 latest; the
    caller's usable/monitored mask decides what to do with them.
    """
    n = np.maximum(mask.sum(1), 1)[:, None]
    mean = (values * mask[..., None]).sum(1) / n  # [E, 4]
    first = np.argmax(mask, axis=1)  # newest masked window per entity
    latest = values[np.arange(values.shape[0]), first]  # [E, 4]
    loads = np.empty((values.shape[0], NUM_RESOURCES), np.float32)
    loads[:, Resource.CPU] = mean[:, 0]
    loads[:, Resource.NW_IN] = mean[:, 1]
    loads[:, Resource.NW_OUT] = mean[:, 2]
    loads[:, Resource.DISK] = latest[:, 3]
    return loads


def reduce_complete_loads(
    history: WindowedHistory, metric_def: MetricDef
) -> ReducedLoads:
    """Reduce a history snapshot to per-entity [4] loads over COMPLETE
    windows only (see module docstring for why partial windows are out)."""
    cols = _load_columns(metric_def)
    complete = history.complete  # [E, W]
    usable = complete.sum(1) > 0
    loads = reduce_windowed_loads(history.values[:, :, cols], complete)
    loads[~usable] = 0.0
    return ReducedLoads(
        entities=history.entities, loads=loads, usable=usable
    )


def extract_window_delta(
    prev: WindowedHistory,
    cur: WindowedHistory,
    metric_def: MetricDef,
    *,
    rtol: float = 1e-6,
    prev_reduced: ReducedLoads | None = None,
) -> WindowDelta:
    """Diff two snapshots of the SAME aggregator into a WindowDelta.

    `prev` must be the snapshot the consumer's device state was last
    synchronized to; `cur` the fresh one.  Entity ORDER may differ between
    snapshots (the aggregator interns new entities at the tail) — the diff
    joins on entity identity, not row position.  `prev_reduced` (the
    `reduced` field of the previous cycle's WindowDelta) skips re-reducing
    the prev snapshot.
    """
    prev_red = (
        prev_reduced
        if prev_reduced is not None and prev_reduced.entities == prev.entities
        else reduce_complete_loads(prev, metric_def)
    )
    cur_red = reduce_complete_loads(cur, metric_def)
    prev_rows = {e: i for i, e in enumerate(prev.entities)}
    cur_set = set(cur.entities)
    added = tuple(e for e in cur.entities if e not in prev_rows)
    removed = tuple(e for e in prev.entities if e not in cur_set)

    entities: list = []
    rows_cur: list[int] = []
    rows_prev: list[int] = []
    stale: list = []
    for i, e in enumerate(cur.entities):
        j = prev_rows.get(e)
        if j is None:
            continue  # new entity: reported via `added`
        if not cur_red.usable[i]:
            stale.append(e)  # no fully-sampled window yet: hold loads
            continue
        entities.append(e)
        rows_cur.append(i)
        rows_prev.append(j)
    if entities:
        loads = cur_red.loads[rows_cur]
        old = prev_red.loads[rows_prev]
        old_usable = prev_red.usable[rows_prev]
        scale = np.maximum(np.abs(old), np.abs(loads))
        changed = (np.abs(loads - old) > rtol * np.maximum(scale, 1e-12)).any(1)
        # entities unusable in PREV had no trusted baseline — treat as
        # changed so the device state converges to the first honest value
        changed |= ~old_usable
    else:
        loads = np.zeros((0, NUM_RESOURCES), np.float32)
        changed = np.zeros(0, bool)
    return WindowDelta(
        entities=tuple(entities),
        loads=loads.astype(np.float32),
        changed=changed,
        added=added,
        removed=removed,
        stale=tuple(stale),
        windows_advanced=int(cur.window_indices[0] - prev.window_indices[0]),
        reduced=cur_red,
    )
