"""Windowed metric sample aggregation — array-native rebuild of the core
aggregator.

Reference: cruise-control-core monitor/sampling/aggregator/
MetricSampleAggregator.java:84 (addSample:141-175, aggregate:193),
RawMetricValues.java (cyclic per-window buffers + extrapolation),
AggregationOptions/MetricSampleCompleteness (completeness math).

The reference keeps one RawMetricValues object per entity (HashMap of
cyclic float arrays, per-entity locks).  Here ALL entities share three
dense ring tensors:

    acc    f32[E, W, M]   per-window accumulated value per metric
    counts i16[E, W]      samples per window
    (ring axis W covers num_windows + 1; one slot is the in-progress
     "current" window, exactly like the reference's current window)

addSample is a vectorized scatter of a sample batch; aggregate() computes
validity, extrapolation, and completeness for every entity at once with
masked array ops instead of per-entity walks.  At LinkedIn scale
(SURVEY §3.2: millions of samples per window) this is the difference
between a hash-map hot loop and a handful of numpy kernels; the output
tensor feeds the ClusterState builder directly.

Extrapolation semantics (reference Extrapolation.java, preference order):
  NONE                 count >= min_samples
  AVG_AVAILABLE        min_samples > count >= max(1, min_samples/2)
  AVG_ADJACENT         count == 0, both neighbor windows have full samples
  FORCED_INSUFFICIENT  count >= 1
  NO_VALID_EXTRAPOLATION  otherwise (window invalid for the entity)
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from cruise_control_tpu_torch.monitor.metricdef import MetricDef, ValueComputingStrategy


class Extrapolation:
    """Per-(entity, window) extrapolation codes (reference Extrapolation.java)."""

    NONE = 0
    AVG_AVAILABLE = 1
    AVG_ADJACENT = 2
    FORCED_INSUFFICIENT = 3
    NO_VALID_EXTRAPOLATION = 4


@dataclasses.dataclass(frozen=True)
class AggregationOptions:
    """Reference AggregationOptions.java (granularity ENTITY vs ENTITY_GROUP)."""

    min_valid_entity_ratio: float = 0.95
    min_valid_entity_group_ratio: float = 0.0
    min_valid_windows: int = 1
    #: max windows an entity may cover via extrapolation and stay valid
    #: (reference MetricSampleAggregator._maxAllowedExtrapolationsPerEntity)
    max_allowed_extrapolations_per_entity: int = 5
    #: "ENTITY" or "ENTITY_GROUP": group granularity invalidates a whole
    #: group (= topic) when any member entity is invalid
    granularity: str = "ENTITY"


@dataclasses.dataclass(frozen=True)
class MetricSampleCompleteness:
    """Reference MetricSampleCompleteness.java."""

    generation: int
    valid_windows: np.ndarray  # i64[Wv] window indices that passed the ratio checks
    valid_entity_ratio_by_window: np.ndarray  # f32[Wv]
    valid_entity_ratio: float
    valid_entity_group_ratio: float


@dataclasses.dataclass(frozen=True)
class AggregationResult:
    """Reference ValuesAndExtrapolations + completeness, for all entities.

    values[e, w, m] is the aggregated metric value of entity e in (valid)
    window w; entity_valid marks entities meeting the options' criteria.
    """

    window_indices: np.ndarray  # i64[Wv] newest -> oldest
    values: np.ndarray  # f32[E, Wv, M]
    window_valid: np.ndarray  # bool[E, Wv]
    extrapolation: np.ndarray  # i8[E, Wv]
    entity_valid: np.ndarray  # bool[E]
    completeness: MetricSampleCompleteness


@dataclasses.dataclass(frozen=True)
class WindowedHistory:
    """Read-only snapshot of the aggregator's completed windows.

    The forecaster's (planner/forecast.py) input contract: per-entity
    per-window aggregated values plus a completeness mask, WITHOUT the
    extrapolation/validity policy aggregate() layers on top — a trend fit
    wants raw observations and an honest "this cell was sampled" bit, and
    it must not reach into the ring buffers (`_acc`/`_roll_to` slots are
    private and move under the lock).
    """

    window_indices: np.ndarray  # i64[Wv] newest -> oldest
    window_ms: int
    values: np.ndarray  # f32[E, Wv, M] per-window values (strategy-reduced)
    sample_counts: np.ndarray  # i32[E, Wv] samples behind each cell
    complete: np.ndarray  # bool[E, Wv] cell met min_samples (no extrapolation)
    entities: tuple  # row order of the E axis
    generation: int


class WindowedMetricSampleAggregator:
    """Dense ring-buffer aggregator over a dynamic entity set.

    Entities are interned to dense row ids on first sample (reference keys
    by Entity objects; our entity keys are any hashable, typically
    (topic_id, partition_id) or broker_id).  Entity groups (topic) support
    ENTITY_GROUP granularity completeness.
    """

    def __init__(
        self,
        num_windows: int,
        window_ms: int,
        min_samples_per_window: int,
        metric_def: MetricDef,
        *,
        initial_capacity: int = 1024,
    ):
        if num_windows < 1:
            raise ValueError("need at least one available window")
        self.num_windows = num_windows
        self.window_ms = window_ms
        self.min_samples = max(1, min_samples_per_window)
        self.half_min = max(1, min_samples_per_window // 2)
        self.metric_def = metric_def
        self._M = metric_def.num_metrics
        self._W = num_windows + 1  # + current window
        self._strategies = np.array(
            [
                {"avg": 0, "max": 1, "latest": 2}[m.strategy.value]
                for m in metric_def.all_infos()
            ],
            np.int8,
        )
        self._lock = threading.RLock()
        self._entity_rows: dict = {}
        self._entity_group: dict = {}  # entity key -> group key
        self._capacity = initial_capacity
        self._acc = np.zeros((initial_capacity, self._W, self._M), np.float32)
        self._latest_ts = np.full((initial_capacity, self._W, self._M), -1, np.int64)
        self._counts = np.zeros((initial_capacity, self._W), np.int32)
        self._current_window: int | None = None  # window index (time//window_ms)
        self._oldest_window: int | None = None
        self._generation = 0

    # ------------------------------------------------------------------

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def current_window_index(self) -> int | None:
        return self._current_window

    def num_entities(self) -> int:
        return len(self._entity_rows)

    def _row(self, entity) -> int:
        row = self._entity_rows.get(entity)
        if row is None:
            row = len(self._entity_rows)
            if row >= self._capacity:
                self._grow(max(2 * self._capacity, row + 1))
            self._entity_rows[entity] = row
            self._generation += 1
        return row

    def _grow(self, new_cap: int):
        for name in ("_acc", "_latest_ts", "_counts"):
            old = getattr(self, name)
            new = np.zeros((new_cap, *old.shape[1:]), old.dtype)
            if name == "_latest_ts":
                new[...] = -1
            new[: old.shape[0]] = old
            setattr(self, name, new)
        self._capacity = new_cap

    def _slot(self, window_index: int) -> int:
        return window_index % self._W

    def _roll_to(self, window_index: int):
        """Advance the current window, clearing slots that get recycled
        (reference RawMetricValues window rolling / WindowIndexedArrays)."""
        if self._current_window is None:
            self._current_window = window_index
            self._oldest_window = window_index
            return
        if window_index <= self._current_window:
            return
        if window_index - self._current_window >= self._W:
            # the jump recycles every slot (e.g. bootstrap after a long gap):
            # clear the whole ring at once instead of window-by-window
            self._acc[:] = 0.0
            self._latest_ts[:] = -1
            self._counts[:] = 0
        else:
            for w in range(self._current_window + 1, window_index + 1):
                slot = self._slot(w)
                self._acc[:, slot] = 0.0
                self._latest_ts[:, slot] = -1
                self._counts[:, slot] = 0
        self._current_window = window_index
        self._oldest_window = max(
            self._oldest_window or 0, window_index - self.num_windows
        )
        self._generation += 1

    # ------------------------------------------------------------------

    def add_sample(self, entity, time_ms: int, values, group=None) -> bool:
        """Add one sample (reference MetricSampleAggregator.addSample:141).

        values: f32[M] (metric-id indexed) or dict name->value.
        Returns False if the sample is too old (its window already rolled out).
        """
        with self._lock:
            if isinstance(values, dict):
                arr = np.zeros(self._M, np.float32)
                for k, v in values.items():
                    arr[self.metric_def.metric_id(k)] = v
                values = arr
            else:
                values = np.asarray(values, np.float32)
            w = time_ms // self.window_ms
            if self._current_window is None or w > self._current_window:
                self._roll_to(w)
            if w < (self._oldest_window or 0):
                return False  # too old (reference rejects samples out of range)
            row = self._row(entity)
            if group is not None:
                self._entity_group[entity] = group
            slot = self._slot(w)
            avg = self._strategies == 0
            mx = self._strategies == 1
            latest = self._strategies == 2
            self._acc[row, slot, avg] += values[avg]
            if self._counts[row, slot] == 0:
                self._acc[row, slot, mx] = values[mx]
            else:
                self._acc[row, slot, mx] = np.maximum(self._acc[row, slot, mx], values[mx])
            newer = time_ms >= self._latest_ts[row, slot, latest]
            lat_ids = np.nonzero(latest)[0][newer]
            self._acc[row, slot, lat_ids] = values[lat_ids]
            self._latest_ts[row, slot, lat_ids] = time_ms
            self._counts[row, slot] += 1
            return True

    def add_samples_batch(self, entities: list, times_ms: np.ndarray, values: np.ndarray, groups=None):
        """Bulk add (the metrics-reporter consumer path at scale)."""
        for i, e in enumerate(entities):
            self.add_sample(e, int(times_ms[i]), values[i], None if groups is None else groups[i])

    def add_samples_columnar(
        self, entities: list, time_ms: int, values: np.ndarray, groups=None
    ) -> bool:
        """Vectorized add of one sample per entity, all stamped time_ms.

        The scale path for a sampler that drains a whole fetch window at
        once: per-strategy accumulation runs as array ops (np.add.at /
        np.maximum.at honor duplicate entities exactly like repeated
        add_sample calls).  values: f32[N, M].  Returns False when the
        window already rolled out.
        """
        with self._lock:
            values = np.asarray(values, np.float32)
            w = time_ms // self.window_ms
            if self._current_window is None or w > self._current_window:
                self._roll_to(w)
            if w < (self._oldest_window or 0):
                return False
            rows = np.fromiter(
                (self._row(e) for e in entities), np.int64, count=len(entities)
            )
            if groups is not None:
                for e, g in zip(entities, groups):
                    self._entity_group[e] = g
            slot = self._slot(w)
            acc = self._acc[:, slot]  # [cap, M] view
            counts = self._counts[:, slot]
            avg_ids = np.nonzero(self._strategies == 0)[0]
            mx_ids = np.nonzero(self._strategies == 1)[0]
            lat_ids = np.nonzero(self._strategies == 2)[0]
            # MAX: rows at count 0 take the incoming value, so seed them
            # with -inf before the running maximum
            fresh = rows[counts[rows] == 0]
            if mx_ids.size:
                acc[np.ix_(fresh, mx_ids)] = -np.inf
                np.maximum.at(acc, (rows[:, None], mx_ids[None, :]), values[:, mx_ids])
            if avg_ids.size:
                np.add.at(acc, (rows[:, None], avg_ids[None, :]), values[:, avg_ids])
            if lat_ids.size:
                ts = self._latest_ts[:, slot]
                newer = time_ms >= ts[np.ix_(rows, lat_ids)]
                # plain fancy assignment: later duplicates win, like the
                # per-sample path's >= check at equal timestamps
                upd = np.where(newer, values[:, lat_ids], acc[np.ix_(rows, lat_ids)])
                acc[np.ix_(rows, lat_ids)] = upd
                ts[np.ix_(rows, lat_ids)] = np.where(
                    newer, time_ms, ts[np.ix_(rows, lat_ids)]
                )
            np.add.at(counts, rows, 1)
            return True

    # ------------------------------------------------------------------

    def aggregate(self, options: AggregationOptions | None = None) -> AggregationResult:
        """Aggregate all completed windows (reference aggregate:193).

        Vectorized: one pass computes per-(entity, window) validity +
        extrapolation, per-window entity ratios, per-entity validity, and
        group validity.
        """
        options = options or AggregationOptions()
        with self._lock:
            if self._current_window is None:
                raise ValueError("no samples added yet")
            E = len(self._entity_rows)
            newest = self._current_window - 1  # exclude in-progress window
            oldest = max(self._oldest_window or 0, newest - self.num_windows + 1)
            if newest < oldest:
                raise ValueError("no completed windows yet")
            widx = np.arange(newest, oldest - 1, -1, np.int64)  # newest -> oldest
            slots = widx % self._W
            # fancy indexing yields a fresh array — safe to mutate in place
            # (no second copy; at reference scale these are ~100MB tensors)
            values = self._acc[:E][:, slots]  # [E, Wv, M]
            counts = self._counts[:E][:, slots]  # [E, Wv]

            # window values by strategy.  AVG dominates the metric def
            # (35/36 Kafka metrics), so divide the WHOLE tensor in place and
            # restore the few non-AVG columns — a full-array op beats a
            # fancy gather+scatter over nearly all columns at 200k entities
            avg = self._strategies == 0
            nonavg = np.nonzero(~avg)[0]
            saved = values[:, :, nonavg].copy()
            with np.errstate(invalid="ignore", divide="ignore"):
                values /= np.maximum(counts[..., None], 1)
            values[:, :, nonavg] = saved

            if (counts >= self.min_samples).all():
                # healthy fast path — every (entity, window) cell fully
                # sampled, the steady-state norm: no extrapolation masks,
                # no neighbor machinery.  At 200k entities this skips
                # ~1/3 of the aggregation wall (the reference's
                # cluster-model-creation-timer path,
                # monitor/LoadMonitor.java:100,510)
                ext = np.full((E, widx.size), Extrapolation.NONE, np.int8)
                window_valid = np.ones((E, widx.size), bool)
                entity_valid = np.ones(E, bool)
            else:
                ext = np.full(
                    (E, widx.size), Extrapolation.NO_VALID_EXTRAPOLATION, np.int8
                )
                ext[counts >= 1] = Extrapolation.FORCED_INSUFFICIENT
                # AVG_ADJACENT: zero-count window whose neighbors (in
                # window-index space) both have >= min_samples
                cnt_full = self._counts[:E]  # ring layout
                left = np.clip(widx + 1, 0, None)  # newer neighbor
                right = widx - 1
                left_ok = np.zeros((E, widx.size), bool)
                right_ok = np.zeros((E, widx.size), bool)
                in_range = (left <= self._current_window)
                left_ok[:, in_range] = cnt_full[:, (left[in_range]) % self._W] >= self.min_samples
                in_range_r = right >= oldest
                right_ok[:, in_range_r] = cnt_full[:, (right[in_range_r]) % self._W] >= self.min_samples
                adj = (counts == 0) & left_ok & right_ok
                ext[adj] = Extrapolation.AVG_ADJACENT
                # fill adjacent-average values
                if adj.any():
                    e_i, w_i = np.nonzero(adj)
                    lv = self._acc[:E][e_i, (widx[w_i] + 1) % self._W]
                    lc = cnt_full[e_i, (widx[w_i] + 1) % self._W]
                    rv = self._acc[:E][e_i, (widx[w_i] - 1) % self._W]
                    rc = cnt_full[e_i, (widx[w_i] - 1) % self._W]
                    lval = lv.copy()
                    rval = rv.copy()
                    lval[:, avg] = lv[:, avg] / np.maximum(lc[:, None], 1)
                    rval[:, avg] = rv[:, avg] / np.maximum(rc[:, None], 1)
                    values[e_i, w_i] = 0.5 * (lval + rval)
                ext[counts >= self.half_min] = Extrapolation.AVG_AVAILABLE
                ext[counts >= self.min_samples] = Extrapolation.NONE

                window_valid = ext != Extrapolation.NO_VALID_EXTRAPOLATION
                extrapolated = window_valid & (ext != Extrapolation.NONE)
                too_many_ext = (
                    extrapolated.sum(1)
                    > options.max_allowed_extrapolations_per_entity
                )
                entity_valid = window_valid.all(axis=1) & ~too_many_ext

            # group validity: all entities of the group must be valid.
            # The hash pass over E entities only runs when group
            # granularity is requested — the default ENTITY path skips it
            entity_group_valid = entity_valid
            if options.granularity == "ENTITY_GROUP":
                keys = list(self._entity_rows)
                group_of = np.fromiter(
                    (hash(self._entity_group.get(k, k)) for k in keys),
                    np.int64,
                    count=len(keys),
                )
                _, inv = np.unique(group_of, return_inverse=True)
                bad_groups = np.bincount(inv, weights=~entity_valid) > 0
                entity_group_valid = entity_valid & ~bad_groups[inv]
                entity_valid = entity_group_valid

            ratio_by_window = window_valid.mean(axis=0) if E else np.zeros(widx.size)
            ratio_ok = ratio_by_window >= options.min_valid_entity_ratio
            valid_windows = widx[ratio_ok]
            if valid_windows.size < options.min_valid_windows:
                pass  # caller decides via completeness (reference throws NotEnoughValidWindowsException)

            completeness = MetricSampleCompleteness(
                generation=self._generation,
                valid_windows=valid_windows,
                valid_entity_ratio_by_window=ratio_by_window.astype(np.float32),
                valid_entity_ratio=float(entity_valid.mean()) if E else 0.0,
                valid_entity_group_ratio=float(entity_group_valid.mean()) if E else 0.0,
            )
            return AggregationResult(
                window_indices=widx,
                values=values,
                window_valid=window_valid,
                extrapolation=ext,
                entity_valid=entity_valid,
                completeness=completeness,
            )

    def history_snapshot(self) -> WindowedHistory:
        """Windowed-history snapshot for trend fitting (WindowedHistory).

        Covers every COMPLETED window still in the ring (the in-progress
        current window is excluded, like aggregate()), newest first.
        Values are strategy-reduced (AVG divided by count, MAX/LATEST as
        stored) but NOT extrapolated; `complete` marks cells that met
        min_samples on their own.  All arrays are copies — safe to hold
        across further sampling and window rolls.
        """
        with self._lock:
            if self._current_window is None:
                raise ValueError("no samples added yet")
            E = len(self._entity_rows)
            newest = self._current_window - 1
            oldest = max(self._oldest_window or 0, newest - self.num_windows + 1)
            if newest < oldest:
                raise ValueError("no completed windows yet")
            widx = np.arange(newest, oldest - 1, -1, np.int64)
            slots = widx % self._W
            values = self._acc[:E][:, slots].copy()  # [E, Wv, M]
            counts = self._counts[:E][:, slots].copy()  # [E, Wv]
            avg = self._strategies == 0
            nonavg = np.nonzero(~avg)[0]
            saved = values[:, :, nonavg].copy()
            with np.errstate(invalid="ignore", divide="ignore"):
                values /= np.maximum(counts[..., None], 1)
            values[:, :, nonavg] = saved
            return WindowedHistory(
                window_indices=widx,
                window_ms=self.window_ms,
                values=values,
                sample_counts=counts.astype(np.int32),
                complete=counts >= self.min_samples,
                entities=tuple(self._entity_rows),
                generation=self._generation,
            )

    def entities(self) -> list:
        return list(self._entity_rows)

    def entity_index(self) -> dict:
        return dict(self._entity_rows)

    def entity_key_rows(self) -> tuple:
        """(sorted int64 keys, matching rows) for vectorized entity lookup.

        Keys encode (entity.topic << 32) | entity.partition — the
        partition-entity layout the monitor's columnar model-generation
        path joins against with np.searchsorted instead of E dict probes.
        Non-partition entities are rejected loudly (a silent key collision
        would join wrong loads).  Cached until the entity set grows.
        """
        with self._lock:  # sample ingestion grows the dict concurrently
            cached = getattr(self, "_key_rows_cache", None)
            if cached is not None and cached[0] == len(self._entity_rows):
                return cached[1]

            def _key(e) -> int:
                # loud failure beats colliding join keys: a non-partition
                # entity or out-of-range id here would silently join wrong
                # loads via the old getattr-default fallback
                topic = getattr(e, "topic", None)
                part = getattr(e, "partition", None)
                if topic is None or part is None:
                    raise TypeError(
                        "entity_key_rows requires PartitionEntity-shaped "
                        f"entities (topic, partition); got {type(e).__name__}"
                    )
                topic, part = int(topic), int(part)
                if not (0 <= part < 2**32 and 0 <= topic < 2**31):
                    raise ValueError(
                        f"partition entity ids out of key range: "
                        f"topic={topic} partition={part}"
                    )
                return (topic << 32) | part

            keys = np.fromiter(
                (_key(e) for e in self._entity_rows),
                np.int64,
                count=len(self._entity_rows),
            )
            rows = np.fromiter(self._entity_rows.values(), np.int64, count=keys.size)
            order = np.argsort(keys)
            out = (keys[order], rows[order])
            self._key_rows_cache = (len(self._entity_rows), out)
            return out
