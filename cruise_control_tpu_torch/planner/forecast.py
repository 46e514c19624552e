"""Per-topic load forecasting from the monitor's windowed history.

Fits a trend per (topic, resource) over the aggregator's completed
windows (WindowedMetricSampleAggregator.history_snapshot) and emits
future `Scenario`s whose topicLoadFactors scale today's model to the
projected load at a horizon.  Two fitters:

  linear  ordinary least squares over the valid windows — robust default
          for the handful of windows the monitor keeps
  holt    Holt's linear (double) exponential smoothing — weights recent
          windows harder, tracks level shifts faster

Forecast scenarios feed the same batched evaluator every other
hypothetical does: "traffic next week" is just one more Scenario in the
batch, and the rightsizer composes its broker-count sweeps on top of it.

The JAX package's planner/forecast.py, kept here as its own copy (pure
numpy).  `fit` duck-types the history: it reads `entities` (each with a
`topic`), `values` [E, W, M] newest window first, `complete` [E, W] and
`window_ms`, and `metric_def.metric_id(name)`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.planner.scenario import Scenario


@dataclasses.dataclass(frozen=True)
class TopicTrend:
    """Fitted per-resource trend of one topic's total load.

    level: projected value at the NEWEST observed window; slope: change
    per window step.  Both are [4] per-resource vectors over the model's
    consumed metrics (CPU, NW_IN, NW_OUT, DISK)."""

    topic: str
    level: np.ndarray  # f32[4]
    slope: np.ndarray  # f32[4]
    windows_observed: int

    def factors_at(self, horizon_windows: float, *, max_factor: float = 10.0) -> tuple:
        """Per-resource multiplicative factors projecting `level` forward
        `horizon_windows` window steps, clamped to [0, max_factor] (a fit
        on a few noisy windows must not 1000x a topic)."""
        base = np.maximum(self.level, 1e-9)
        pred = self.level + self.slope * horizon_windows
        f = np.clip(pred / base, 0.0, max_factor)
        # untrended / unobserved resources stay at 1.0 (a zero-load
        # resource projected to zero is "no change", not "erase it")
        f = np.where(self.level <= 0.0, 1.0, f)
        return tuple(float(x) for x in f)


def fit_linear(y: np.ndarray, valid: np.ndarray) -> tuple[float, float]:
    """OLS (level at the newest point, slope per step) over valid points.

    y is oldest -> newest.  Fewer than 2 valid points degenerate to a
    flat trend at the observed mean."""
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return 0.0, 0.0
    if idx.size == 1:
        return float(y[idx[0]]), 0.0
    x = idx.astype(np.float64)
    yy = y[idx].astype(np.float64)
    slope, intercept = np.polyfit(x, yy, 1)
    newest = y.size - 1
    return float(intercept + slope * newest), float(slope)


def fit_holt(
    y: np.ndarray, valid: np.ndarray, *, alpha: float = 0.5, beta: float = 0.3
) -> tuple[float, float]:
    """Holt's linear exponential smoothing over valid points (oldest ->
    newest); gaps are skipped (the smoothing state carries across)."""
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return 0.0, 0.0
    if idx.size == 1:
        return float(y[idx[0]]), 0.0
    level = float(y[idx[0]])
    trend = float(y[idx[1]] - y[idx[0]])
    prev = idx[0]
    for i in idx[1:]:
        steps = int(i - prev)
        forecast = level + trend * steps
        obs = float(y[i])
        new_level = alpha * obs + (1 - alpha) * forecast
        new_trend = beta * (new_level - level) / steps + (1 - beta) * trend
        level, trend = new_level, new_trend
        prev = i
    # roll the smoothed state forward to the newest window
    tail = int((y.size - 1) - prev)
    return level + trend * tail, trend


_FITTERS = {"linear": fit_linear, "holt": fit_holt}


class LoadForecaster:
    """Fits TopicTrends from a WindowedHistory and emits future Scenarios."""

    def __init__(
        self,
        *,
        method: str = "linear",
        min_windows: int = 3,
        max_factor: float = 10.0,
    ):
        if method not in _FITTERS:
            raise ValueError(f"unknown forecast method {method!r} (linear | holt)")
        self.method = method
        self.min_windows = min_windows
        self.max_factor = max_factor

    def fit(self, history, metric_def, topic_names: dict | None = None) -> list[TopicTrend]:
        """Per-topic trends from an aggregator WindowedHistory.

        Entities must be PartitionEntity-shaped (topic, partition) — the
        partition aggregator's layout; per-topic totals are the sum over
        the topic's partitions per window.  topic_names maps topic id ->
        display name (catalog.topic_names_by_id()); absent ids keep their
        numeric spelling so the scenario can resolve them without a
        catalog."""
        cols = [
            metric_def.metric_id("CPU_USAGE"),
            metric_def.metric_id("LEADER_BYTES_IN"),
            metric_def.metric_id("LEADER_BYTES_OUT"),
            metric_def.metric_id("DISK_USAGE"),
        ]
        E = len(history.entities)
        if E == 0:
            return []
        tids = np.fromiter(
            (int(getattr(e, "topic")) for e in history.entities), np.int64, count=E
        )
        uniq = np.unique(tids)
        # oldest -> newest for the fitters (history is newest-first)
        values = history.values[:, ::-1][:, :, cols]  # [E, W, 4]
        complete = history.complete[:, ::-1]  # [E, W]
        W = values.shape[1]
        trends = []
        for t in uniq:
            rows = tids == t
            # a window observes the topic when every partition reported a
            # complete cell — summing a half-sampled window would read as
            # a traffic drop and poison the slope
            vmask = complete[rows].all(axis=0)  # [W]
            if int(vmask.sum()) < self.min_windows:
                continue
            totals = values[rows].sum(axis=0)  # [W, 4]
            level = np.zeros(NUM_RESOURCES, np.float64)
            slope = np.zeros(NUM_RESOURCES, np.float64)
            fit = _FITTERS[self.method]
            for r in range(NUM_RESOURCES):
                level[r], slope[r] = fit(totals[:, r], vmask)
            name = (topic_names or {}).get(int(t), str(int(t)))
            trends.append(
                TopicTrend(
                    topic=name,
                    level=np.maximum(level, 0.0),
                    slope=slope,
                    windows_observed=int(vmask.sum()),
                )
            )
        return trends

    def scenario_at(
        self, trends: list[TopicTrend], horizon_ms: int, window_ms: int, *,
        name: str | None = None,
    ) -> Scenario:
        """One Scenario scaling each trended topic to its projected load
        `horizon_ms` from now."""
        steps = horizon_ms / max(window_ms, 1)
        factors = {
            tr.topic: tr.factors_at(steps, max_factor=self.max_factor)
            for tr in trends
        }
        return Scenario(
            name=name or f"forecast+{horizon_ms}ms",
            topic_load_factors=factors,
        )

    def scenarios(
        self, history, metric_def, horizons_ms, *, topic_names: dict | None = None
    ) -> list[Scenario]:
        trends = self.fit(history, metric_def, topic_names)
        return [
            self.scenario_at(trends, int(h), history.window_ms)
            for h in horizons_ms
        ]
