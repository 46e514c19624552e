"""Load monitor task runner — sampling/bootstrap/training scheduling.

Reference: monitor/task/LoadMonitorTaskRunner.java:33,56 (state machine
NOT_STARTED/RUNNING/SAMPLING/PAUSED/BOOTSTRAPPING/TRAINING/LOADING),
BootstrapTask.java (3 bootstrap modes: RANGE, SINCE, RECENT),
TrainingTask.java (feeds LinearRegressionModelParameters),
SampleLoadingTask.java (warm restart from the sample store).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from cruise_control_tpu_torch.monitor.cpu_model import LinearRegressionModelParameters
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor, MonitorState
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
from cruise_control_tpu_torch.monitor.sampling import MetricFetcherManager


class LoadMonitorTaskRunner:
    """Coordinates the sampling loop with one-shot bootstrap/train/load
    tasks, enforcing the reference's exclusive-state rules (a bootstrap
    cannot start while training, etc.)."""

    def __init__(
        self,
        monitor: LoadMonitor,
        fetcher: MetricFetcherManager,
        partitions_fn: Callable[[], list],
        *,
        window_ms: int,
        regression: LinearRegressionModelParameters | None = None,
        auto_train: bool = False,
    ):
        """auto_train (reference MonitorConfig use.linear.regression.model):
        harvest broker samples continuously and train the CPU regression
        as soon as its bucket coverage suffices — no explicit /train
        needed."""
        self.monitor = monitor
        self.fetcher = fetcher
        self.partitions_fn = partitions_fn
        self.window_ms = window_ms
        self.regression = regression or LinearRegressionModelParameters()
        self.auto_train = auto_train
        self._lock = threading.Lock()
        self._bootstrap_progress = 0.0
        self._harvested_until = 0
        self._harvest_lock = threading.Lock()
        self._auto_stop = threading.Event()
        self._auto_thread: threading.Thread | None = None

    # ------------------------------------------------------------------

    def _enter(self, state: MonitorState):
        with self._lock:
            if self.monitor.state in (
                MonitorState.BOOTSTRAPPING,
                MonitorState.TRAINING,
                MonitorState.LOADING,
            ):
                raise RuntimeError(f"monitor busy: {self.monitor.state.value}")
            self._prev_state = self.monitor.state
            self.monitor._state = state

    def _exit(self):
        with self._lock:
            self.monitor._state = self._prev_state

    # ------------------------------------------------------------------

    def start(self, *, interval_s: float | None = None):
        self.monitor.start()
        self.fetcher.start(self.partitions_fn, interval_s=interval_s)
        if self.auto_train and self._auto_thread is None:
            # a stop()/start() cycle must revive auto-training
            self._auto_stop.clear()
            tick = interval_s or self.window_ms / 1000.0

            def loop():
                while not self._auto_stop.wait(tick):
                    try:
                        self.maybe_auto_train()
                    except Exception:  # noqa: BLE001 — keep the loop alive
                        pass

            self._auto_thread = threading.Thread(
                target=loop, daemon=True, name="cpu-model-auto-train"
            )
            self._auto_thread.start()

    def stop(self):
        self._auto_stop.set()
        if self._auto_thread is not None:
            self._auto_thread.join(timeout=5)
            self._auto_thread = None
        self.fetcher.stop()

    def load_samples(self) -> int:
        """Warm restart (reference SampleLoadingTask)."""
        self._enter(MonitorState.LOADING)
        try:
            return self.fetcher.load_samples()
        finally:
            self._exit()

    def bootstrap_range(self, start_ms: int, end_ms: int, clear_metrics: bool = False) -> int:
        """RANGE bootstrap: replay samples for [start, end)
        (reference BootstrapTask RANGE mode; LoadMonitor.bootstrap:325-345)."""
        return self._bootstrap(start_ms, end_ms, clear_metrics)

    def bootstrap_since(self, start_ms: int, clear_metrics: bool = False) -> int:
        """SINCE bootstrap: from start to now."""
        return self._bootstrap(start_ms, int(time.time() * 1000), clear_metrics)

    def bootstrap_recent(self, clear_metrics: bool = True) -> int:
        """RECENT bootstrap: enough trailing windows to satisfy completeness."""
        now = int(time.time() * 1000)
        span = self.window_ms * (self.monitor.partition_aggregator.num_windows + 1)
        return self._bootstrap(now - span, now, clear_metrics)

    def _bootstrap(self, start_ms: int, end_ms: int, clear_metrics: bool) -> int:
        self._enter(MonitorState.BOOTSTRAPPING)
        try:
            if clear_metrics:
                agg = self.monitor.partition_aggregator
                fresh = type(agg)(
                    num_windows=agg.num_windows,
                    window_ms=agg.window_ms,
                    min_samples_per_window=agg.min_samples,
                    metric_def=agg.metric_def,
                )
                self.monitor.partition_aggregator = fresh
                self.fetcher.partition_aggregator = fresh
            total = 0
            parts = self.partitions_fn()
            # replay at most the windows the aggregation ring can retain —
            # older samples would immediately roll out again (reference
            # BootstrapTask replays only what the sample store covers)
            max_windows = self.monitor.partition_aggregator.num_windows + 1
            n_windows = max(1, min((end_ms - start_ms) // self.window_ms, max_windows))
            start_ms = max(start_ms, end_ms - n_windows * self.window_ms)
            for i in range(n_windows):
                w_start = start_ms + i * self.window_ms
                w_end = min(w_start + self.window_ms - 1, end_ms)
                total += self.fetcher.fetch_once(parts, w_start, w_end)
                self._bootstrap_progress = (i + 1) / n_windows
            return total
        finally:
            self._exit()

    def _harvest(self, start_ms: int, end_ms: int) -> int:
        """Feed broker windows inside [start_ms, end_ms) into the
        regression; returns the number of samples added.

        Windows at or below the watermark are ALWAYS skipped and the
        watermark always advances — the explicit /train path and the
        auto-train thread share one regression, and either re-harvesting
        the other's windows would double-count samples and skew the fit.
        Serialized by a lock for the same reason."""
        with self._harvest_lock:
            start_ms = max(start_ms, self._harvested_until)
            agg = self.fetcher.broker_aggregator
            if agg is None or not agg.num_entities():
                return 0
            try:
                res = agg.aggregate()
            except ValueError:  # no completed broker windows yet
                return 0
            m = KAFKA_METRIC_DEF
            added = 0
            for e_idx in range(res.values.shape[0]):
                for w in range(res.values.shape[1]):
                    if not res.window_valid[e_idx, w]:
                        continue
                    # NB: broker windows have their OWN span (reference
                    # broker.metrics.window.ms), not the partition span
                    # this runner was built with
                    w_start = int(res.window_indices[w]) * agg.window_ms
                    if not (start_ms <= w_start < end_ms):
                        continue
                    v = res.values[e_idx, w]
                    self.regression.add_sample(
                        float(v[m.metric_id("LEADER_BYTES_IN")]),
                        float(v[m.metric_id("LEADER_BYTES_OUT")]),
                        float(v[m.metric_id("REPLICATION_BYTES_IN_RATE")]),
                        float(v[m.metric_id("CPU_USAGE")]),
                    )
                    added += 1
                    self._harvested_until = max(
                        self._harvested_until, w_start + agg.window_ms
                    )
            return added

    def train(self, start_ms: int, end_ms: int) -> dict:
        """Reference TrainingTask: harvest (bytes-in, bytes-out, follower
        bytes-in, cpu) tuples from broker samples into the regression —
        restricted to windows inside [start_ms, end_ms) as requested
        (reference LoadMonitor.train:354 passes the range through).

        An explicit /train is an operator decision: it fits the model even
        when bucket coverage is below the auto-train gate (force=True)."""
        self._enter(MonitorState.TRAINING)
        try:
            self._harvest(start_ms, end_ms)
            trained = self.regression.train(force=True)
            return {"trained": trained, **self.regression.state()}
        finally:
            self._exit()

    def maybe_auto_train(self) -> bool:
        """Continuous training loop body (use.linear.regression.model):
        harvest only windows NEWER than the watermark (repeat harvesting
        would double-count and skew the fit), then train once the
        bucket-coverage gate passes."""
        if self.regression.trained:
            return True
        import time as _time

        self._harvest(self._harvested_until, int(_time.time() * 1000))
        if self.regression.ready_to_train():
            return self.regression.train()
        return False

    def state(self) -> dict:
        return {
            "monitorState": self.monitor.state.value,
            "bootstrapProgressPct": round(100.0 * self._bootstrap_progress, 1),
            "trainingState": self.regression.state(),
            "totalSamples": self.fetcher.total_samples,
        }
