"""Observability sensors: counters, gauges, timers, meters in one registry.

The JAX package's common/sensors.py, standard library only.  The analog
of the reference's Dropwizard MetricRegistry published under the
`kafka.cruisecontrol` JMX domain (reference
KafkaCruiseControlApp.java:39-41; sensor catalog docs/wiki/User
Guide/Sensors.md:1-17).  There is no JVM/JMX here: sensors are plain
thread-safe Python objects snapshotted into the `/state` JSON (substate
`sensors`), which is how the service is scraped.

Headline sensors (same semantics as the reference catalog):
  * analyzer.proposal-computation-timer  (GoalOptimizer.java:116,155)
  * monitor.cluster-model-creation-timer (LoadMonitor.java:100,510)
  * executor.execution-started / -stopped, per-mode gauges
    (Executor.java:118-125,257)
  * anomaly-detector per-type rates + mean-time-between-anomalies
    (detector/AnomalyMetrics.java:1, MeanTimeBetweenAnomaliesMs.java:1)
  * analyzer.supervisor.* — supervised optimizer runtime: breaker-state
    gauge (0 closed / 0.5 half-open / 1 open), per-class device failure
    counters (hang/compile/oom/transient), retry + probe counters; plus
    analyzer.degraded-proposals for CPU-greedy-served results (no
    reference analog — the reference has no accelerator to lose; see
    docs/sensors.md "Ops note: degraded-mode gauges")
  * executor.recovery.* — crash-safe execution: journal reconciliation
    counters (executions-recovered, tasks-{completed,readopted,
    resubmitted}, throttles-swept, reservations-restored)
  * executor.reaper.stuck-task / .rollback — stuck-move reaper actions
  * executor.adaptive.{backoff,recovery} counters +
    executor.adaptive.inter-broker-cap gauge — load-aware adaptive
    concurrency (reference ConcurrencyAdjuster)
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable


class Counter:
    """Monotonic event count."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    @property
    def count(self) -> int:
        # read under the lock: a bare int read is atomic in CPython today,
        # but `inc` is a read-modify-write and the exposition scrape reads
        # concurrently with every component thread — take the lock so the
        # monotonic-counter contract holds by construction, not by
        # interpreter accident
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        return {"type": "counter", "count": self.count}


class Gauge:
    """Point-in-time value; either set explicitly or computed by a callback."""

    def __init__(self, fn: Callable[[], float] | None = None) -> None:
        self._fn = fn
        self._value: float = 0.0

    def set(self, value: float) -> None:
        self._value = value

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Timer:
    """Duration statistics with a bounded sample window for percentiles."""

    def __init__(self, window: int = 256) -> None:
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._min = float("inf")
        self._max = 0.0
        self._samples: deque[float] = deque(maxlen=window)

    def update(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            self._min = min(self._min, seconds)
            self._max = max(self._max, seconds)
            self._samples.append(seconds)

    def time(self) -> "_TimerContext":
        return _TimerContext(self)

    @property
    def count(self) -> int:
        # same locked-reader contract as Counter.count: `update` writes
        # count/total/min/max as a group, so a reader must not interleave
        with self._lock:
            return self._count

    def total_seconds(self) -> float:
        with self._lock:
            return self._total

    def quantiles(self) -> dict[float, float]:
        """{quantile: seconds} over the bounded sample window — the
        Prometheus summary exposition's source (empty before any update)."""
        with self._lock:
            if not self._samples:
                return {}
            ordered = sorted(self._samples)

            def pct(p: float) -> float:
                return ordered[min(len(ordered) - 1, int(p * len(ordered)))]

            return {0.5: pct(0.50), 0.95: pct(0.95), 0.99: pct(0.99)}

    def snapshot(self) -> dict:
        with self._lock:
            if not self._count:
                return {"type": "timer", "count": 0}
            ordered = sorted(self._samples)

            def pct(p: float) -> float:
                return ordered[min(len(ordered) - 1, int(p * len(ordered)))]

            return {
                "type": "timer",
                "count": self._count,
                "meanMs": 1e3 * self._total / self._count,
                "minMs": 1e3 * self._min,
                "maxMs": 1e3 * self._max,
                "p50Ms": 1e3 * pct(0.50),
                "p95Ms": 1e3 * pct(0.95),
                "p99Ms": 1e3 * pct(0.99),
            }


class _TimerContext:
    def __init__(self, timer: Timer) -> None:
        self._timer = timer

    def __enter__(self) -> "_TimerContext":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._timer.update(time.monotonic() - self._t0)


class Meter:
    """Event rate + mean inter-arrival time (the MTBA sensor's shape:
    reference detector/MeanTimeBetweenAnomaliesMs.java).

    Inter-arrival math rides an injected MONOTONIC clock (default
    time.monotonic): a backwards NTP step must not produce a negative
    mean-time-between or an absurd rate spike.  Wall-clock stamps are kept
    separately, for display only (`lastEventMs` in the snapshot)."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        *,
        wall: Callable[[], float] = time.time,
    ) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self._wall = wall
        self._count = 0
        self._first: float | None = None
        self._last: float | None = None
        self._last_wall_ms: int | None = None

    def mark(self, n: int = 1) -> None:
        with self._lock:
            now = self._clock()
            self._count += n
            if self._first is None:
                self._first = now
            self._last = now
            self._last_wall_ms = int(self._wall() * 1000)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def mean_time_between_ms(self) -> float:
        """Mean time between events; inf until two events were seen."""
        with self._lock:
            if self._count < 2 or self._first is None or self._last is None:
                return float("inf")
            span = self._last - self._first
            return 1e3 * span / (self._count - 1)

    def rate_per_hour(self) -> float:
        with self._lock:
            # a single event carries no rate information; a tiny span right
            # after it would report an absurd spike (same count>=2 guard as
            # mean_time_between_ms)
            if self._count < 2 or self._first is None:
                return 0.0
            span = max(self._clock() - self._first, 1.0)
            return 3600.0 * self._count / span

    def snapshot(self) -> dict:
        mtb = self.mean_time_between_ms()
        return {
            "type": "meter",
            "count": self.count,
            "ratePerHour": self.rate_per_hour(),
            "meanTimeBetweenMs": (None if mtb == float("inf") else mtb),
            "lastEventMs": self._last_event_wall_ms(),
        }

    def _last_event_wall_ms(self) -> int | None:
        with self._lock:
            return self._last_wall_ms


#: default Histogram boundaries: latency-shaped seconds buckets spanning
#: the service's realistic range (5ms model builds to 5-minute compiles)
DEFAULT_HISTOGRAM_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0,
)


class Histogram:
    """Fixed-boundary histogram with exportable cumulative buckets — the
    sensor type the Prometheus exposition needs (a Timer's bounded sample
    window yields quantiles, but quantiles cannot be aggregated across
    instances; buckets can).

    `observe` optionally takes an EXEMPLAR — a small label dict (by
    convention `{"trace_id": ...}`) naming one concrete observation that
    landed in that bucket.  The OpenMetrics exposition renders the latest
    exemplar per bucket, which is how a p99 outlier on a latency panel
    links straight to its `/trace` replay."""

    def __init__(self, buckets=DEFAULT_HISTOGRAM_BUCKETS) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket boundary")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"duplicate histogram boundaries: {bounds}")
        self._lock = threading.Lock()
        self.bounds = bounds
        # per-bucket (non-cumulative) counts; last slot is the +Inf bucket
        self._counts = [0] * (len(bounds) + 1)
        # latest exemplar per bucket: (value, labels, wall_ts) or None
        self._exemplars: list = [None] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        import bisect

        i = bisect.bisect_left(self.bounds, float(value))
        with self._lock:
            self._counts[i] += 1
            self._sum += float(value)
            self._count += 1
            if exemplar:
                self._exemplars[i] = (float(value), dict(exemplar), time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def cumulative(self) -> tuple[list[tuple[float, int]], float, int]:
        """([(upper_bound, cumulative_count)...incl +Inf], sum, count) —
        the exposition's `_bucket{le=...}` series, precomputed atomically."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        cum = []
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            cum.append((bound, running))
        cum.append((float("inf"), running + counts[-1]))
        return cum, total, n

    def exemplars(self) -> list:
        """[(upper_bound, value, labels, wall_ts)] for buckets holding an
        exemplar, ordered like `cumulative()`'s ladder (+Inf last)."""
        with self._lock:
            ex = list(self._exemplars)
        bounds = list(self.bounds) + [float("inf")]
        return [
            (bounds[i], v, labels, ts)
            for i, e in enumerate(ex)
            if e is not None
            for (v, labels, ts) in (e,)
        ]

    def quantile(self, q: float) -> float:
        """Prometheus-style `histogram_quantile`: linear interpolation
        within the bucket the q-th observation falls in (the +Inf bucket
        answers its lower bound — the largest finite boundary).  NaN
        before any observation."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        cum, _total, n = self.cumulative()
        if n == 0:
            return float("nan")
        rank = q * n
        prev_bound, prev_count = 0.0, 0
        for bound, c in cum:
            if c >= rank:
                if bound == float("inf"):
                    return prev_bound  # unbounded bucket: report its floor
                if c == prev_count:
                    return bound
                frac = (rank - prev_count) / (c - prev_count)
                return prev_bound + (bound - prev_bound) * frac
            prev_bound, prev_count = (bound if bound != float("inf") else prev_bound), c
        return prev_bound

    def snapshot(self) -> dict:
        cum, total, n = self.cumulative()
        return {
            "type": "histogram",
            "count": n,
            "sum": round(total, 6),
            "buckets": [
                {"le": ("+Inf" if b == float("inf") else b), "count": c}
                for b, c in cum
            ],
        }


class Collector:
    """Labeled multi-value callback gauge: `fn() -> [(labels, value), ...]`
    with labels a {name: str} dict.  The JSON snapshot and the Prometheus
    exposition both read it at scrape time; per-device memory and
    per-bucket compile attribution ride this instead of minting one sensor
    NAME per device/bucket (names are a documented, drift-tested catalog —
    label values are data)."""

    def __init__(self, fn: Callable[[], list]) -> None:
        self._fn = fn

    def values(self) -> list[tuple[dict, float]]:
        try:
            return [(dict(labels), float(v)) for labels, v in self._fn()]
        except Exception:  # noqa: BLE001 — a failing callback yields no series
            return []

    def snapshot(self) -> dict:
        return {
            "type": "collector",
            "values": [
                {"labels": labels, "value": v} for labels, v in self.values()
            ],
        }


class SensorRegistry:
    """Named sensor catalog; `snapshot()` renders the /state JSON block.

    base_labels: label set stamped onto EVERY sample this registry emits
    in the Prometheus exposition (common/exposition.py) — the fleet
    controller gives each cluster its own registry labeled
    `{cluster: <id>}` so two clusters registering the same sensor family
    stay distinct series instead of last-writer-wins colliding on one
    name.  The JSON snapshot is unlabeled (each registry is already
    scoped to one cluster's /state)."""

    def __init__(self, base_labels: dict[str, str] | None = None) -> None:
        self._lock = threading.Lock()
        self._sensors: dict[str, object] = {}
        self.base_labels: dict[str, str] = dict(base_labels or {})

    def _get(self, name: str, factory):
        with self._lock:
            s = self._sensors.get(name)
            if s is None:
                s = factory()
                self._sensors[name] = s
            return s

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, fn: Callable[[], float] | None = None) -> Gauge:
        g = self._get(name, lambda: Gauge(fn))
        if fn is not None:
            g._fn = fn
        return g

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(
            name,
            (lambda: Histogram(buckets)) if buckets is not None else Histogram,
        )

    def collector(self, name: str, fn: Callable[[], list] | None = None) -> Collector:
        c = self._get(name, lambda: Collector(fn or (lambda: [])))
        if fn is not None:
            c._fn = fn  # re-registration rebinds, like gauge callbacks
        return c

    def get(self, name: str):
        """The sensor registered under `name`, or None — WITHOUT
        creating one (readers like the /fleet rollup must not mint a
        default-boundary histogram the real producer would then be
        stuck with)."""
        with self._lock:
            return self._sensors.get(name)

    def items(self) -> list[tuple[str, object]]:
        """Stable (name, sensor) listing — the exposition iterates this."""
        with self._lock:
            return sorted(self._sensors.items())

    def snapshot(self) -> dict:
        return {name: s.snapshot() for name, s in self.items()}


#: process-wide default registry (components accept an override for tests)
REGISTRY = SensorRegistry()
