"""Declarative SLO registry with multi-window burn-rate alerting.

The service grew real service-level objectives one PR at a time — a
per-cluster proposal-freshness SLO the device scheduler derives deadlines
from (`fleet.scheduler.freshness.slo.s`), a cold-start-to-first-proposal
budget (the restart SLO), a sub-second streaming publish target
(ROADMAP item 4) and the urgent queue-wait bound — but each was only a
gate in `bench.py`.  This module makes them continuously evaluated,
observable objects: a registry of `SloSpec`s fed good/bad events (or
sampled by a probe), computing ERROR-BUDGET BURN RATES over a fast and a
slow window (the multiwindow-multi-burn-rate pattern from the SRE
workbook: the fast window catches a new fire quickly, the slow window
keeps one noisy sample from paging), and raising one alert-only
`SLO_BURN` anomaly per breach episode through the detector/notifier —
the same episode discipline as `FLEET_OVERLOAD`.

Burn rate: over a window, `burn = bad_fraction / error_budget` where
`error_budget = 1 - objective`.  Burn 1.0 consumes the budget exactly at
the sustainable rate; the registry alerts when BOTH windows' burn
reaches `burn_threshold` — a sustained breach, not a blip.

Surfaces: `GET /slo` (per-SLO burn rates, compliance, episode state),
the `/fleet` per-cluster rollup, and Prometheus gauges via the labeled
`slo.burn-rate` / `slo.compliance` collectors on the owning registry's
sensor catalog.

Event storage is time-bucketed (fixed `_BUCKETS` buckets spanning the
slow window), so a high-rate SLO costs O(1) memory and burn evaluation
is O(buckets), never O(events).  All clocks are injectable — the
episode tests drive hours of breach in milliseconds.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable

log = logging.getLogger(__name__)

#: time buckets spanning the slow window (fast-window reads use the
#: suffix); 60 keeps fast-window resolution at slow/60 — with the
#: default 1 h slow window, one bucket per minute
_BUCKETS = 60


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One service-level objective.

    `objective` is the target good fraction (0.99 = 1% error budget).
    `probe` (optional) is sampled on every `tick()`: True = good sample,
    False = bad, None = no data right now (skipped — a service with no
    published proposal yet is not breaching its freshness SLO).  Without
    a probe the SLO is event-fed via `SloRegistry.record`."""

    name: str
    description: str
    objective: float
    probe: Callable[[], bool | None] | None = None
    #: the measurable the objective bounds (shown in /slo so an operator
    #: knows what "good" means without reading code)
    target: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), got "
                f"{self.objective} (1.0 leaves a zero error budget — every "
                f"bad event would be an infinite burn)"
            )


class _Windowed:
    """Good/bad counts in a ring of time buckets; O(1) memory."""

    def __init__(self, span_s: float):
        self.span_s = float(span_s)
        self.width_s = self.span_s / _BUCKETS
        #: bucket index -> [bucket_epoch, good, bad]
        self._ring: list[list] = [[-1, 0, 0] for _ in range(_BUCKETS)]

    def add(self, now: float, good: bool, n: int = 1) -> None:
        epoch = int(now / self.width_s)
        slot = self._ring[epoch % _BUCKETS]
        if slot[0] != epoch:
            slot[0], slot[1], slot[2] = epoch, 0, 0
        slot[1 if good else 2] += n

    def counts(self, now: float, window_s: float) -> tuple[int, int]:
        """(good, bad) over the trailing `window_s`."""
        cur = int(now / self.width_s)
        first = int((now - window_s) / self.width_s)
        good = bad = 0
        for slot in self._ring:
            if first <= slot[0] <= cur:
                good += slot[1]
                bad += slot[2]
        return good, bad


class SloState:
    """One registered SLO's live accounting (registry-internal)."""

    def __init__(self, spec: SloSpec, fast_s: float, slow_s: float):
        self.spec = spec
        self.fast_s = fast_s
        self.slow_s = slow_s
        self.window = _Windowed(slow_s)
        self.alerting = False
        self.episodes = 0
        self.last_change: float | None = None

    def burn(self, now: float, window_s: float) -> float:
        good, bad = self.window.counts(now, window_s)
        total = good + bad
        if total == 0:
            return 0.0
        budget = 1.0 - self.spec.objective
        return (bad / total) / budget

    def compliance(self, now: float) -> float | None:
        good, bad = self.window.counts(now, self.slow_s)
        total = good + bad
        if total == 0:
            return None
        return good / total

    def state_json(self, now: float) -> dict:
        fast, slow = self.burn(now, self.fast_s), self.burn(now, self.slow_s)
        comp = self.compliance(now)
        good, bad = self.window.counts(now, self.slow_s)
        return {
            "name": self.spec.name,
            "description": self.spec.description,
            "objective": self.spec.objective,
            "target": self.spec.target,
            "fastWindowS": self.fast_s,
            "slowWindowS": self.slow_s,
            "fastBurnRate": round(fast, 4),
            "slowBurnRate": round(slow, 4),
            "compliance": (None if comp is None else round(comp, 6)),
            "samples": good + bad,
            "badSamples": bad,
            "alerting": self.alerting,
            "episodes": self.episodes,
        }


class SloRegistry:
    """Per-cluster SLO evaluator; the facade builds one from `slo.*` keys
    and wires its anomaly sink to the cluster's detector.

    Thread-safe: producers (`record`) are the controller/scheduler/facade
    threads; `tick` runs on the evaluation thread AND on every /slo
    scrape (a scrape must never show stale burn rates because the ticker
    is between intervals)."""

    def __init__(
        self,
        *,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        burn_threshold: float = 10.0,
        sensors=None,
        clock=time.monotonic,
        anomaly_sink=None,
        cluster_id: str = "",
    ):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                f"need 0 < fast_window_s <= slow_window_s, got "
                f"{fast_window_s}/{slow_window_s}"
            )
        if burn_threshold < 1.0:
            raise ValueError(
                f"burn_threshold must be >= 1.0 (1.0 is the sustainable "
                f"burn), got {burn_threshold}"
            )
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self.clock = clock
        self.cluster_id = cluster_id
        #: detector.add_anomaly (set by the facade once the detector
        #: exists); SLO_BURN rides it alert-only
        self.anomaly_sink = anomaly_sink
        self.sensors = sensors
        self._lock = threading.Lock()
        self._slos: dict[str, SloState] = {}
        if sensors is not None:
            sensors.collector("slo.burn-rate", self._burn_collector)
            sensors.collector("slo.compliance", self._compliance_collector)

    # -- registration / feeding ----------------------------------------

    def register(self, spec: SloSpec) -> None:
        with self._lock:
            if spec.name in self._slos:
                raise ValueError(f"SLO {spec.name!r} already registered")
            self._slos[spec.name] = SloState(
                spec, self.fast_window_s, self.slow_window_s
            )

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._slos)

    def record(self, name: str, good: bool, n: int = 1) -> None:
        """Feed one good/bad observation (event-fed SLOs: a publish
        landing inside/outside its latency target, an urgent grant
        meeting/missing its wait bound).  Unknown names are ignored — a
        producer must not crash because its SLO is not configured here."""
        with self._lock:
            st = self._slos.get(name)
            if st is None:
                return
            st.window.add(self.clock(), good, n)
        if self.sensors is not None and not good:
            self.sensors.counter("slo.bad-samples").inc(n)

    # -- evaluation -----------------------------------------------------

    def tick(self) -> list[dict]:
        """Sample every probe, evaluate burn rates, fire/clear episodes;
        returns the post-evaluation state (the /slo body)."""
        now = self.clock()
        fired: list[SloState] = []
        with self._lock:
            states = list(self._slos.values())
        for st in states:
            if st.spec.probe is not None:
                try:
                    verdict = st.spec.probe()
                except Exception:  # noqa: BLE001 — a broken probe is no data
                    verdict = None
                if verdict is not None:
                    with self._lock:
                        st.window.add(now, bool(verdict))
        out = []
        with self._lock:
            for st in states:
                fast = st.burn(now, st.fast_s)
                slow = st.burn(now, st.slow_s)
                breaching = (
                    fast >= self.burn_threshold and slow >= self.burn_threshold
                )
                if breaching and not st.alerting:
                    # episode start: alert EXACTLY once until recovery
                    st.alerting = True
                    st.episodes += 1
                    st.last_change = now
                    fired.append(st)
                elif not breaching and st.alerting and (
                    fast < self.burn_threshold
                ):
                    # episode end: the fast window has genuinely
                    # recovered (the slow window may stay hot for its
                    # whole span — that is history, not a new fire)
                    st.alerting = False
                    st.last_change = now
                out.append(st.state_json(now))
        if self.sensors is not None:
            self.sensors.counter("slo.evaluations").inc()
            for st in fired:
                self.sensors.counter("slo.alerts").inc()
        for st in fired:
            self._fire(st, now)
        return out

    def _fire(self, st: SloState, now: float) -> None:
        sink = self.anomaly_sink
        log.warning(
            "SLO %s burning: fast %.1fx / slow %.1fx over budget "
            "(objective %.4g, episode %d)",
            st.spec.name, st.burn(now, st.fast_s), st.burn(now, st.slow_s),
            st.spec.objective, st.episodes,
        )
        if sink is None:
            return
        try:
            from cruise_control_tpu_torch.detector.anomalies import SloBurn

            sink(SloBurn(
                slo=st.spec.name,
                cluster_id=self.cluster_id,
                objective=st.spec.objective,
                fast_burn_rate=round(st.burn(now, st.fast_s), 3),
                slow_burn_rate=round(st.burn(now, st.slow_s), 3),
                episode=st.episodes,
            ))
        except Exception:  # noqa: BLE001 — alerting must not break evaluation
            log.warning("SLO_BURN anomaly delivery failed", exc_info=True)

    # -- surfaces -------------------------------------------------------

    def _burn_collector(self) -> list:
        now = self.clock()
        with self._lock:
            return [
                ({"slo": st.spec.name, "window": w},
                 st.burn(now, s))
                for st in self._slos.values()
                for w, s in (("fast", st.fast_s), ("slow", st.slow_s))
            ]

    def _compliance_collector(self) -> list:
        now = self.clock()
        with self._lock:
            out = []
            for st in self._slos.values():
                comp = st.compliance(now)
                if comp is not None:
                    out.append(({"slo": st.spec.name}, comp))
            return out

    def state_json(self) -> dict:
        """The `GET /slo` body for this cluster (evaluated fresh)."""
        return {
            "burnThreshold": self.burn_threshold,
            "slos": self.tick(),
        }

    def summary_json(self) -> dict:
        """Cheap per-SLO burn/episode summary (the /fleet rollup) — NO
        probe sampling or episode evaluation: rollups must stay cheap,
        the ticker and /slo scrapes keep the rates fresh."""
        now = self.clock()
        with self._lock:
            return {
                st.spec.name: {
                    "fastBurnRate": round(st.burn(now, st.fast_s), 4),
                    "slowBurnRate": round(st.burn(now, st.slow_s), 4),
                    "alerting": st.alerting,
                    "episodes": st.episodes,
                }
                for st in self._slos.values()
            }


class SloTicker:
    """Tiny evaluation loop: one daemon thread ticking a set of
    registries (one per cluster facade) on a fixed cadence.  The /slo
    endpoint also ticks on scrape; this thread exists so burn episodes
    fire (and reach the notifier) with nobody watching."""

    def __init__(self, interval_s: float = 5.0):
        self.interval_s = interval_s
        self._registries: list[SloRegistry] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def add(self, registry: SloRegistry) -> None:
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)

    def remove(self, registry: SloRegistry) -> None:
        """Detach one registry (its facade is shutting down); the loop
        thread stops once nobody is left to tick — in a fleet, N facades
        share ONE core-owned ticker, and the last one out turns off the
        light."""
        with self._lock:
            try:
                self._registries.remove(registry)
            except ValueError:
                pass
            empty = not self._registries
        if empty:
            self.stop()

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="slo-ticker"
            )
            self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._lock:
                regs = list(self._registries)
            for reg in regs:
                try:
                    reg.tick()
                except Exception:  # noqa: BLE001 — the loop must keep ticking
                    log.warning("SLO tick failed", exc_info=True)
