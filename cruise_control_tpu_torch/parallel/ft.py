"""Mesh fault-tolerance controller: per-width breakers + degrade episodes.

The optimizer's mesh ladder (analyzer/optimizer.py `_optimize_mesh_ft`)
is stateless per call; this controller owns the state that must survive
across optimize calls so degradation behaves like the single-device
breaker, per mesh WIDTH:

  * one `CircuitBreaker` per mesh width (device count), lazily created —
    a width that just lost a chip opens ITS breaker, and subsequent
    optimize calls skip straight past it to the widest usable rung
    instead of re-failing a wedged width every request.  The supervisor's
    single-device breaker is never touched by a mesh failure (the
    `DeviceSupervisor.call(breaker=...)` substitution), so the plain
    engine and CPU-greedy rungs below the mesh stay healthy.
  * probing rides the breakers' own half-open machinery: once
    `probe_interval_s` elapses, the next optimize call's attempt at that
    width IS the probe (`acquire_width` returns the HALF_OPEN breaker);
    success closes it, failure re-arms the probe timer.
  * degrade EPISODES for the alert surface: the first width reduction
    opens an episode (`MESH_DEGRADED` fires exactly once, drained via
    `poll_event`), further reductions inside the same episode update
    `last_event` without re-firing, and a completed run at FULL width
    closes the episode so the next loss alerts again.

`CheckpointSlot` is the per-anneal carry-snapshot holder the optimizer
hands to `SegmentContext(snapshot_sink=...)` — latest-wins, thread-safe
(the persist runs on the segment runner's background snapshot thread).

Sensors (docs/sensors.md): `analyzer.mesh-ft.resumes`,
`analyzer.mesh-ft.checkpoint-seconds`, `analyzer.mesh-ft.active-width`
live here; `analyzer.mesh-ft.device-lost` is counted at the attribution
site (common/device_watchdog.DeviceSupervisor._attribute_mesh_failure).

In this package no optimizer drives the ladder yet: the mesh engine layer
is not ported, and the service runs the single-device mode only.

Reference analog: none — the reference heals the Kafka cluster, not its
own compute substrate.
"""

from __future__ import annotations

import threading
import time

from cruise_control_tpu_torch.common.device_watchdog import BreakerState, CircuitBreaker


class CheckpointSlot:
    """Latest-wins holder for one anneal's carry checkpoints."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ckpt = None

    def offer(self, ckpt) -> None:
        with self._lock:
            self._ckpt = ckpt

    def latest(self):
        with self._lock:
            return self._ckpt


class MeshFtController:
    """Cross-call mesh fault-tolerance state (config keys tpu.mesh.ft.*)."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        checkpoint_every_slices: int = 0,
        breaker_failure_threshold: int = 1,
        probe_interval_s: float = 30.0,
        sensors=None,
        clock=time.monotonic,
    ):
        self.enabled = bool(enabled)
        self.checkpoint_every_slices = int(checkpoint_every_slices)
        self.breaker_failure_threshold = int(breaker_failure_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self.sensors = sensors
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[int, CircuitBreaker] = {}
        #: degrade episodes so far (monotonic; the anomaly's episode id)
        self.episodes = 0
        self._episode_open = False
        #: width of the most recent completed/attempted mesh run
        self.active_width: int | None = None
        #: most recent degrade event (diagnostics; /state)
        self.last_event: dict | None = None
        self._pending_event: dict | None = None

    # -- per-width breakers ---------------------------------------------

    def breaker_for(self, width: int) -> CircuitBreaker:
        with self._lock:
            brk = self._breakers.get(int(width))
            if brk is None:
                brk = CircuitBreaker(
                    failure_threshold=self.breaker_failure_threshold,
                    probe_interval_s=self.probe_interval_s,
                    clock=self._clock,
                )
                self._breakers[int(width)] = brk
            return brk

    def acquire_width(self, width: int) -> CircuitBreaker | None:
        """The width's breaker when an attempt there is allowed right now:
        CLOSED, or OPEN with the probe due (the attempt serves as the
        half-open probe).  None = skip this rung."""
        brk = self.breaker_for(width)
        if brk.state is BreakerState.CLOSED:
            return brk
        if brk.begin_probe():
            return brk
        return None

    def note_width_result(self, width: int, *, ok: bool) -> None:
        """Complete the half-open probe lifecycle after an attempt whose
        breaker `acquire_width` handed out in HALF_OPEN (the supervisor's
        record_success/record_failure don't transition a half-open
        breaker)."""
        with self._lock:
            brk = self._breakers.get(int(width))
        if brk is None or brk.state is not BreakerState.HALF_OPEN:
            return
        if ok:
            brk.probe_succeeded()
        else:
            brk.probe_failed()

    # -- episodes / events ----------------------------------------------

    def note_degrade(
        self, *, lost, from_width: int, to_width: int, failure_class: str
    ) -> dict:
        """Record one width reduction; arms the MESH_DEGRADED event
        exactly when this opens a NEW episode."""
        with self._lock:
            new = not self._episode_open
            if new:
                self._episode_open = True
                self.episodes += 1
            self.active_width = int(to_width)
            event = dict(
                lost_devices=[int(d) for d in (lost or ())],
                from_width=int(from_width),
                to_width=int(to_width),
                failure_class=str(failure_class),
                episode=self.episodes,
                ms=int(time.time() * 1000),
            )
            self.last_event = event
            if new:
                self._pending_event = dict(event)
        if self.sensors is not None:
            self.sensors.gauge("analyzer.mesh-ft.active-width").set(int(to_width))
        return event

    def note_run_completed(
        self, *, width: int, full_width: int, resumed: bool = False
    ) -> None:
        """A mesh run finished at `width`; completing at FULL width closes
        the episode (re-arms the anomaly for the next loss)."""
        with self._lock:
            self.active_width = int(width)
            if int(width) == int(full_width) and self._episode_open:
                self._episode_open = False
        if self.sensors is not None:
            self.sensors.gauge("analyzer.mesh-ft.active-width").set(int(width))
            if resumed:
                self.sensors.counter("analyzer.mesh-ft.resumes").inc()

    def note_checkpoint_seconds(self, seconds: float) -> None:
        if seconds > 0 and self.sensors is not None:
            self.sensors.counter("analyzer.mesh-ft.checkpoint-seconds").inc(
                round(float(seconds), 6)
            )

    def poll_event(self) -> dict | None:
        """Drain the pending once-per-episode MESH_DEGRADED payload (the
        facade's detector round); None when already reported."""
        with self._lock:
            event, self._pending_event = self._pending_event, None
            return event

    @property
    def episode_open(self) -> bool:
        with self._lock:
            return self._episode_open

    def state_json(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.enabled,
                "checkpointEverySlices": self.checkpoint_every_slices,
                "episodes": self.episodes,
                "episodeOpen": self._episode_open,
                "activeWidth": self.active_width,
                "breakers": {
                    str(w): b.snapshot() for w, b in sorted(self._breakers.items())
                },
            }
        if self.last_event is not None:
            out["lastEvent"] = dict(self.last_event)
        return out
