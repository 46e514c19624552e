"""The pause clock of a supervised device dispatch.

The JAX package's common/device_watchdog.py bounds every engine dispatch
of the service with a hang budget (its `DeviceSupervisor`).  A dispatch
that the device scheduler pauses at a preemption checkpoint is not hung:
the scheduler is doing its job.  So the scheduler scopes a pause clock to
each preemptible grant (fleet/scheduler.py), a callable that returns the
cumulative seconds the dispatch has spent paused, a pause in progress
included, and the supervisor extends the dispatch's deadline by it.

This module holds that seam only: `pause_clock_scope` and
`_current_pause_clock`.  The supervisor that reads the clock comes with
the port's device supervisor and its degraded routes (ROADMAP queue 1
item 7a).  A contextvar, so the clock rides the caller's context into a
worker thread that runs the dispatch with a copy of it; unset (the
default), a hang budget is pure wall clock.
"""

from __future__ import annotations

import contextvars

_PAUSE_CLOCK_VAR: contextvars.ContextVar = contextvars.ContextVar(
    "cc-torch-device-op-pause-clock", default=None
)


class pause_clock_scope:
    """Scope a pause clock, `() -> float` seconds of externally imposed
    pause of the current dispatch (one in progress included), to the
    current context."""

    def __init__(self, fn):
        self._fn = fn
        self._token = None

    def __enter__(self):
        self._token = _PAUSE_CLOCK_VAR.set(self._fn)
        return self

    def __exit__(self, *exc):
        _PAUSE_CLOCK_VAR.reset(self._token)


def _current_pause_clock():
    """The pause clock scoped to the current context, or None."""
    return _PAUSE_CLOCK_VAR.get()
