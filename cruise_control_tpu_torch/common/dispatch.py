"""Device-dispatch accounting.

The fused anneal's contract is O(1) host<->device interaction per run:
the host issues the whole schedule (`engine.init`, `engine.run`) and then
makes ONE blocking sync (`engine.sync`).  The contract is proved by
counting, not asserted by reading the code: every choke point that issues
device work or forces a device->host sync calls `count_dispatch(tag)`, and
a caller wraps the work in `dispatch_meter()` to read the counts.

The meter is a contextvar STACK, not a single slot: an outer meter and an
inner one both see every count.  No meter active costs one contextvar read
per choke point.
"""

from __future__ import annotations

import contextlib
import contextvars

_METERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "cc-torch-dispatch-meters", default=()
)


class DispatchMeter:
    """Per-tag dispatch counts observed while this meter was active."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def count(self, tag: str, n: int = 1) -> None:
        self.counts[tag] = self.counts.get(tag, 0) + n

    def __repr__(self) -> str:
        return f"DispatchMeter(total={self.total}, counts={self.counts})"


def count_dispatch(tag: str, n: int = 1) -> None:
    """Record `n` device dispatches/syncs against every active meter."""
    for m in _METERS.get():
        m.count(tag, n)


@contextlib.contextmanager
def dispatch_meter():
    """Activate a DispatchMeter for the enclosed block (nestable)."""
    m = DispatchMeter()
    token = _METERS.set(_METERS.get() + (m,))
    try:
        yield m
    finally:
        _METERS.reset(token)
