"""Flight recorder: lightweight spans over the whole proposal pipeline.

The JAX package's common/trace.py, standard library only.

One rebalance crosses five subsystems (monitor model build -> analyzer
optimize -> device supervisor op -> executor task lifecycle, with the
detector and planner running their own flows beside it), and until now the
only correlation between them was log archaeology: per-run device timings
live in `OptimizerResult.history`, executor transitions in the journal,
supervisor retries in counters.  The flight recorder stitches them into
one trace — every service operation gets a trace ID, every stage becomes a
span (monotonic clocks, parent links, attributes, bounded events), and
`GET /trace?id=...` replays the tree after the fact.

Design constraints, in order:

  * **Near-zero overhead.**  Tracing is ON by default and sits on the hot
    proposal path, so a span is a plain Python object, IDs come from one
    `uuid4`, and the store is a bounded per-component ring buffer
    (`deque(maxlen=...)`) — no I/O, no serialization, no background
    thread.  The `bench.py --trace-overhead` gate (scripts/check.sh) pins
    the cost under 2% of a smoke proposal run.
  * **Crash-tolerant by construction.**  Spans are published to the ring
    at START (end stamp None while running), so a trace polled mid-flight
    shows its live frontier, and a span abandoned by a hung device thread
    still appears (unfinished) instead of vanishing.
  * **Context propagation without plumbing.**  The active span rides a
    `contextvars.ContextVar`, so nested stages parent automatically within
    a thread; cross-thread handoffs (the user-task pool, the executor
    recovery thread, detector loop) pass an explicit `trace_id`/`root`.

There is no OpenTelemetry dependency on purpose: the container is
hermetic, and the span model here is deliberately the minimal subset that
serves `/trace`, the bench stage summaries, and the learned-warm-start
telemetry of ROADMAP item 3.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from collections import deque

#: the active span of the current logical context (one per thread/task)
_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "cc_current_span", default=None
)


def current_trace_id() -> str:
    """Trace id of the ambient span ("" outside any span) — lets
    non-span producers (the decision ledger's records) stamp the trace
    they ran under without threading ids through every call."""
    sp = _CURRENT.get()
    return sp.trace_id if sp is not None else ""


class Span:
    """One timed stage of a trace.  Mutable until `finish()`; thread-safe
    enough for its uses (attributes/events are appended under the owning
    tracer's lock only when contention is possible — in practice one span
    is written by one thread, the executor's observer hook included)."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "component",
        "start_mono", "end_mono", "start_ms", "attributes", "events",
        "error", "_max_events", "events_dropped",
    )

    def __init__(
        self,
        name: str,
        *,
        component: str,
        trace_id: str,
        parent_id: str | None,
        max_events: int = 256,
    ):
        self.name = name
        self.component = component
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.start_mono = time.monotonic()
        self.end_mono: float | None = None
        self.start_ms = int(time.time() * 1000)  # wall, display only
        self.attributes: dict = {}
        self.events: list[dict] = []
        self.error: str | None = None
        self._max_events = max_events
        self.events_dropped = 0

    # -- recording ------------------------------------------------------

    def set(self, **attrs) -> "Span":
        """Attach attributes (engine_cache_hit, device_s, bucket, ...)."""
        self.attributes.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        """Append a point-in-time event (task transition, retry, breaker
        flip).  Bounded: past `max_events` the event is counted, not kept —
        a 100k-task execution must not hold 100k dicts per span."""
        if len(self.events) >= self._max_events:
            self.events_dropped += 1
            return
        ev = {"name": name, "offset_s": round(time.monotonic() - self.start_mono, 6)}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def finish(self, error: str | None = None) -> None:
        if self.end_mono is None:
            self.end_mono = time.monotonic()
        if error is not None:
            self.error = error

    # -- reading --------------------------------------------------------

    @property
    def duration_s(self) -> float | None:
        if self.end_mono is None:
            return None
        return self.end_mono - self.start_mono

    def to_json(self) -> dict:
        d = self.duration_s
        out = {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "component": self.component,
            "startMs": self.start_ms,
            "startOffsetMonoS": self.start_mono,  # orders spans in a trace
            "durationMs": (None if d is None else round(d * 1e3, 3)),
            "inFlight": self.end_mono is None,
            "attributes": dict(self.attributes),
            "events": list(self.events),
        }
        if self.events_dropped:
            out["eventsDropped"] = self.events_dropped
        if self.error is not None:
            out["error"] = self.error
        return out


class _NoopSpan:
    """Inert span handed out while tracing is disabled — callers never
    branch on the enabled flag."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    events_dropped = 0

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        pass

    def finish(self, error=None):
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + bounded per-component ring store + trace index.

    Retention is per COMPONENT (config `trace.retention.spans.per.
    component`): a chatty component (device ops under retries) evicts its
    own history, never the executor's.  A trace expires naturally when its
    spans age out of every ring — there is no separate trace GC."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        retention_per_component: int = 512,
        max_events_per_span: int = 512,
    ):
        if retention_per_component < 1:
            raise ValueError(
                f"retention_per_component must be >= 1, got {retention_per_component}"
            )
        if max_events_per_span < 1:
            raise ValueError(
                f"max_events_per_span must be >= 1, got {max_events_per_span}"
            )
        self.enabled = enabled
        self.retention_per_component = retention_per_component
        self.max_events_per_span = max_events_per_span
        self._lock = threading.Lock()
        self._rings: dict[str, deque[Span]] = {}

    # -- span lifecycle -------------------------------------------------

    def new_trace_id(self) -> str:
        return uuid.uuid4().hex

    def start_span(
        self,
        name: str,
        *,
        component: str = "service",
        trace_id: str | None = None,
        parent: Span | None = None,
        root: bool = False,
    ) -> Span:
        """Create + publish a span (visible in the store immediately, end
        stamp pending).  Parentage: explicit `parent` wins; otherwise the
        context-active span unless `root=True` (detector loop, recovery
        thread — flows that must not attach to whatever request context
        the thread inherited)."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None and not root:
            parent = _CURRENT.get()
        if isinstance(parent, _NoopSpan):
            parent = None
        if trace_id is None or trace_id == "":
            trace_id = parent.trace_id if parent is not None else self.new_trace_id()
        span = Span(
            name,
            component=component,
            trace_id=trace_id,
            parent_id=parent.span_id if parent is not None else None,
            max_events=self.max_events_per_span,
        )
        with self._lock:
            ring = self._rings.get(component)
            if ring is None:
                ring = deque(maxlen=self.retention_per_component)
                self._rings[component] = ring
            ring.append(span)
        return span

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        component: str = "service",
        trace_id: str | None = None,
        parent: Span | None = None,
        root: bool = False,
        **attrs,
    ):
        """Start, activate (context parent for nested spans), finish."""
        sp = self.start_span(
            name, component=component, trace_id=trace_id, parent=parent, root=root
        )
        if attrs:
            sp.set(**attrs)
        if sp is NOOP_SPAN:
            yield sp
            return
        token = _CURRENT.set(sp)
        try:
            yield sp
        except BaseException as e:
            sp.finish(error=repr(e))
            raise
        else:
            sp.finish()
        finally:
            _CURRENT.reset(token)

    def current(self) -> Span | None:
        sp = _CURRENT.get()
        return None if isinstance(sp, _NoopSpan) else sp

    def event(self, name: str, **attrs) -> None:
        """Attach an event to the context-active span; silently dropped
        with no active span (a library running outside any traced flow)."""
        sp = _CURRENT.get()
        if sp is not None:
            sp.event(name, **attrs)

    # -- reading --------------------------------------------------------

    def _all_spans(self) -> list[Span]:
        with self._lock:
            return [s for ring in self._rings.values() for s in ring]

    def trace(self, trace_id: str) -> list[Span]:
        """Every retained span of one trace, oldest first."""
        spans = [s for s in self._all_spans() if s.trace_id == trace_id]
        spans.sort(key=lambda s: s.start_mono)
        return spans

    def trace_tree(self, trace_id: str) -> list[dict]:
        """The trace as a forest of nested span dicts (children under
        `children`).  A span whose parent already aged out of its ring
        surfaces as an extra root rather than disappearing."""
        spans = self.trace(trace_id)
        nodes = {s.span_id: {**s.to_json(), "children": []} for s in spans}
        roots = []
        for s in spans:
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            if parent is not None:
                parent["children"].append(node)
            else:
                roots.append(node)
        return roots

    def recent_traces(self, limit: int = 50) -> list[dict]:
        """Newest-first index of retained ROOT spans — what an operator
        lists before picking a trace ID to replay."""
        roots = [s for s in self._all_spans() if s.parent_id is None]
        roots.sort(key=lambda s: s.start_mono, reverse=True)
        return [
            {
                "traceId": s.trace_id,
                "name": s.name,
                "component": s.component,
                "startMs": s.start_ms,
                "durationMs": (
                    None if s.duration_s is None else round(s.duration_s * 1e3, 3)
                ),
                "inFlight": s.end_mono is None,
                "error": s.error,
            }
            for s in roots[: max(1, limit)]
        ]

    def summarize(self, trace_id: str | None = None) -> dict:
        """Per-stage rollup {span name: {count, totalMs, maxMs, errors}} —
        the bench embeds this next to its wall-clock numbers so the perf
        trajectory records WHERE the time went, not just totals."""
        spans = self.trace(trace_id) if trace_id else self._all_spans()
        out: dict[str, dict] = {}
        for s in spans:
            d = s.duration_s
            if d is None:
                continue
            row = out.setdefault(
                s.name,
                {"component": s.component, "count": 0, "totalMs": 0.0,
                 "maxMs": 0.0, "errors": 0},
            )
            row["count"] += 1
            row["totalMs"] = round(row["totalMs"] + d * 1e3, 3)
            row["maxMs"] = round(max(row["maxMs"], d * 1e3), 3)
            if s.error is not None:
                row["errors"] += 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()

    def scoped(self, scope: str) -> "Tracer":
        """Cluster-scoped view for the fleet controller: spans record into
        the SAME store (trace ids and GET /trace replay stay fleet-global)
        under a namespaced component (`<scope>:monitor`), so every cluster
        gets its own per-component retention rings — one cluster's chatty
        executor can never evict another cluster's history."""
        if not scope:
            return self
        return _ScopedTracer(self, scope)


class _ScopedTracer:
    """Component-namespacing proxy over a shared Tracer (Tracer.scoped)."""

    def __init__(self, base: Tracer, scope: str):
        self._base = base
        self.scope = scope

    @property
    def enabled(self) -> bool:
        return self._base.enabled

    def _component(self, component: str) -> str:
        return f"{self.scope}:{component}"

    def new_trace_id(self) -> str:
        return self._base.new_trace_id()

    def start_span(self, name, *, component="service", **kwargs):
        return self._base.start_span(
            name, component=self._component(component), **kwargs
        )

    def span(self, name, *, component="service", **kwargs):
        return self._base.span(
            name, component=self._component(component), **kwargs
        )

    def current(self):
        return self._base.current()

    def event(self, name, **attrs) -> None:
        self._base.event(name, **attrs)

    def trace(self, trace_id):
        return self._base.trace(trace_id)

    def trace_tree(self, trace_id):
        return self._base.trace_tree(trace_id)

    def recent_traces(self, limit: int = 50):
        return self._base.recent_traces(limit)

    def summarize(self, trace_id=None):
        return self._base.summarize(trace_id)

    def scoped(self, scope: str):
        return self._base.scoped(scope)

    def clear(self) -> None:
        self._base.clear()


#: process-wide default tracer (components accept an override; the facade
#: builds a per-service instance from the trace.* config keys).  Enabled
#: by default — the whole point is that a production incident has a trace
#: waiting, not a knob that was off.
TRACER = Tracer()
