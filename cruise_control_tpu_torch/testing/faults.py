"""Deterministic fault injection for the supervised optimizer runtime.

The JAX package's testing/faults.py, pointed at the port: its device-op
hook is common/device_watchdog.py's, and its injected errors keep their
classes but carry CUDA's phrasings ("CUDA error: out of memory", "CUDA
error: an illegal memory access was encountered"), so the supervisor's
taxonomy is exercised on the text the port really sees.

Every breaker transition, retry schedule, and degraded-mode proposal must
be pinned by tests rather than by hoping the card misbehaves on cue.  This
module injects the failures the supervisor classifies — engine hangs,
raised CUDA errors, OOMs — plus Kafka transport and admin faults, all
keyed by CALL COUNT (or a seeded pseudo-random rate), so a test can say
"the second engine invocation OOMs" and mean exactly that.

Two injection surfaces:

  * device ops — everything marked `@device_op` (Engine.run and
    run_reported as "engine.run", Engine.run_cycle as "engine.cycle", the
    scenario evaluator's batch, and the watchdog's trivial-op probe)
    routes through ONE process-wide hook
    (common/device_watchdog.set_device_op_hook).  `device_fault` installs
    an interceptor on that seam; `device_wedged` is the composite of a
    wedged card: EVERY device op — including the recovery probe — blocks
    until the context exits.
  * arbitrary methods — `method_fault` (with the `slow` / `hanging` /
    `raising` / `dropping` effects) patches a bound method on any object
    or class: a simulated admin, a Kafka wire client, a notifier.

All context managers yield an `InjectionLog` (total calls seen, faults
fired) so tests assert the fault actually hit.  Hooks nest: an inner
injector delegates non-matching calls to whatever was installed before
it.  Everything is restored on exit, and hang injectors release their
blocked threads so abandoned supervisor workers finish instead of leaking
into the next test.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time

from cruise_control_tpu_torch.common import device_watchdog as _watchdog_mod
from cruise_control_tpu_torch.common.device_watchdog import set_device_op_hook

#: every engine-invocation op name (the probe is separate on purpose:
#: error-class injectors must not break the recovery probe, only
#: `device_wedged` models a device that fails the probe too)
ENGINE_OPS = (
    "engine.run", "mesh.run", "portfolio.run",
    "scenario.batch-eval",
)
PROBE_OP = "probe"
#: the per-device attribution probe (mesh fault tolerance) — one tiny
#: dispatch per chip, the device object as args[0]
DEVICE_PROBE_OP = "device.probe"
ALL_DEVICE_OPS = ENGINE_OPS + (PROBE_OP,)


def _dispatch_device_ids(args) -> tuple[int, ...] | None:
    """Best-effort device ids a dispatch touches, from its receiver:
    a mesh engine exposes `.mesh` (all its devices), a per-device probe
    passes the device itself (`.id`, its index).  None when undeterminable —
    callers treat that as the default device (id 0), where single-device
    engine work lands."""
    if not args:
        return None
    recv = args[0]
    mesh = getattr(recv, "mesh", None)
    if mesh is not None:
        try:
            return tuple(int(d.id) for d in mesh.devices.flat)
        except Exception:  # noqa: BLE001 — attribution only
            return None
    did = getattr(recv, "id", None)
    if isinstance(did, int):
        return (did,)
    return None


class FaultSchedule:
    """Which call indices (0-based, per op / per method) a fault fires on.

    calls: explicit indices ("fail calls 0 and 2").  after/limit: a
    contiguous window ("fail everything from call 3", "the first 2
    calls").  rate+seed: seeded pseudo-random firing, deterministic per
    (seed, index) — reproducible chaos for soak-style tests.  Default
    fires on EVERY call.
    """

    def __init__(
        self,
        calls=None,
        *,
        after: int = 0,
        limit: int | None = None,
        rate: float | None = None,
        seed: int = 0,
    ):
        self.calls = frozenset(calls) if calls is not None else None
        self.after = after
        self.limit = limit
        self.rate = rate
        self.seed = seed

    def fires(self, n: int) -> bool:
        if self.calls is not None:
            return n in self.calls
        if n < self.after:
            return False
        if self.limit is not None and n >= self.after + self.limit:
            return False
        if self.rate is not None:
            # deterministic per (seed, index); int-mixed because tuple
            # seeding is deprecated
            return random.Random(self.seed * 1_000_003 + n).random() < self.rate
        return True


ALWAYS = FaultSchedule()


def first(n: int) -> FaultSchedule:
    """The first n calls fail, the rest succeed — the transient-recovery
    shape (retry tests)."""
    return FaultSchedule(limit=n)


class InjectionLog:
    """What an injector observed: total intercepted calls and fired
    faults, per op/method name.  Thread-safe — supervised ops run on
    worker threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    def _record(self, name: str) -> int:
        """Count one call; returns its 0-based index for the schedule."""
        with self._lock:
            n = self.calls.get(name, 0)
            self.calls[name] = n + 1
            return n

    def _mark_fired(self, name: str) -> None:
        with self._lock:
            self.fired[name] = self.fired.get(name, 0) + 1

    @property
    def total_calls(self) -> int:
        with self._lock:
            return sum(self.calls.values())

    @property
    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())


# ----------------------------------------------------------------------
# effects
# ----------------------------------------------------------------------


class InjectedXlaError(RuntimeError):
    """Stand-in for a CUDA runtime error as PyTorch raises it (the JAX
    package's class name): a RuntimeError whose message carries CUDA's
    phrasing, the shape the classifier reads."""


def transient_error(op: str = "?") -> InjectedXlaError:
    return InjectedXlaError(
        f"CUDA error: CUDA-capable device(s) is/are busy or unavailable "
        f"(injected fault in {op})"
    )


def oom_error(op: str = "?") -> InjectedXlaError:
    return InjectedXlaError(f"CUDA error: out of memory (injected fault in {op})")


def compile_error(op: str = "?") -> InjectedXlaError:
    return InjectedXlaError(
        f"CUDA error: operation not permitted when stream is capturing "
        f"(injected fault in {op})"
    )


def device_lost_error(op: str = "?", device_id: int = 0) -> InjectedXlaError:
    """A sticky error on card `device_id` (classify_failure -> DEVICE_LOST
    through its sticky-phrasing match)."""
    return InjectedXlaError(
        f"CUDA error: an illegal memory access was encountered "
        f"(injected fault in {op} on device {device_id})"
    )


# ----------------------------------------------------------------------
# device-op injection (the @device_op seam)
# ----------------------------------------------------------------------


@contextlib.contextmanager
def device_fault(effect, *, ops=ENGINE_OPS, schedule: FaultSchedule = ALWAYS):
    """Intercept device ops: when `schedule` fires for that op's call
    index, run `effect(op_name, fn, args, kwargs)` (raise to inject an
    error; block to inject a hang; call fn for a late real completion);
    otherwise dispatch normally.  Non-targeted ops (and non-firing calls)
    fall through to any previously installed hook, so injectors nest."""
    log = InjectionLog()
    prev = _watchdog_mod._DEVICE_OP_HOOK

    def hook(name, fn, args, kwargs):
        if name in ops:
            n = log._record(name)
            if schedule.fires(n):
                log._mark_fired(name)
                return effect(name, fn, args, kwargs)
        if prev is not None:
            return prev(name, fn, args, kwargs)
        return fn(*args, **kwargs)

    set_device_op_hook(hook)
    try:
        yield log
    finally:
        set_device_op_hook(prev)


def _raising(factory):
    def effect(op, fn, args, kwargs):
        raise factory(op)

    return effect


def xla_errors(*, ops=ENGINE_OPS, schedule: FaultSchedule = ALWAYS):
    """Engine invocations raise transient CUDA runtime errors."""
    return device_fault(_raising(transient_error), ops=ops, schedule=schedule)


def device_oom(*, ops=ENGINE_OPS, schedule: FaultSchedule = ALWAYS):
    """Engine invocations raise CUDA's out-of-memory error."""
    return device_fault(_raising(oom_error), ops=ops, schedule=schedule)


def compile_failures(*, ops=ENGINE_OPS, schedule: FaultSchedule = ALWAYS):
    """Engine invocations raise a CUDA stream-capture error (the port's
    COMPILE class)."""
    return device_fault(_raising(compile_error), ops=ops, schedule=schedule)


@contextlib.contextmanager
def device_slowdown(
    factor: float, *, ops=ENGINE_OPS, schedule: FaultSchedule = ALWAYS
):
    """Sustained device SLOWNESS: every targeted engine op completes for
    real, then stalls until its wall clock has been scaled by `factor`
    (>= 1.0) — thermal throttling, a lowered power limit, a neighbour's
    burst.  Hangs and crashes were injectable before; this is the shape
    overload soaks need: the device keeps answering, just too slowly to
    hold the fleet's deadlines, so shedding/brownout must engage rather
    than the breaker.

    Per-op accounting rides the yielded InjectionLog (calls/fired per op
    name) like every injector here, and the hook nests/restores through
    `device_fault` — an inner injector still sees non-targeted calls.
    """
    if factor < 1.0:
        raise ValueError(f"device_slowdown factor must be >= 1.0, got {factor}")

    def effect(op, fn, args, kwargs):
        t0 = time.monotonic()
        result = fn(*args, **kwargs)
        wall = time.monotonic() - t0
        time.sleep(wall * (factor - 1.0))
        return result

    with device_fault(effect, ops=ops, schedule=schedule) as log:
        yield log


@contextlib.contextmanager
def device_wedged(*, ops=ALL_DEVICE_OPS, schedule: FaultSchedule = ALWAYS):
    """A wedged card: every device op — engine runs AND the recovery
    probe — hangs until the context exits ("the fault clears").  Abandoned supervisor threads unblock at exit and complete
    against the real device, so nothing leaks into the next test."""
    release = threading.Event()

    def effect(op, fn, args, kwargs):
        # block until "the fault clears" (context exit), then return a
        # nothing-result WITHOUT running the real op: the supervisor
        # already abandoned this call, and re-running real device work on
        # an orphaned thread would race interpreter teardown
        release.wait()
        return None

    with device_fault(effect, ops=ops, schedule=schedule) as log:
        try:
            yield log
        finally:
            release.set()


@contextlib.contextmanager
def device_loss(
    device_index: int,
    *,
    ops=ENGINE_OPS,
    schedule: FaultSchedule = ALWAYS,
    probe_ops=(DEVICE_PROBE_OP,),
):
    """Chip `device_index` DIES: from the scheduled call index on, every
    targeted dispatch that involves that device raises a DEVICE_LOST-shaped
    backend error.  Loss is LATCHED — once the schedule fires, the chip is
    permanently gone, so its per-device attribution probes (`probe_ops`)
    fail too regardless of schedule, while every other chip's probe passes:
    exactly the asymmetry the mesh classifier attributes on.  Dispatches
    not involving the chip (and all ops before the latch) fall through,
    nest-safe with per-op accounting like `device_slowdown`."""
    lost = threading.Event()

    def effect(op, fn, args, kwargs):
        raise device_lost_error(op, device_index)

    def involved(args) -> bool:
        ids = _dispatch_device_ids(args)
        return device_index in (ids if ids is not None else (0,))

    log = InjectionLog()
    prev = _watchdog_mod._DEVICE_OP_HOOK

    def hook(name, fn, args, kwargs):
        if name in probe_ops and lost.is_set() and involved(args):
            log._record(name)
            log._mark_fired(name)
            raise device_lost_error(name, device_index)
        if name in ops and involved(args):
            n = log._record(name)
            if schedule.fires(n):
                log._mark_fired(name)
                lost.set()
                return effect(name, fn, args, kwargs)
        if prev is not None:
            return prev(name, fn, args, kwargs)
        return fn(*args, **kwargs)

    set_device_op_hook(hook)
    try:
        yield log
    finally:
        set_device_op_hook(prev)


@contextlib.contextmanager
def collective_stall(
    *,
    device_index: int | None = None,
    ops=ENGINE_OPS,
    schedule: FaultSchedule = ALWAYS,
):
    """Hang ONLY multi-device dispatches: a targeted op whose receiver
    spans >1 device blocks until the context exits, single-device work
    keeps completing — the collective-wedge shape, distinct from
    `device_wedged` (everything hangs).  With `device_index` set, that
    chip's per-device attribution probe ALSO hangs once a stall has
    fired (latched), so the supervisor's fan-out pins the stall on it
    (COLLECTIVE_STALL with suspects) instead of reporting a bare HANG.
    Blocked threads release at exit; per-op accounting rides the log."""
    release = threading.Event()
    stalled = threading.Event()
    log = InjectionLog()
    prev = _watchdog_mod._DEVICE_OP_HOOK

    def hook(name, fn, args, kwargs):
        ids = _dispatch_device_ids(args)
        if (
            name == DEVICE_PROBE_OP
            and device_index is not None
            and stalled.is_set()
            and ids == (device_index,)
        ):
            log._record(name)
            log._mark_fired(name)
            release.wait()
            return None
        if name in ops and ids is not None and len(ids) > 1:
            n = log._record(name)
            if schedule.fires(n):
                log._mark_fired(name)
                stalled.set()
                # abandoned by the supervisor; completing real work on an
                # orphaned thread would race interpreter teardown
                release.wait()
                return None
        if prev is not None:
            return prev(name, fn, args, kwargs)
        return fn(*args, **kwargs)

    set_device_op_hook(hook)
    try:
        yield log
    finally:
        release.set()
        set_device_op_hook(prev)


# ----------------------------------------------------------------------
# arbitrary-method injection (admin backends, Kafka wire client, ...)
# ----------------------------------------------------------------------


@contextlib.contextmanager
def method_fault(target, name: str, effect, *, schedule: FaultSchedule = ALWAYS):
    """Patch `target.name` (object or class attribute): calls whose index
    fires per `schedule` run `effect(orig_bound, *args, **kwargs)`;
    others pass through.  effect receives the ORIGINAL callable so slow/
    wrapping effects can still do the real work."""
    log = InjectionLog()
    orig = getattr(target, name)
    # an instance patch must not leave a shadowing attribute behind when
    # the method originally lived on the class
    had_own = isinstance(target, type) or name in vars(target)

    def wrapper(*args, **kwargs):
        n = log._record(name)
        if schedule.fires(n):
            log._mark_fired(name)
            return effect(orig, *args, **kwargs)
        return orig(*args, **kwargs)

    setattr(target, name, wrapper)
    try:
        yield log
    finally:
        if had_own:
            setattr(target, name, orig)
        else:
            delattr(target, name)


def slow(delay_s: float):
    """Effect: the call succeeds, after delay_s (slow admin/broker)."""

    def effect(orig, *args, **kwargs):
        time.sleep(delay_s)
        return orig(*args, **kwargs)

    return effect


def dropping(result=None):
    """Effect: the call is swallowed — nothing happens on the backend
    (a controller that accepts and forgets, an election that never runs)."""

    def effect(orig, *args, **kwargs):
        return result

    return effect


def raising(exc_factory):
    """Effect: the call raises exc_factory() (e.g. ConnectionError for
    transient Kafka transport faults)."""

    def effect(orig, *args, **kwargs):
        raise exc_factory()

    return effect


def hanging(release: threading.Event):
    """Effect: the call blocks until `release` is set, then completes for
    real — a hung admin/broker response.  The caller owns the event (set
    it in test teardown, or use `hung_method` which does both)."""

    def effect(orig, *args, **kwargs):
        release.wait()
        return orig(*args, **kwargs)

    return effect


@contextlib.contextmanager
def hung_method(target, name: str, *, schedule: FaultSchedule = ALWAYS):
    """method_fault + hanging with the release tied to context exit."""
    release = threading.Event()
    with method_fault(target, name, hanging(release), schedule=schedule) as log:
        try:
            yield log
        finally:
            release.set()


def kafka_connection_errors(client, *, schedule: FaultSchedule = ALWAYS):
    """Transient transport faults: `client.broker_request` raises
    ConnectionError on scheduled calls (broker restart / dropped socket)."""
    return method_fault(
        client,
        "broker_request",
        raising(lambda: ConnectionError("injected: connection reset by peer")),
        schedule=schedule,
    )


# ----------------------------------------------------------------------
# crash/restart + stall injection (crash-safe executor tests)
# ----------------------------------------------------------------------


class SimulatedProcessCrash(RuntimeError):
    """Raised out of the executor's progress loop to model the process
    dying mid-execution (kill -9, OOM-kill, node loss)."""


@contextlib.contextmanager
def process_crash(admin, *, on: str = "tick", schedule: FaultSchedule = ALWAYS):
    """Model a HARD process crash mid-execution against `admin`.

    The scheduled call to `admin.on` raises SimulatedProcessCrash — and for
    the remainder of the context the dying process's outbound CLEANUP calls
    (`clear_replication_throttle`, `cancel_reassignments`) ALSO raise it,
    because a crashed process never reaches the cluster again: whatever
    `finally` blocks the interpreter still runs must not tidy up state —
    on the cluster OR in the journal — that a real kill -9 would have left
    behind (leaked throttles, in-flight reassignments, no trailing journal
    records).  The test catches the exception, abandons the "dead"
    executor, and constructs a fresh one over the same journal to exercise
    recovery.
    """
    crash = raising(lambda: SimulatedProcessCrash("injected crash"))
    with method_fault(admin, on, crash, schedule=schedule) as log, \
            method_fault(admin, "clear_replication_throttle", crash), \
            method_fault(admin, "cancel_reassignments", crash):
        yield log


@contextlib.contextmanager
def stalled_moves(admin, *keys):
    """Freeze the given reassignments on a SimulatedClusterAdmin (or any
    admin exposing stall/unstall): listed as in-progress forever, zero byte
    progress — the shape the stuck-move reaper enforces against."""
    admin.stall(*keys)
    try:
        yield
    finally:
        admin.unstall(*keys)


def truncate_file(path: str, *, keep_bytes: int | None = None, drop_bytes: int = 0):
    """Crash-truncate a journal: keep the first `keep_bytes` (or all minus
    `drop_bytes`) — models fsync racing the crash, including a torn final
    record."""
    import os

    size = os.path.getsize(path)
    keep = keep_bytes if keep_bytes is not None else max(0, size - drop_bytes)
    with open(path, "rb+") as f:
        f.truncate(keep)


# ----------------------------------------------------------------------
# fleet-HA injection: lease-store partitions + per-instance clock skew
# ----------------------------------------------------------------------

#: the LeaseStore contract surface the partition injector can sever
LEASE_OPS = ("acquire", "renew", "release", "read")


@contextlib.contextmanager
def lease_partition(store, *, ops=LEASE_OPS, schedule: FaultSchedule = ALWAYS,
                    mode: str = "fail"):
    """Partition an instance from its lease store: scheduled calls to the
    given LeaseStore methods either raise OSError (`mode="fail"` — the
    store is unreachable) or block until the context exits
    (`mode="hang"` — the classic stalled-writer shape: the instance
    neither renews nor learns it lost).  Call counts land in the yielded
    InjectionLog per method, like every other injector here.

    The store object is patched per INSTANCE, so a two-instance harness
    can partition one instance's view while the other keeps working —
    exactly the asymmetric partition that forces a takeover."""
    if mode not in ("fail", "hang"):
        raise ValueError(f"lease_partition mode {mode!r} not in (fail, hang)")
    log = InjectionLog()
    release = threading.Event()
    originals = {name: getattr(store, name) for name in ops}
    owned = {
        name: isinstance(store, type) or name in vars(store) for name in ops
    }

    def make_wrapper(name, orig):
        def wrapper(*args, **kwargs):
            n = log._record(name)
            if schedule.fires(n):
                log._mark_fired(name)
                if mode == "hang":
                    release.wait()
                    # the partition healed: the late call completes for
                    # real (its staleness is the lease layer's problem —
                    # that is the point)
                    return orig(*args, **kwargs)
                raise OSError(f"injected lease-store partition in {name}")
            return orig(*args, **kwargs)

        return wrapper

    for name, orig in originals.items():
        setattr(store, name, make_wrapper(name, orig))
    try:
        yield log
    finally:
        release.set()
        for name, orig in originals.items():
            if owned[name]:
                setattr(store, name, orig)
            else:
                delattr(store, name)


@contextlib.contextmanager
def clock_skew(target, offset_s: float):
    """Skew one instance's clock by `offset_s` seconds: patches the
    injectable `clock` attribute (LeaseManager and FileLeaseStore both
    carry one) so every read returns real+offset.  Yields an
    InjectionLog counting reads under "clock".  Skew within
    `fleet.ha.skew.slack.s` must be invisible; beyond it, the safety
    argument no longer covers the instance — chaos tests probe both
    sides of that line."""
    log = InjectionLog()
    orig = target.clock

    def skewed():
        log._record("clock")
        return orig() + offset_s

    target.clock = skewed
    try:
        yield log
    finally:
        target.clock = orig
