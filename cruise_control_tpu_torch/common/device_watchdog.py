"""Supervised device runtime: watchdog probe, failure taxonomy, breaker.

The JAX package's common/device_watchdog.py on CUDA.  A card can wedge
(every dispatch hangs), run out of memory, or take a sticky error that
leaves the process's CUDA context unusable.  Under a supervisor such a
failure is bounded, classified and counted toward a breaker instead of
hanging `proposals()` and every self-healing action behind it:

  * `device_op`  — the marker every engine dispatch routes through; the
    deterministic fault harness (testing/faults.py) injects hangs and
    raised errors here instead of monkeypatching the engine classes.
  * `classify_failure` — maps an exception from a supervised call onto the
    failure taxonomy (HANG / COMPILE / OOM / TRANSIENT / DEVICE_LOST);
    application errors (bad request masks, invalid states) and install
    faults (a kernel that does not build or load) classify as None and
    propagate untouched.
  * `CircuitBreaker` — CLOSED -> (N classified failures) -> OPEN ->
    (half-open probe healthy) -> CLOSED.
  * `DeviceSupervisor` — bounded-budget call (daemon-thread deadline),
    jittered-backoff retry for transient classes, breaker bookkeeping,
    half-open probing via the trivial-op watchdog, and the sensor surface
    (`analyzer.supervisor.*`).

The supervisor is opt-in: `GoalOptimizer` and `ScenarioEvaluator` built
without one run the device path directly and raise its errors.  With one,
every device invocation goes through `DeviceSupervisor.run`: while the
breaker is open the device is not touched, and a classified failure or an
open breaker raises `DeviceDegradedError` (`BreakerOpenError`).  Work on
the card is never answered from the CPU.  Only work whose tensors already
lie on the host (an optimizer or evaluator on the CPU) gets the JAX
package's flagged degraded answer (analyzer/optimizer.py,
analyzer/scenario_eval.py).

The taxonomy reads CUDA's failures structurally first, by type
(`kernels._build.KernelBuildError`, `CudaLaunchError` and its
`cudaError_t` code, `torch.cuda.OutOfMemoryError`), then by CUDA's own
phrasings, and it is an allow-list: only the codes and phrasings that are
conditions of the card (out of memory, the sticky errors, a failed
capture, a card busy with another process) are classified.  Every other
CUDA error (an image built for another arch, a launch configuration the
card refuses, an invalid argument) is a fault of the install or of a
wrapper and propagates unclassified.  A sticky error (an illegal address,
a device-side assert, an unspecified launch failure) is DEVICE_LOST and
never retried: every later CUDA call of the process raises, so the
half-open probe fails too and the breaker stays open.  A call abandoned at
its deadline keeps the breaker open while its worker still runs: the
default probe fails until it has returned.

The pause clock: a dispatch that the device scheduler pauses at a
preemption checkpoint is not hung.  The scheduler scopes a pause clock to
each preemptible grant (fleet/scheduler.py), a callable that returns the
cumulative seconds the dispatch has spent paused, a pause in progress
included, and the supervisor extends the dispatch's deadline by it.  A
contextvar, so the clock rides the caller's context into the worker
thread that runs the dispatch with a copy of it; unset (the default), a
hang budget is pure wall clock.

Not here (multi-device, ROADMAP queue 1 item 10): the JAX package's mesh
half, `probe_devices`, per-device attribution and `note_device_health`.
"""

from __future__ import annotations

import contextvars
import enum
import functools
import random
import threading
import time

from cruise_control_tpu_torch.common.blackbox import RECORDER as _BLACKBOX


def _trivial_device_op(device=None) -> None:
    """The watchdog's probe payload: one tiny reduction on `device` (the
    current CUDA device when None, raising without one), checked on the
    host.  On a card it runs on a stream of its own and waits for that
    stream's event only: `torch.cuda.synchronize()` would wait behind an
    abandoned worker's work even on a healthy card.  A module-level seam
    (wrapped by `device_op`) so the fault harness can wedge the probe
    exactly like the engine ops."""
    import torch

    from cruise_control_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        if int(torch.arange(8, device=dev).sum()) != 28:
            raise RuntimeError(f"device probe on {dev} computed a wrong sum")
        return
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        total = torch.arange(8, device=dev).sum()
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    with torch.cuda.stream(stream):
        # the read copies on the probe's stream, whose work is done
        value = int(total)
    if value != 28:
        raise RuntimeError(f"device probe on {dev} computed a wrong sum")


# ----------------------------------------------------------------------
# fault-injection seam
# ----------------------------------------------------------------------

#: (op_name, fn, args, kwargs) -> result.  The default just dispatches;
#: testing/faults.py swaps it to inject hangs / raised CUDA errors / OOMs
#: keyed by op name and call count.  One indirect call per engine
#: invocation (not per step).
_DEVICE_OP_HOOK = None
_HOOK_LOCK = threading.Lock()


def set_device_op_hook(hook) -> None:
    """Install (or with None, remove) the device-op interception hook."""
    global _DEVICE_OP_HOOK
    with _HOOK_LOCK:
        _DEVICE_OP_HOOK = hook


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


class CheckpointClock:
    """Cumulative seconds a dispatch has spent capturing carry checkpoints
    (engine.SegmentContext snapshots).  Scoped with
    `checkpoint_clock_scope`; `DeviceSupervisor._bounded` adds it to the
    pause clock so host-side snapshot I/O extends the hang deadline
    instead of eating it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0.0

    def add(self, dt: float) -> None:
        with self._lock:
            self._total += max(0.0, dt)

    def seconds(self) -> float:
        with self._lock:
            return self._total


_CKPT_CLOCK_VAR: contextvars.ContextVar = contextvars.ContextVar(
    "cc-torch-device-op-checkpoint-clock", default=None
)


class checkpoint_clock_scope:
    """Scope a CheckpointClock to the current context — the same
    contextvar ride as `pause_clock_scope`, so the enforcer thread and the
    copied worker context observe the same accumulator object."""

    def __init__(self, clock: CheckpointClock):
        self._clock = clock
        self._token = None

    def __enter__(self):
        self._token = _CKPT_CLOCK_VAR.set(self._clock)
        return self._clock

    def __exit__(self, *exc):
        _CKPT_CLOCK_VAR.reset(self._token)


def current_checkpoint_clock() -> CheckpointClock | None:
    return _CKPT_CLOCK_VAR.get()


def device_op(name: str):
    """Mark a function/method as a device-dispatching entry point.

    Every supervised engine invocation (Engine.run, Engine.run_reported,
    Engine.run_cycle, the scenario evaluator's batch and score, the
    watchdog probe) carries this marker so fault injection targets ops BY
    NAME.  Only the outermost marked call of a thread records: a marked
    method that calls another (run_reported -> run's route) is one call
    to the hook and one black-box pair."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if getattr(_NESTING, "depth", 0):
                return fn(*args, **kwargs)
            _NESTING.depth = 1
            try:
                return _dispatch(name, fn, args, kwargs)
            finally:
                _NESTING.depth = 0

        wrapper._device_op_name = name
        return wrapper

    return deco


_NESTING = threading.local()


def _dispatch(name: str, fn, args, kwargs):
    hook = _DEVICE_OP_HOOK
    if not _BLACKBOX.enabled:
        if hook is not None:
            return hook(name, fn, args, kwargs)
        return fn(*args, **kwargs)
    # black-box spool (common/blackbox.py): the Begin record is on disk
    # BEFORE anything that could block, including the memory read below;
    # the allocator's bytes in use (OOM post-mortems) ride the End record
    fields = {"op": name}
    if args:
        extra = getattr(args[0], "_blackbox_fields", None)
        if extra is not None:
            try:
                fields.update(extra())
            except Exception:  # noqa: BLE001 — telemetry only
                pass
    seq = _BLACKBOX.begin("device-op", **fields)
    try:
        if hook is not None:
            result = hook(name, fn, args, kwargs)
        else:
            result = fn(*args, **kwargs)
    except BaseException as e:  # noqa: BLE001 — recorded, re-raised
        _BLACKBOX.end(seq, ok=False, error=repr(e))
        raise
    mem = _memory_in_use()
    _BLACKBOX.end(seq, **({"mem_bytes": mem} if mem is not None else {}))
    return result


def _memory_in_use() -> int | None:
    """Bytes the caching allocator holds in live tensors on the visible
    cards, for the black-box record (None without a card).  A host-side
    read of the allocator's counters: it never waits for the device."""
    try:
        from cruise_control_tpu_torch.common.profiling import _memory_stat

        v = _memory_stat("allocated_bytes.all.current")
        return int(v) if v else None
    except Exception:  # noqa: BLE001 — telemetry, never the dispatch
        return None


_probe_op = device_op("probe")(_trivial_device_op)


def device_watchdog(timeout_s: float = 180.0, *, device=None) -> str | None:
    """None when `device` (the current CUDA device when None) answers a
    trivial op within the budget, else a diagnosis string (hang vs
    immediate failure).

    Runs the probe on a DAEMON thread so a hung runtime cannot block
    process exit either.  Waits on an event, not the thread: a probe that
    RAISES quickly (no card, a sticky CUDA error) reports immediately with
    the real exception instead of burning the full budget and claiming a
    hang.
    """
    done = threading.Event()
    result: dict = {}

    def probe():
        try:
            _probe_op(device)
            result["ok"] = True
        except BaseException as e:  # noqa: BLE001 — diagnosis, not control flow
            result["error"] = f"device probe failed: {e!r}"
        finally:
            done.set()

    t = threading.Thread(target=probe, daemon=True, name="device-watchdog")
    t.start()
    done.wait(timeout_s)
    if result.get("ok"):
        return None
    return result.get(
        "error", f"device unresponsive: trivial op did not complete in {timeout_s:.0f}s"
    )


# ----------------------------------------------------------------------
# failure taxonomy
# ----------------------------------------------------------------------


class FailureClass(enum.Enum):
    """How a supervised device call failed; drives retry + breaker policy."""

    HANG = "hang"  # deadline exhausted; the dispatch never returned
    COMPILE = "compile"  # the runtime rejected the program (a graph capture)
    OOM = "oom"  # out of device memory
    TRANSIENT = "transient"  # runtime-layer error expected to clear (retried)
    DEVICE_LOST = "device_lost"  # the card (or the process's context) is gone
    COLLECTIVE_STALL = "collective_stall"  # multi-device dispatch hung on
    # a subset of its mesh (survivors answer probes, suspects do not)


#: failure classes that name specific chips (the JAX package's mesh
#: failures; single-device supervision counts them like any other class)
MESH_FAILURE_CLASSES = frozenset(
    {FailureClass.DEVICE_LOST, FailureClass.COLLECTIVE_STALL}
)


class DeviceHangError(TimeoutError):
    """A supervised call did not complete within its budget."""

    def __init__(self, op: str, timeout_s: float):
        super().__init__(
            f"device op {op!r} did not complete within {timeout_s:.1f}s"
        )
        self.op = op
        self.timeout_s = timeout_s


class DeviceLostError(RuntimeError):
    """The runtime reported a device as gone.  `device_ids` names the
    cards when known; None when it only said 'a device'."""

    def __init__(self, msg: str, device_ids: tuple[int, ...] | None = None):
        super().__init__(msg)
        self.device_ids = tuple(device_ids) if device_ids else None


class CollectiveStallError(RuntimeError):
    """A multi-device dispatch hung while only a SUBSET of its mesh stopped
    answering per-device probes."""

    def __init__(self, msg: str, device_ids: tuple[int, ...] | None = None):
        super().__init__(msg)
        self.device_ids = tuple(device_ids) if device_ids else None


class DeviceDegradedError(RuntimeError):
    """A supervised call failed with a CLASSIFIED device failure (after any
    retries).  Carries the class + original cause so the caller can report
    why; `reason` is the class's value."""

    def __init__(
        self,
        op: str,
        failure_class: FailureClass,
        cause: BaseException,
        device_ids: tuple[int, ...] | None = None,
    ):
        super().__init__(f"device op {op!r} failed ({failure_class.value}): {cause!r}")
        self.op = op
        self.failure_class = failure_class
        self.reason = failure_class.value
        self.device_ids = tuple(device_ids) if device_ids else None
        self.__cause__ = cause


class BreakerOpenError(DeviceDegradedError):
    """The breaker is open and no probe closed it: the call was refused
    without touching the device.  `failure_class` is the class of the
    failure that opened the breaker; `reason` is "breaker-open"."""

    def __init__(self, op: str, failure_class: FailureClass):
        RuntimeError.__init__(
            self, f"device op {op!r} refused: the breaker is open ({failure_class.value})"
        )
        self.op = op
        self.failure_class = failure_class
        self.reason = "breaker-open"
        self.device_ids = None


#: cudaError_t codes of a `CudaLaunchError` that are conditions of the
#: card (CUDA runtime API, enum cudaError): the sticky errors, after which
#: every CUDA call of the process fails (cudaErrorECCUncorrectable 214,
#: IllegalAddress 700, LaunchTimeout 702, Assert 710, HardwareStackError
#: 714, IllegalInstruction 715, MisalignedAddress 716, InvalidAddressSpace
#: 717, InvalidPc 718, LaunchFailure 719); out of memory
#: (cudaErrorMemoryAllocation 2); the stream-capture errors (900-909); and
#: cudaErrorDevicesUnavailable 46, "busy or unavailable at the current
#: time" (another process holds a card in exclusive mode), the one code
#: worth a retry.  Any other code is an install fault or a wrapper's bug
#: (NoKernelImageForDevice 209, InvalidDeviceFunction 98, InvalidValue 1,
#: InvalidConfiguration 9, LaunchOutOfResources 701, ...): unclassified.
STICKY_CUDA_CODES = frozenset({214, 700, 702, 710, *range(714, 720)})
OOM_CUDA_CODES = frozenset({2})
CAPTURE_CUDA_CODES = frozenset(range(900, 910))
TRANSIENT_CUDA_CODES = frozenset({46})

#: CUDA's phrasings of the sticky errors (cudaGetErrorString, as PyTorch's
#: "CUDA error: ..." messages carry them), and the "this device is gone"
#: phrasings of the JAX package's taxonomy; checked before anything else,
#: so that no other marker of the same message can make them a retry,
#: which can never succeed in a dead context
_DEVICE_LOST_MARKERS = (
    "an illegal memory access was encountered", "device-side assert triggered",
    "unspecified launch failure", "misaligned address", "illegal instruction",
    "uncorrectable ECC", "the launch timed out and was terminated",
    "hardware stack error", "invalid program counter",
    "DEVICE_LOST", "device lost", "Device lost", "device is lost",
    "lost device", "device was removed",
)
_OOM_MARKERS = ("out of memory", "Out of memory", "CUDA_ERROR_OUT_OF_MEMORY",
                "CUBLAS_STATUS_ALLOC_FAILED")
_COMPILE_MARKERS = (
    "operation not permitted when stream is capturing", "stream capture",
    "capture invalidated", "during capture",
)
#: cudaErrorDevicesUnavailable's phrasing
_TRANSIENT_MARKERS = ("busy or unavailable",)
#: the CUDA runtime's, driver's and cuBLAS's error prefixes: a RuntimeError
#: carrying none of these is application code, whatever else it mentions
#: (a "device" in an argument check is not a device failure)
_RUNTIME_MARKERS = ("CUDA error", "CUDA driver error", "CUBLAS_STATUS", "cudaError", "CUresult")


def classify_failure(exc: BaseException) -> FailureClass | None:
    """Map an exception from a supervised call onto the failure taxonomy.

    None means "not a device failure": application errors (ValueError from
    input validation, bad request masks), install faults (a kernel library
    that does not build or load: `KernelBuildError`; an image the card
    cannot run) and a wrapper's bad launch must propagate to the caller
    untouched: counting them toward the breaker would let a malformed
    request degrade the service for everyone, and a retry cannot fix them.

    Classification is structural (type, then a launch's cudaError_t code)
    first, textual second: PyTorch raises CUDA's errors as RuntimeErrors
    whose class lives only in the message, and the fault harness injects
    lookalikes of the same shape.  Both are allow-lists: a CUDA error that
    names no condition of the card is None."""
    import torch

    from cruise_control_tpu_torch.kernels._build import CudaLaunchError, KernelBuildError

    if isinstance(exc, KernelBuildError):
        return None
    if isinstance(exc, DeviceHangError):
        return FailureClass.HANG
    if isinstance(exc, DeviceLostError):
        return FailureClass.DEVICE_LOST
    if isinstance(exc, CollectiveStallError):
        return FailureClass.COLLECTIVE_STALL
    if isinstance(exc, CudaLaunchError):
        if exc.code in STICKY_CUDA_CODES:
            return FailureClass.DEVICE_LOST
        if exc.code in OOM_CUDA_CODES:
            return FailureClass.OOM
        if exc.code in CAPTURE_CUDA_CODES:
            return FailureClass.COMPILE
        if exc.code in TRANSIENT_CUDA_CODES:
            return FailureClass.TRANSIENT
        return None
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return FailureClass.OOM
    if not isinstance(exc, RuntimeError):
        return None
    msg = str(exc)
    if any(m in msg for m in _DEVICE_LOST_MARKERS):
        return FailureClass.DEVICE_LOST
    if not any(m in msg for m in _RUNTIME_MARKERS):
        # a RuntimeError without the runtime's own markers: application code
        return None
    if any(m in msg for m in _OOM_MARKERS):
        return FailureClass.OOM
    if any(m in msg for m in _COMPILE_MARKERS):
        return FailureClass.COMPILE
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return FailureClass.TRANSIENT
    return None


def jittered_backoff_s(
    attempt: int,
    *,
    base_s: float,
    cap_s: float,
    rng: random.Random | None = None,
) -> float:
    """Full-jitter exponential backoff: uniform in (0, min(cap, base*2^n)].

    Shared by the supervisor's transient retries and the Kafka transport's
    reroute/reconnect retries; `rng` is injectable so tests pin the draw.
    """
    if attempt < 1:
        attempt = 1
    ceiling = min(cap_s, base_s * (2.0 ** (attempt - 1)))
    draw = (rng or random).random()
    # never 0: a zero sleep turns "backoff" into a hot retry loop
    return ceiling * max(draw, 0.05)


# ----------------------------------------------------------------------
# circuit breaker
# ----------------------------------------------------------------------


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Failure-count breaker with timed half-open probing.

    CLOSED counts consecutive operation-level failures; at
    `failure_threshold` it OPENs.  While OPEN, `probe_due()` turns true
    every `probe_interval_s`; the owner runs its health probe between
    `begin_probe()` and `probe_succeeded()`/`probe_failed()` (HALF_OPEN in
    between).  All transitions are lock-serialized — request threads and
    the precompute thread share one breaker."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        probe_interval_s: float = 30.0,
        clock=time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self._lock = threading.Lock()
        self._clock = clock
        self.failure_threshold = failure_threshold
        self.probe_interval_s = probe_interval_s
        self._state = BreakerState.CLOSED
        self._consecutive = 0
        self._next_probe_at = 0.0
        self._opened_at: float | None = None
        #: transitions into OPEN so far — consumers detect "opened again"
        #: by epoch comparison instead of registering callbacks
        self.open_epoch = 0

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def record_failure(self) -> bool:
        """Count one operation-level classified failure; True exactly when
        this failure transitions the breaker to OPEN."""
        with self._lock:
            self._consecutive += 1
            if self._state is BreakerState.CLOSED and (
                self._consecutive >= self.failure_threshold
            ):
                self._open_locked()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state is BreakerState.CLOSED:
                self._consecutive = 0

    def _open_locked(self) -> None:
        self._state = BreakerState.OPEN
        self.open_epoch += 1
        self._opened_at = self._clock()
        self._next_probe_at = self._opened_at + self.probe_interval_s

    def probe_due(self) -> bool:
        with self._lock:
            return (
                self._state is BreakerState.OPEN
                and self._clock() >= self._next_probe_at
            )

    def begin_probe(self) -> bool:
        """OPEN + due -> HALF_OPEN; False when another thread won the race
        (it is running the probe — this caller just sees OPEN)."""
        with self._lock:
            if self._state is not BreakerState.OPEN:
                return False
            if self._clock() < self._next_probe_at:
                return False
            self._state = BreakerState.HALF_OPEN
            return True

    def probe_succeeded(self) -> None:
        with self._lock:
            self._state = BreakerState.CLOSED
            self._consecutive = 0
            self._opened_at = None

    def probe_failed(self) -> None:
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                self._state = BreakerState.OPEN
            self._next_probe_at = self._clock() + self.probe_interval_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state.value,
                "consecutiveFailures": self._consecutive,
                "failureThreshold": self.failure_threshold,
                "openEpoch": self.open_epoch,
                "openForSeconds": (
                    round(self._clock() - self._opened_at, 1)
                    if self._opened_at is not None
                    else None
                ),
            }


# ----------------------------------------------------------------------
# supervisor
# ----------------------------------------------------------------------


class DeviceSupervisor:
    """Bounded, classified, breaker-guarded execution of device ops.

    One instance per service, shared by every optimizer and evaluator the
    service creates, so ad-hoc per-request optimizers and the precompute
    thread all feed the same breaker.  Thread-safe throughout.
    """

    def __init__(
        self,
        *,
        op_timeout_s: float = 300.0,
        max_retries: int = 2,
        retry_backoff_s: float = 0.25,
        retry_backoff_cap_s: float = 5.0,
        breaker_failure_threshold: int = 3,
        probe_interval_s: float = 30.0,
        probe_timeout_s: float = 20.0,
        sensors=None,
        probe=None,
        rng: random.Random | None = None,
        clock=time.monotonic,
        sleep=time.sleep,
        tracer=None,
        device=None,
    ):
        """probe: () -> str | None (None = healthy) — defaults to
        `default_probe`: no abandoned call still running, then the
        trivial-op watchdog on `device` (the current CUDA device when
        None) under `probe_timeout_s`; injectable for tests, as the whole
        health verdict.  rng feeds
        the retry jitter; clock/sleep are injectable so breaker timing
        tests run without wall-clock waits.  tracer: flight recorder every
        supervised call opens a `device.<op>` span on (retries, classified
        failures and breaker transitions become span events); defaults to
        the process-wide common.trace.TRACER."""
        if op_timeout_s <= 0:
            raise ValueError(f"op_timeout_s must be > 0, got {op_timeout_s}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.op_timeout_s = op_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_failure_threshold,
            probe_interval_s=probe_interval_s,
            clock=clock,
        )
        self.probe_timeout_s = probe_timeout_s
        self.device = device
        self._probe = probe or self.default_probe
        self._probe_lock = threading.Lock()
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._lock = threading.Lock()
        self.sensors = sensors
        from cruise_control_tpu_torch.common.trace import TRACER

        self.tracer = tracer if tracer is not None else TRACER
        self._failure_counts: dict[FailureClass, int] = {c: 0 for c in FailureClass}
        self.last_failure: dict | None = None
        #: a DEVICE_LOST failure was classified: on one card a sticky CUDA
        #: error, after which every CUDA call of the process fails, so
        #: nothing may free the card's resources any more
        #: (`GoalOptimizer._maybe_purge_after_open`); the process needs a
        #: restart to use the card again
        self.context_lost = False
        #: the class of the failure that last opened the breaker
        self.opened_by: FailureClass | None = None
        #: worker threads of calls abandoned at their deadline
        #: (`_bounded`), pruned as they return
        self._abandoned: list[threading.Thread] = []
        self.num_retries = 0
        self.num_probes = 0
        self.num_probe_failures = 0
        if sensors is not None:
            # 0 closed / 0.5 probing / 1 open
            sensors.gauge(
                "analyzer.supervisor.breaker-state",
                lambda: {"closed": 0.0, "half_open": 0.5, "open": 1.0}[
                    self.breaker.state.value
                ],
            )

    # -- classification-side bookkeeping --------------------------------

    def _count(self, cls: FailureClass, op: str, exc: BaseException) -> None:
        with self._lock:
            self._failure_counts[cls] += 1
            if cls is FailureClass.DEVICE_LOST:
                self.context_lost = True
            self.last_failure = {
                "op": op,
                "class": cls.value,
                "error": repr(exc),
                "ms": int(time.time() * 1000),
            }
        if self.sensors is not None:
            self.sensors.counter(f"analyzer.supervisor.failures.{cls.value}").inc()

    # -- bounded call ---------------------------------------------------

    def _bounded(self, fn, op: str, timeout_s: float):
        """Run fn on a daemon thread with a hard deadline.

        The deadline fires DeviceHangError on the caller; the worker (and
        whatever device dispatch it is stuck in) is abandoned — a wedged
        card cannot be interrupted, only outlived — and kept in
        `_abandoned`, which holds the breaker open until it returns
        (`default_probe`).  The engine it holds pinned is released only at
        its last unpin (the optimizer's cache), so a late completion
        cannot touch freed memory."""
        done = threading.Event()
        box: dict = {}
        # the worker runs with the CALLER'S context copied in: the device
        # scheduler's grants (the segmented-execution seam, the pause
        # clock) and the black-box context are contextvars and must
        # survive this thread hop — a fresh context would silently run a
        # preemptible dispatch unsegmented
        ctx = contextvars.copy_context()

        def worker():
            try:
                box["result"] = ctx.run(fn)
            except BaseException as e:  # noqa: BLE001 — re-raised on the caller
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True, name=f"supervised-{op}")
        # black-box Begin BEFORE the worker starts; the abandonment
        # verdict below (the one outcome the in-worker device-op record
        # can never write) closes the pair.  No device query on this
        # thread: it is the one enforcing the deadline.
        bb_seq = _BLACKBOX.begin("supervised", op=op, timeout_s=round(timeout_s, 3))
        t.start()
        # the deadline is extended by scheduler-imposed pause and by
        # carry-checkpoint capture: a dispatch parked at a preemption
        # checkpoint is healthy
        pause = _current_pause_clock()
        ckpt = current_checkpoint_clock()
        if ckpt is not None:
            prev = pause
            pause = (
                ckpt.seconds
                if prev is None
                else (lambda p=prev, c=ckpt.seconds: p() + c())
            )
        try:
            if pause is None:
                if not done.wait(timeout_s):
                    raise DeviceHangError(op, timeout_s)
            else:
                base = pause()
                deadline = time.monotonic() + timeout_s
                while True:
                    remaining = deadline + max(0.0, pause() - base) - time.monotonic()
                    if remaining <= 0:
                        raise DeviceHangError(op, timeout_s)
                    if done.wait(min(remaining, 0.5)):
                        break
        except DeviceHangError:
            with self._lock:
                self._abandoned.append(t)
            _BLACKBOX.end(bb_seq, ok=False, hang=True, abandoned=True)
            raise
        if "error" in box:
            _BLACKBOX.end(bb_seq, ok=False, error=repr(box["error"]))
            raise box["error"]
        _BLACKBOX.end(bb_seq)
        return box.get("result")

    def call(self, fn, *, op: str = "optimize", timeout_s: float | None = None):
        """Run fn under the supervision contract.

        Success resets the breaker's consecutive count.  Classified
        failures: TRANSIENT retries up to `max_retries` with full-jitter
        backoff; exhausted/unretryable failures count one operation-level
        failure toward the breaker and raise DeviceDegradedError.
        Unclassified exceptions propagate unchanged and touch nothing."""
        budget = timeout_s if timeout_s is not None else self.op_timeout_s
        brk = self.breaker
        with self.tracer.span(f"device.{op}", component="device", timeout_s=budget) as sp:
            attempt = 0
            while True:
                try:
                    result = self._bounded(fn, op, budget)
                except BaseException as e:  # noqa: BLE001 — classified below
                    cls = classify_failure(e)
                    if cls is None:
                        raise
                    self._count(cls, op, e)
                    sp.event("failure", failure_class=cls.value, error=repr(e))
                    if cls is FailureClass.TRANSIENT and attempt < self.max_retries:
                        attempt += 1
                        with self._lock:
                            self.num_retries += 1
                        if self.sensors is not None:
                            self.sensors.counter("analyzer.supervisor.retries").inc()
                        backoff = jittered_backoff_s(
                            attempt,
                            base_s=self.retry_backoff_s,
                            cap_s=self.retry_backoff_cap_s,
                            rng=self._rng,
                        )
                        sp.event("retry", attempt=attempt, backoff_s=round(backoff, 4))
                        self._sleep(backoff)
                        continue
                    if brk.record_failure():
                        # a breaker flip is THE degradation moment
                        self.opened_by = cls
                        sp.event("breaker-opened", open_epoch=brk.open_epoch)
                        if self.sensors is not None:
                            self.sensors.counter("analyzer.supervisor.breaker-opened").inc()
                    sp.set(attempts=attempt + 1, failure_class=cls.value)
                    raise DeviceDegradedError(op, cls, e, getattr(e, "device_ids", None)) from e
                brk.record_success()
                sp.set(attempts=attempt + 1)
                return result

    def run(self, fn, *, op: str, degraded=None, timeout_s: float | None = None):
        """The supervised route of a device path, the one policy of its
        callers (the optimizer's `optimize` and `prewarm`, the evaluator's
        batch and `score_state`).

        While the breaker is open (and no probe closes it: `available`)
        `fn` is not run; otherwise it runs under `call`.  An open breaker
        is `BreakerOpenError`, a classified failure `DeviceDegradedError`:
        raised, or answered by `degraded(reason, cause)` where the caller
        passes it (cause None for an open breaker).  A caller passes
        `degraded` only for work that may be skipped (a prewarm) or whose
        tensors already lie on the host (a CPU optimizer or evaluator):
        work on the card is never answered from the CPU."""
        if not self.available():
            if degraded is None:
                raise BreakerOpenError(op, self.opened_by)
            return degraded("breaker-open", None)
        try:
            return self.call(fn, op=op, timeout_s=timeout_s)
        except DeviceDegradedError as e:
            if degraded is None:
                raise
            return degraded(e.reason, e)

    # -- availability / half-open probing -------------------------------

    def abandoned_running(self) -> int:
        """Calls abandoned at their deadline whose worker still runs."""
        with self._lock:
            self._abandoned = [t for t in self._abandoned if t.is_alive()]
            return len(self._abandoned)

    def default_probe(self) -> str | None:
        """The health verdict of a half-open probe: a failure while a call
        abandoned at its deadline still runs (its work may still occupy
        the card, and a recovery would queue behind it and hang in turn),
        else the trivial-op watchdog on the supervised device."""
        running = self.abandoned_running()
        if running:
            return f"{running} abandoned device call(s) still running"
        return device_watchdog(self.probe_timeout_s, device=self.device)

    @property
    def is_degraded(self) -> bool:
        return self.breaker.state is not BreakerState.CLOSED

    def available(self) -> bool:
        """True when the device path should be attempted.

        While the breaker is OPEN this is where recovery happens: once per
        `probe_interval_s` ONE caller runs the trivial-op watchdog
        (HALF_OPEN during the probe); a healthy probe closes the breaker
        and the call proceeds on the device, a failed one re-arms the
        probe timer and the caller stays degraded.  Lazy probing keeps the
        supervisor threadless — the callers' own traffic provides the
        cadence."""
        if self.breaker.state is BreakerState.CLOSED:
            return True
        if not self._probe_lock.acquire(blocking=False):
            return False  # another thread is probing right now
        try:
            if not self.breaker.begin_probe():
                return False
            with self._lock:
                self.num_probes += 1
            if self.sensors is not None:
                self.sensors.counter("analyzer.supervisor.probes").inc()
            # a recovery probe is its own root span: it runs on whatever
            # request thread happened to poll availability
            with self.tracer.span("device.probe", component="device", root=True) as sp:
                try:
                    diagnosis = self._probe()
                except BaseException as e:  # noqa: BLE001 — a raising probe is a failed probe
                    diagnosis = repr(e)
                if diagnosis is None:
                    self.breaker.probe_succeeded()
                    sp.event("breaker-closed", open_epoch=self.breaker.open_epoch)
                    sp.set(healthy=True)
                    if self.sensors is not None:
                        self.sensors.counter("analyzer.supervisor.probe-successes").inc()
                    return True
                self.breaker.probe_failed()
                sp.set(healthy=False, diagnosis=diagnosis)
                with self._lock:
                    self.num_probe_failures += 1
                    self.last_failure = {
                        "op": "probe",
                        "class": FailureClass.HANG.value,
                        "error": diagnosis,
                        "ms": int(time.time() * 1000),
                    }
                if self.sensors is not None:
                    self.sensors.counter("analyzer.supervisor.probe-failures").inc()
                return False
        finally:
            self._probe_lock.release()

    @property
    def open_epoch(self) -> int:
        return self.breaker.open_epoch

    def state_json(self) -> dict:
        """The /state `AnalyzerState.supervisor` block."""
        with self._lock:
            counts = {c.value: n for c, n in self._failure_counts.items()}
            last = dict(self.last_failure) if self.last_failure else None
            retries, probes, probe_failures = (
                self.num_retries, self.num_probes, self.num_probe_failures,
            )
        out = self.breaker.snapshot()
        out["breaker"] = out.pop("state")
        out.update(
            opTimeoutSeconds=self.op_timeout_s,
            failureCounts=counts,
            lastFailure=last,
            numRetries=retries,
            numProbes=probes,
            numProbeFailures=probe_failures,
            contextLost=self.context_lost,
        )
        return out
