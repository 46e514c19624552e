"""The port's supervised runtime (common/device_watchdog.py) and its flagged
degraded routes, on the CPU.

tests/test_faults.py's tests that need no service (:48-:289) are pointed
at the port here, name for name, with `device="cpu"` and the port's
testing/faults.py, whose injected errors carry CUDA's phrasings.  The port
adds: the CUDA taxonomy case by case (the cudaError_t codes of a
`CudaLaunchError` and CUDA's phrasings, an allow-list: install faults,
a wrapper's bad launch and plain application errors pass through
unclassified); the degraded route against the JAX package's on the same
injected OOM; the card's route, which raises and never answers from the
CPU (a state whose device reads as another than the CPU); a call
abandoned at its deadline holding the breaker open; a supervised
BACKGROUND optimize under the device scheduler still segmented; the
scenario evaluator's supervised routes; and tests/test_blackbox.py :242's
hang trail against the port's optimizer.  At the end, the three
`supervised_service` tests (:436, :499, :511) over the port's simulated
service on the CPU, which answers as the JAX package does (a flagged
greedy proposal); the acceptance story waits for the abandoned worker
before the recovering call, since the port holds the breaker open until
it returns.  Last, tests/test_blackbox.py :187, the analyzer core turning
the process's recorder off.
"""

import dataclasses
import random
import threading
import time

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizationOptions, ScenarioEvaluator
from cruise_control_tpu_torch.analyzer.engine import OptimizerConfig
from cruise_control_tpu_torch.analyzer.greedy import greedy_optimize
from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN
from cruise_control_tpu_torch.common.blackbox import RECORDER, in_flight_from_records, read_spool
from cruise_control_tpu_torch.common.device_watchdog import (
    BreakerOpenError,
    BreakerState,
    CircuitBreaker,
    DeviceDegradedError,
    DeviceHangError,
    DeviceSupervisor,
    FailureClass,
    classify_failure,
    device_watchdog,
    jittered_backoff_s,
)
from cruise_control_tpu_torch.common.sensors import SensorRegistry
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT
from cruise_control_tpu_torch.fleet.scheduler import DeviceScheduler, WorkClass
from cruise_control_tpu_torch.kernels._build import CudaLaunchError, KernelBuildError
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.planner import Rightsizer, Scenario
from cruise_control_tpu_torch.testing import faults
from cruise_control_tpu_torch.testing.fixtures import dead_broker_cluster, small_cluster
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.service.progress import OperationProgress

FAST_CFG = OptimizerConfig(
    num_candidates=64, leadership_candidates=16, swap_candidates=16,
    steps_per_round=8, num_rounds=2,
)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


# ------------------------------------------------------------ classification


def test_classification_taxonomy():
    """tests/test_faults.py:48."""
    assert classify_failure(ValueError("bad mask")) is None
    assert classify_failure(KeyError("x")) is None
    assert classify_failure(DeviceHangError("optimize", 1.0)) is FailureClass.HANG
    assert classify_failure(MemoryError()) is FailureClass.OOM
    assert classify_failure(faults.transient_error("op")) is FailureClass.TRANSIENT
    assert classify_failure(faults.oom_error("op")) is FailureClass.OOM
    assert classify_failure(faults.compile_error("op")) is FailureClass.COMPILE
    # a plain RuntimeError with no runtime-layer markers is application code
    assert classify_failure(RuntimeError("business logic broke")) is None


#: (exception, class): every cudaError_t code and CUDA phrasing the
#: taxonomy names, and the errors that must stay unclassified: install
#: faults (an image for another arch, a missing device function), a
#: wrapper's bad launch (invalid value or configuration, too many
#: resources), codes no source shows to be conditions of the card
CUDA_CASES = {
    "code-2-oom": (CudaLaunchError(2, "candidates"), FailureClass.OOM),
    **{f"code-{c}-sticky": (CudaLaunchError(c, "apply_moves"), FailureClass.DEVICE_LOST)
       for c in (214, 700, 702, 710, 714, 715, 716, 717, 718, 719)},
    **{f"code-{c}-capture": (CudaLaunchError(c, "loop graph build"), FailureClass.COMPILE)
       for c in range(900, 910)},
    **{f"code-{c}-other": (CudaLaunchError(c, "select_survivors"), None)
       for c in (1, 98, 209, 701, 720, 999)},
    **{f"code-{c}-other": (CudaLaunchError(c, "candidates"), None) for c in (9, 200)},
    "code-46-busy": (CudaLaunchError(46, "candidates"), FailureClass.TRANSIENT),
    "busy": (RuntimeError("CUDA error: all CUDA-capable devices are busy or unavailable"),
             FailureClass.TRANSIENT),
    "torch-oom": (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 80.00 GiB. GPU 0 has a total capacity of "
        "79.19 GiB of which 78.41 GiB is free."), FailureClass.OOM),
    "illegal-address": (RuntimeError(
        "CUDA error: an illegal memory access was encountered\nCUDA kernel errors might be "
        "asynchronously reported at some other API call"), FailureClass.DEVICE_LOST),
    "device-assert": (RuntimeError(
        "CUDA error: device-side assert triggered\nCompile with `TORCH_USE_CUDA_DSA` to "
        "enable device-side assertions."), FailureClass.DEVICE_LOST),
    "device-assert-accelerator": (torch.AcceleratorError(
        "CUDA error: device-side assert triggered"), FailureClass.DEVICE_LOST),
    "launch-failure": (RuntimeError("CUDA error: unspecified launch failure"),
                       FailureClass.DEVICE_LOST),
    "misaligned": (RuntimeError("CUDA error: misaligned address"), FailureClass.DEVICE_LOST),
    "illegal-instruction": (RuntimeError("CUDA error: an illegal instruction was encountered"),
                            FailureClass.DEVICE_LOST),
    "ecc": (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
            FailureClass.DEVICE_LOST),
    "capturing": (RuntimeError("CUDA error: operation not permitted when stream is capturing"),
                  FailureClass.COMPILE),
    "capture-invalidated": (RuntimeError(
        "CUDA error: operation failed due to a previous error during capture"),
        FailureClass.COMPILE),
    "text-oom": (RuntimeError("CUDA error: out of memory"), FailureClass.OOM),
    "invalid-argument": (RuntimeError("CUDA error: invalid argument"), None),
    "cublas": (RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasSgemm`"),
               None),
    "cublas-alloc": (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                                  "`cublasCreate(handle)`"), FailureClass.OOM),
    "no-kernel-image": (RuntimeError(
        "CUDA error: no kernel image is available for execution on the device\nCUDA kernel "
        "errors might be asynchronously reported at some other API call"), None),
    "invalid-device-function": (RuntimeError("CUDA error: invalid device function"), None),
    "too-many-resources": (RuntimeError("CUDA error: too many resources requested for launch"),
                           None),
    "build-error": (KernelBuildError(
        "CUDA kernel build failed:\n--- candidates.cu (nvcc exit 1)\ncandidates.cu(12): error: "
        "identifier \"x\" is undefined in device code\ncompilation terminated.\nCUDA error"),
        None),
    "nvcc-missing": (KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit"),
                     None),
    "no-device": (RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU"),
                  None),
    "plain-device": (RuntimeError("the kernel's inputs lie on another device"), None),
    "conditional-graphs": (RuntimeError(
        "loop graph, which needs CUDA 12.4 or later in the runtime and the driver; found "
        "runtime 12020, driver 12040"), None),
}


@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_taxonomy(name):
    exc, cls = CUDA_CASES[name]
    assert classify_failure(exc) is cls


@pytest.mark.parametrize("exc", [
    KernelBuildError("CUDA kernel build failed:\n--- apply.cu (nvcc exit 2)\ndevice"),
    RuntimeError("the device rejected the request: broker 7 is not in the model"),
    CudaLaunchError(209, "candidates"),
    CudaLaunchError(98, "apply_moves"),
    CudaLaunchError(701, "select_survivors"),
    RuntimeError("CUDA error: no kernel image is available for execution on the device"),
], ids=["kernel-build-error", "plain-device-runtime-error", "no-image-209",
        "invalid-function-98", "out-of-resources-701", "no-kernel-image-text"])
def test_install_and_application_errors_pass_through_supervisor(exc):
    """An install fault, a wrapper's launch that the card refuses and an
    application error that mentions a device go through
    `DeviceSupervisor.call` unchanged: not retried, nothing counted, the
    breaker untouched."""
    sensors = SensorRegistry()
    sup = DeviceSupervisor(op_timeout_s=5.0, max_retries=3, breaker_failure_threshold=1,
                           sensors=sensors, sleep=lambda s: None)
    calls = []

    def fail():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)) as ei:
        sup.call(fail, op="optimize")
    assert ei.value is exc
    assert calls == [1] and sup.num_retries == 0
    assert sup.breaker.state is BreakerState.CLOSED and sup.breaker.consecutive_failures == 0
    assert sup.last_failure is None
    assert not [n for n in sensors.snapshot() if n.startswith("analyzer.supervisor.failures")]


@pytest.mark.parametrize("exc", [
    CudaLaunchError(710, "candidates"),
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
], ids=["code-710", "assert", "illegal-address", "launch-failure"])
def test_sticky_errors_are_device_lost_and_never_retried(exc):
    sup = DeviceSupervisor(op_timeout_s=5.0, max_retries=3, breaker_failure_threshold=1,
                           sleep=lambda s: None)
    calls = []

    def fail():
        calls.append(1)
        raise exc

    with pytest.raises(DeviceDegradedError) as ei:
        sup.call(fail, op="optimize")
    assert ei.value.failure_class is FailureClass.DEVICE_LOST
    assert calls == [1] and sup.num_retries == 0
    assert sup.breaker.state is BreakerState.OPEN


def test_jittered_backoff_bounds_and_determinism():
    """tests/test_faults.py:60."""
    rng = random.Random(7)
    draws = [
        jittered_backoff_s(a, base_s=0.1, cap_s=1.0, rng=rng) for a in (1, 2, 3, 8)
    ]
    ceilings = [0.1, 0.2, 0.4, 1.0]
    for d, c in zip(draws, ceilings):
        assert 0.0 < d <= c
    # seeded rng pins the exact sequence
    rng2 = random.Random(7)
    assert draws == [
        jittered_backoff_s(a, base_s=0.1, cap_s=1.0, rng=rng2) for a in (1, 2, 3, 8)
    ]


def test_fault_schedule_keying():
    """tests/test_faults.py:74."""
    s = faults.FaultSchedule(calls=(0, 2))
    assert [s.fires(n) for n in range(4)] == [True, False, True, False]
    w = faults.FaultSchedule(after=1, limit=2)
    assert [w.fires(n) for n in range(4)] == [False, True, True, False]
    r1 = faults.FaultSchedule(rate=0.5, seed=3)
    r2 = faults.FaultSchedule(rate=0.5, seed=3)
    pattern = [r1.fires(n) for n in range(64)]
    assert pattern == [r2.fires(n) for n in range(64)]  # seeded: reproducible
    assert any(pattern) and not all(pattern)
    assert [faults.first(2).fires(n) for n in range(3)] == [True, True, False]


# ------------------------------------------------------------ circuit breaker


def test_breaker_transitions():
    """tests/test_faults.py:90."""
    clock = [0.0]
    b = CircuitBreaker(failure_threshold=2, probe_interval_s=10.0, clock=lambda: clock[0])
    assert b.state is BreakerState.CLOSED
    assert not b.record_failure()
    b.record_success()  # success resets the consecutive count
    assert not b.record_failure()
    assert b.record_failure()  # second consecutive -> opens
    assert b.state is BreakerState.OPEN and b.open_epoch == 1
    assert not b.probe_due()  # interval not elapsed
    clock[0] = 11.0
    assert b.probe_due() and b.begin_probe()
    assert b.state is BreakerState.HALF_OPEN
    b.probe_failed()
    assert b.state is BreakerState.OPEN
    assert not b.probe_due()  # re-armed
    clock[0] = 22.0
    assert b.begin_probe()
    b.probe_succeeded()
    assert b.state is BreakerState.CLOSED and b.consecutive_failures == 0
    # reopen bumps the epoch (edge-trigger for anomaly reporting)
    assert b.record_failure() is False and b.record_failure() is True
    assert b.open_epoch == 2


# ------------------------------------------------------------ supervisor


def test_supervised_hang_is_bounded():
    """tests/test_faults.py:118."""
    sup = DeviceSupervisor(op_timeout_s=0.2, breaker_failure_threshold=1)
    t0 = time.monotonic()
    with pytest.raises(DeviceDegradedError) as ei:
        sup.call(lambda: time.sleep(30), op="optimize")
    assert time.monotonic() - t0 < 5.0  # nowhere near the 30s hang
    assert ei.value.failure_class is FailureClass.HANG
    assert sup.breaker.state is BreakerState.OPEN


def test_transient_retries_with_backoff_then_success():
    """tests/test_faults.py:128."""
    sleeps: list[float] = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise faults.transient_error("flaky")
        return "ok"

    sensors = SensorRegistry()
    sup = DeviceSupervisor(
        op_timeout_s=5.0, max_retries=2, retry_backoff_s=0.01,
        sensors=sensors, sleep=sleeps.append, rng=random.Random(0),
    )
    assert sup.call(flaky, op="optimize") == "ok"
    assert calls["n"] == 3 and len(sleeps) == 2
    assert all(0 < s <= 0.02 * 2 for s in sleeps)
    assert sup.breaker.state is BreakerState.CLOSED  # success reset it
    assert sensors.counter("analyzer.supervisor.retries").count == 2
    assert sensors.counter("analyzer.supervisor.failures.transient").count == 2


def test_transient_retries_exhausted_counts_one_breaker_failure():
    """tests/test_faults.py:152."""
    sup = DeviceSupervisor(
        op_timeout_s=5.0, max_retries=1, retry_backoff_s=0.001,
        breaker_failure_threshold=2, sleep=lambda s: None,
    )

    def always_transient():
        raise faults.transient_error("x")

    with pytest.raises(DeviceDegradedError):
        sup.call(always_transient, op="optimize")
    # two raises (original + retry) but ONE operation-level breaker count
    assert sup.breaker.consecutive_failures == 1
    assert sup.breaker.state is BreakerState.CLOSED


def test_unclassified_errors_propagate_untouched():
    """tests/test_faults.py:168."""
    sup = DeviceSupervisor(op_timeout_s=5.0, breaker_failure_threshold=1)

    def bad_request():
        raise ValueError("broker ids [99] are not in the cluster model")

    with pytest.raises(ValueError):
        sup.call(bad_request, op="optimize")
    assert sup.breaker.state is BreakerState.CLOSED
    assert sup.breaker.consecutive_failures == 0


def test_probe_recovery_closes_breaker():
    """tests/test_faults.py:180."""
    probe_results = ["wedged", "wedged", None]  # two failed probes, then healthy
    sup = DeviceSupervisor(
        op_timeout_s=0.1, breaker_failure_threshold=1, probe_interval_s=0.0,
        probe=lambda: probe_results.pop(0),
    )
    with pytest.raises(DeviceDegradedError):
        sup.call(lambda: time.sleep(5), op="optimize")
    assert sup.is_degraded
    assert not sup.available()  # probe 1 fails
    assert not sup.available()  # probe 2 fails
    assert sup.available()  # probe 3 heals -> closed
    assert sup.breaker.state is BreakerState.CLOSED
    assert sup.num_probes == 3 and sup.num_probe_failures == 2
    js = sup.state_json()
    assert js["breaker"] == "closed" and js["numProbeFailures"] == 2


def test_device_watchdog_wedges_under_harness():
    """tests/test_faults.py:198, the probe on the CPU (device="cpu")."""
    with faults.device_wedged(ops=(faults.PROBE_OP,)):
        diagnosis = device_watchdog(timeout_s=0.1, device="cpu")
    assert diagnosis is not None and "did not complete" in diagnosis
    assert device_watchdog(timeout_s=30.0, device="cpu") is None  # fault cleared


def test_default_probe_without_a_card_fails_rather_than_runs_on_the_cpu(monkeypatch):
    """The supervisor's default probe runs on the card: with no card and no
    device named, it reports a failure, never a healthy CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    diagnosis = device_watchdog(timeout_s=30.0)
    assert diagnosis is not None and "no CUDA device" in diagnosis


# ------------------------------------------------------------ supervised optimizer


def _supervised_optimizer(**sup_kwargs):
    # op_timeout generous: a post-purge rebuild must never be
    # misclassified as a hang in these tests
    defaults = dict(
        op_timeout_s=120.0, max_retries=0, breaker_failure_threshold=1,
        probe_interval_s=0.0, probe=lambda: None,
    )
    defaults.update(sup_kwargs)
    sensors = SensorRegistry()
    sup = DeviceSupervisor(sensors=sensors, **defaults)
    opt = GoalOptimizer(
        config=FAST_CFG, supervisor=sup, degraded_budget_s=10.0, sensors=sensors, device="cpu",
    )
    return opt, sup, sensors


def test_injected_oom_degrades_and_recovery_restores_device_path():
    """tests/test_faults.py:220."""
    opt, sup, sensors = _supervised_optimizer()
    state = small_cluster("cpu")
    with faults.device_oom(schedule=faults.first(1)) as log:
        r = opt.optimize(state)
        assert r.degraded and sup.is_degraded
        assert log.fired["engine.run"] == 1
    rec = r.history[0]
    assert rec["degraded"] and rec["reason"] == "oom"
    assert sensors.counter("analyzer.supervisor.failures.oom").count == 1
    assert sensors.counter("analyzer.degraded-proposals").count == 1
    # the greedy answer is a usable proposal set over the same model
    assert r.summary()["degraded"] is True
    assert r.balancedness_after >= r.balancedness_before - 1e-6
    # fault gone: probe heals on the next call, device path resumes
    r2 = opt.optimize(state)
    assert not r2.degraded and not sup.is_degraded


def test_breaker_open_skips_device_entirely():
    """tests/test_faults.py:240."""
    opt, sup, _ = _supervised_optimizer(probe=lambda: "still wedged")
    state = small_cluster("cpu")
    with faults.xla_errors(schedule=faults.first(1)) as log:
        assert opt.optimize(state).degraded
        fired_during_fault = log.total_fired
        # breaker is open and the probe keeps failing: no engine invocation
        assert opt.optimize(state).degraded
        assert log.calls.get("engine.run", 0) == fired_during_fault == 1


def test_engine_cache_purged_on_breaker_open():
    """tests/test_faults.py:251."""
    opt, sup, _ = _supervised_optimizer()
    state = small_cluster("cpu")
    assert not opt.optimize(state).degraded
    assert opt.has_engine_for(state.shape, config=FAST_CFG)
    with faults.xla_errors(schedule=faults.first(1)):
        assert opt.optimize(state).degraded
    # open transition dropped the engines (a failed card's buffers)
    assert not opt.has_engine_for(state.shape, config=FAST_CFG)
    assert not opt.optimize(state).degraded  # rebuilt fresh after recovery
    assert opt.has_engine_for(state.shape, config=FAST_CFG)


def test_degraded_mode_honors_exclusion_masks():
    """tests/test_faults.py:264: a DEGRADED self-healing fix keeps its
    exclusion contract: the greedy fallback never lands replicas or
    leadership on excluded brokers (recently removed/demoted)."""
    opt, sup, _ = _supervised_optimizer()
    state = small_cluster("cpu")
    excl = np.zeros(state.shape.B, bool)
    excl[2] = True
    options = OptimizationOptions(
        excluded_brokers_for_replica_move=excl,
        excluded_brokers_for_leadership=excl,
    )
    r = opt._optimize_degraded(state, options, FAST_CFG, reason="test")
    assert r.degraded
    for p in list(r.proposals):
        assert 2 not in set(p.new_replicas) - set(p.old_replicas)
        if p.new_leader != p.old_leader:
            assert p.new_leader != 2


def test_application_error_propagates_not_degraded():
    """tests/test_faults.py:284."""
    opt, sup, _ = _supervised_optimizer()
    state = small_cluster("cpu")
    bad_broker = state.replica_broker.clone()
    bad_broker[0] = state.shape.B + 7  # out of range: the input checks reject it
    bad = dataclasses.replace(state, replica_broker=bad_broker)
    with pytest.raises(ValueError):
        opt.optimize(bad)
    assert sup.breaker.state is BreakerState.CLOSED and sup.last_failure is None


def test_degraded_route_rejects_an_invalid_state():
    """The degraded route keeps the device path's input contract: an
    invalid state raises instead of being greedily "optimized"."""
    opt, sup, _ = _supervised_optimizer()
    state = small_cluster("cpu")
    bad_broker = state.replica_broker.clone()
    bad_broker[0] = state.shape.B + 7
    with pytest.raises(ValueError):
        opt._optimize_degraded(dataclasses.replace(state, replica_broker=bad_broker),
                               OptimizationOptions(), FAST_CFG, reason="test")


def test_unsupervised_error_raises_unchanged():
    """Without a supervisor nothing changes: an error injected on
    "engine.run" raises from optimize as it was raised, and no degraded
    answer exists."""
    opt = GoalOptimizer(config=FAST_CFG, device="cpu")
    state = small_cluster("cpu")
    err = faults.oom_error("engine.run")

    def raise_err(op, fn, args, kwargs):
        raise err

    with faults.device_fault(raise_err):
        with pytest.raises(type(err)) as ei:
            opt.optimize(state)
    assert ei.value is err
    assert not opt.optimize(state).degraded


@pytest.fixture
def on_a_card(monkeypatch):
    """`move(obj, ...)`: from then on states, and each optimizer or
    evaluator given, read as lying on a card (the "meta" device) while
    their tensors stay on the CPU, so that the card's supervised route is
    driven here; the device path itself is each test's stand-in.  The
    CPU answers must not run."""
    import cruise_control_tpu_torch.analyzer.optimizer as optimizer_mod

    card = torch.device("meta")

    def move(*objs):
        monkeypatch.setattr(ClusterState, "device", property(lambda s: card))
        monkeypatch.setattr(optimizer_mod, "greedy_optimize",
                            lambda *a, **kw: pytest.fail("the card's work was answered on the CPU"))
        for obj in objs:
            obj.device = card
            if isinstance(obj, ScenarioEvaluator):
                obj._evaluate_cpu = lambda hosts: pytest.fail("the card's batch scored on the CPU")

    return move


@pytest.mark.parametrize("effect,cls", [
    (faults.oom_error, FailureClass.OOM),
    (faults.device_lost_error, FailureClass.DEVICE_LOST),
], ids=["oom", "sticky"])
def test_card_failure_raises_instead_of_a_cpu_answer(on_a_card, effect, cls):
    """On the card a classified failure of the device path raises
    `DeviceDegradedError` with its class and cause: no greedy answer, no
    retry of a sticky error, the breaker open and the engines purged."""
    opt, sup, sensors = _supervised_optimizer(probe=lambda: "down", max_retries=2)
    state = small_cluster("cpu")
    opt.optimize(state)  # healthy, on the CPU: an engine cached
    on_a_card(opt)
    err = effect("engine.run")
    calls = []

    def failing_device_path(*a, **kw):
        calls.append(1)
        raise err

    opt._optimize_on_device = failing_device_path
    with pytest.raises(DeviceDegradedError) as ei:
        opt.optimize(state)
    assert ei.value.failure_class is cls and ei.value.reason == cls.value
    assert ei.value.__cause__ is err
    assert calls == [1] and sup.num_retries == 0
    assert sup.breaker.state is BreakerState.OPEN and sup.opened_by is cls
    assert not opt.has_engine_for(state.shape, config=FAST_CFG)
    assert sensors.counter("analyzer.degraded-proposals").count == 0


def test_card_breaker_open_raises_without_touching_the_device(on_a_card):
    """With the breaker open and the probe failing, `optimize` on the card
    raises `BreakerOpenError` (reason "breaker-open", the class that
    opened it) and does not enter the device path; once the probe heals,
    the device path answers again."""
    verdict = ["down"]
    opt, sup, _ = _supervised_optimizer(probe=lambda: verdict[0])
    on_a_card(opt)
    state = small_cluster("cpu")
    calls = []

    def device_path(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise faults.oom_error("engine.run")
        return "the card's answer"

    opt._optimize_on_device = device_path
    with pytest.raises(DeviceDegradedError):
        opt.optimize(state)
    with pytest.raises(BreakerOpenError) as ei:
        opt._optimize_routed(state, OptimizationOptions(), False, FAST_CFG)
    assert calls == [1]
    assert ei.value.reason == "breaker-open" and ei.value.failure_class is FailureClass.OOM
    verdict[0] = None
    assert opt._optimize_routed(state, OptimizationOptions(), False, FAST_CFG) == "the card's answer"
    assert not sup.is_degraded


def test_degraded_route_refuses_a_state_on_the_card(on_a_card):
    opt, _, _ = _supervised_optimizer()
    state = small_cluster("cpu")
    on_a_card(opt)
    with pytest.raises(RuntimeError, match="never moved to the CPU"):
        opt._optimize_degraded(state, OptimizationOptions(), FAST_CFG, reason="breaker-open")


def test_card_scenario_failures_raise(on_a_card):
    """The evaluator on the card: an OOM of the batch and of `score_state`
    raises `DeviceDegradedError`, and with the breaker open
    `BreakerOpenError`; no CPU twin answers."""
    verdict = ["down"]
    sup = DeviceSupervisor(op_timeout_s=60.0, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, probe=lambda: verdict[0])
    sensors = SensorRegistry()
    ev = ScenarioEvaluator(device="cpu", supervisor=sup, sensors=sensors)
    state = small_cluster("cpu")
    on_a_card(ev)

    def oom(*a, **kw):
        raise faults.oom_error("scenario.batch-eval")

    ev._evaluate_on_device = ev._score_state_on_device = oom
    with pytest.raises(DeviceDegradedError) as ei:
        ev.evaluate_states([state, state])
    assert ei.value.failure_class is FailureClass.OOM
    with pytest.raises(BreakerOpenError):
        ev.score_state(state)
    verdict[0] = None
    with pytest.raises(DeviceDegradedError) as ei:
        ev.score_state(state)
    assert ei.value.reason == "oom"
    assert sensors.counter("planner.degraded-evaluations").count == 0


def test_supervisor_run_raises_or_answers():
    """`DeviceSupervisor.run`, the one policy of the supervised callers:
    without a `degraded` answer a classified failure and an open breaker
    raise; with one they are answered, with the reason and the cause."""
    verdict = ["down"]
    sup = DeviceSupervisor(op_timeout_s=5.0, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, probe=lambda: verdict[0])
    assert sup.run(lambda: 7, op="optimize") == 7
    err = faults.oom_error("x")

    def fail():
        raise err

    with pytest.raises(DeviceDegradedError) as ei:
        sup.run(fail, op="optimize")
    assert ei.value.__cause__ is err
    with pytest.raises(BreakerOpenError):
        sup.run(lambda: pytest.fail("ran with the breaker open"), op="optimize")
    got = sup.run(lambda: pytest.fail("ran"), op="optimize",
                  degraded=lambda reason, cause: (reason, cause))
    assert got == ("breaker-open", None)
    verdict[0] = None
    reason, cause = sup.run(fail, op="optimize", degraded=lambda reason, cause: (reason, cause))
    assert reason == "oom" and cause.__cause__ is err
    # application errors are never answered
    with pytest.raises(ValueError):
        sup.run(lambda: (_ for _ in ()).throw(ValueError("bad")), op="optimize",
                degraded=lambda reason, cause: pytest.fail("answered"))


def test_abandoned_call_holds_the_breaker_open():
    """A call abandoned at its deadline keeps the breaker open while its
    worker still runs (the default probe fails, naming it), so a recovery
    never queues behind it; once it returns, the probe closes the
    breaker."""
    release = threading.Event()
    sup = DeviceSupervisor(op_timeout_s=0.1, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, device="cpu")
    with pytest.raises(DeviceDegradedError) as ei:
        sup.call(lambda: release.wait(30.0), op="optimize")
    assert ei.value.failure_class is FailureClass.HANG
    assert sup.abandoned_running() == 1
    assert not sup.available() and not sup.available()
    assert sup.num_probe_failures == 2 and "abandoned" in sup.last_failure["error"]
    release.set()
    deadline = time.monotonic() + 10.0
    while sup.abandoned_running() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sup.available() and sup.breaker.state is BreakerState.CLOSED


@pytest.mark.parametrize("fixture", ["small_cluster", "dead_broker_cluster"])
def test_degraded_parity_with_jax(fixture):
    """The same injected OOM through the JAX package's supervised optimizer
    and the port's: the same reason, history keys, sensor names, counter
    counts and summary keys; the objectives within rtol 1e-6; the moves of
    the port's own CPU greedy with the same seed, and the JAX degraded
    result's (tests/test_torch_greedy.py: the two greedies agree on these
    fixtures)."""
    from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JGoalOptimizer
    from cruise_control_tpu.common.device_watchdog import DeviceSupervisor as JSupervisor
    from cruise_control_tpu.common.sensors import SensorRegistry as JSensors
    from cruise_control_tpu.testing import faults as jfaults
    from cruise_control_tpu.testing import fixtures as jf
    from cruise_control_tpu_torch.testing import fixtures as tf

    kw = dict(op_timeout_s=120.0, max_retries=0, breaker_failure_threshold=1,
              probe_interval_s=0.0, probe=lambda: None)
    jsens = JSensors()
    jopt = JGoalOptimizer(config=_jax_cfg(), supervisor=JSupervisor(sensors=jsens, **kw),
                          degraded_budget_s=10.0, sensors=jsens)
    with jfaults.device_oom(schedule=jfaults.first(1)):
        jres = jopt.optimize(getattr(jf, fixture)())
    opt, sup, sensors = _supervised_optimizer()
    state = getattr(tf, fixture)("cpu")
    with faults.device_oom(schedule=faults.first(1)):
        res = opt.optimize(state)
    assert res.degraded and jres.degraded
    assert res.history[0]["reason"] == jres.history[0]["reason"] == "oom"
    assert [sorted(h) for h in res.history] == [sorted(h) for h in jres.history]
    assert res.summary().keys() == jres.summary().keys()
    jsnap, snap = jsens.snapshot(), sensors.snapshot()
    assert sorted(snap) == sorted(jsnap)
    assert {k: v["count"] for k, v in snap.items() if v["type"] == "counter"} == \
        {k: v["count"] for k, v in jsnap.items() if v["type"] == "counter"}
    np.testing.assert_allclose(res.objective_before, jres.objective_before, rtol=1e-6)
    np.testing.assert_allclose(res.objective_after, jres.objective_after, rtol=1e-6)
    own = greedy_optimize(state, DEFAULT_CHAIN, DEFAULT_CONSTRAINT,
                          seed=FAST_CFG.seed, time_budget_s=10.0, device="cpu")
    for f in PLACEMENT:
        assert torch.equal(getattr(res.state_after, f), getattr(own, f)), f
        np.testing.assert_array_equal(getattr(res.state_after, f).numpy(),
                                      np.asarray(getattr(jres.state_after, f)), err_msg=f)
    assert len(res.proposals) == len(jres.proposals)


def _jax_cfg():
    from cruise_control_tpu.analyzer.engine import OptimizerConfig as JConfig

    return JConfig(**dataclasses.asdict(FAST_CFG))


def test_background_optimize_under_supervisor_stays_segmented():
    """The supervisor runs its worker in the caller's copied context, so a
    BACKGROUND grant of the device scheduler still segments the anneal,
    and the segmented run is the one-launch run bit for bit."""
    cfg = OptimizerConfig(num_candidates=256, leadership_candidates=64, steps_per_round=24,
                          num_rounds=4, seed=1)
    solo = GoalOptimizer(config=cfg, device="cpu").optimize(small_cluster("cpu"))
    sup = DeviceSupervisor(op_timeout_s=120.0, max_retries=0, probe=lambda: None)
    opt = GoalOptimizer(config=cfg, device="cpu", supervisor=sup)
    res = DeviceScheduler(slice_budget_s=1e-3).run(
        WorkClass.BACKGROUND, lambda: opt.optimize(small_cluster("cpu")))
    t = res.history[-1]
    assert not res.degraded
    assert t["segmented"] and t["segments"] > 1 and t["blocking_syncs"] == t["segments"]
    for f in PLACEMENT:
        assert torch.equal(getattr(res.state_after, f), getattr(solo.state_after, f)), f
    assert len(res.proposals) == len(solo.proposals)


def test_hang_timeout_leaves_in_flight_trail(tmp_path):
    """tests/test_blackbox.py:242: a supervised dispatch that hangs past its
    budget leaves the supervised End record with the abandonment verdict
    and the in-worker device-op Begin permanently in flight, with the
    optimizer's bucket context stamped on it."""
    RECORDER.configure(str(tmp_path / "spool-1.jsonl"))
    try:
        sup = DeviceSupervisor(op_timeout_s=0.4, max_retries=0, breaker_failure_threshold=100,
                               probe=lambda: None)
        opt = GoalOptimizer(config=FAST_CFG, supervisor=sup, device="cpu")
        opt.optimize(small_cluster("cpu"))  # healthy warm-up
        with faults.device_wedged(ops=("engine.run",)):
            result = opt.optimize(dead_broker_cluster("cpu"))
            # read while the fault holds: the wedge releases its abandoned
            # worker at exit, whose late completion would close the pair
            records = read_spool(str(tmp_path / "spool-1.jsonl"))
    finally:
        RECORDER.configure(None)
    assert result.degraded, "the hang must degrade to the CPU greedy path"
    abandoned = [r for r in records if r["t"] == "supervised" and r["ph"] == "E" and not r["ok"]]
    assert abandoned and abandoned[-1]["hang"] is True
    inflight = in_flight_from_records(records)
    assert any(r["t"] == "device-op" and r["op"] == "engine.run" for r in inflight), inflight
    stuck = next(r for r in inflight if r["t"] == "device-op")
    assert "bucket" in stuck and stuck["config_fp"]


def test_nested_device_ops_record_once():
    """Only the outermost marked call of a thread goes to the hook."""
    from cruise_control_tpu_torch.common.device_watchdog import device_op

    @device_op("engine.run")
    def inner():
        return 1

    @device_op("engine.run")
    def outer():
        return inner() + 1

    with faults.device_fault(lambda op, fn, a, kw: fn(*a, **kw)) as log:
        assert outer() == 2
    assert log.calls == {"engine.run": 1}


# ------------------------------------------------------------ scenario evaluator


def _scenarios():
    return [Scenario(name="lose-0", remove_brokers=(0,)), Scenario(name="base")]


def test_supervised_scenarios_match_unsupervised_and_degrade_flagged():
    state = small_cluster("cpu")
    plain = ScenarioEvaluator(device="cpu").evaluate(state, _scenarios())
    sensors = SensorRegistry()
    sup = DeviceSupervisor(op_timeout_s=60.0, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, probe=lambda: None)
    ev = ScenarioEvaluator(device="cpu", supervisor=sup, sensors=sensors)
    healthy = ev.evaluate(state, _scenarios())
    assert [o.degraded for o in healthy] == [False, False]
    assert [o.objective for o in healthy] == [o.objective for o in plain]
    with faults.device_oom(ops=("scenario.batch-eval",), schedule=faults.first(1)) as log:
        degraded = ev.evaluate(state, _scenarios())
    assert log.fired == {"scenario.batch-eval": 1}
    assert [o.degraded for o in degraded] == [True, True]
    assert ev.last_batch["degraded"] is True
    np.testing.assert_allclose([o.objective for o in degraded], [o.objective for o in plain],
                               rtol=1e-6)
    assert sensors.counter("planner.degraded-evaluations").count == 1
    assert not ev.evaluate(state, _scenarios())[0].degraded  # the probe closed the breaker


def test_degraded_scores_are_the_sequential_twin_and_jax():
    """The degraded batch is the sequential CPU twin's numbers, which are
    the JAX package's degraded scores."""
    from cruise_control_tpu.analyzer.scenario_eval import ScenarioEvaluator as JEvaluator
    from cruise_control_tpu.common.device_watchdog import DeviceSupervisor as JSupervisor
    from cruise_control_tpu.testing import faults as jfaults
    from cruise_control_tpu.testing import fixtures as jf

    kw = dict(op_timeout_s=60.0, max_retries=0, breaker_failure_threshold=1,
              probe_interval_s=0.0, probe=lambda: None)
    jev = JEvaluator(supervisor=JSupervisor(**kw))
    with jfaults.device_oom(ops=("scenario.batch-eval",), schedule=jfaults.first(1)):
        jout = jev.evaluate(jf.small_cluster(), _scenarios())
    ev = ScenarioEvaluator(device="cpu", supervisor=DeviceSupervisor(**kw))
    state = small_cluster("cpu")
    with faults.device_oom(ops=("scenario.batch-eval",), schedule=faults.first(1)):
        out = ev.evaluate(state, _scenarios())
    assert [o.degraded for o in out] == [o.degraded for o in jout] == [True, True]
    np.testing.assert_allclose([o.objective for o in out], [o.objective for o in jout], rtol=1e-6)
    np.testing.assert_allclose(np.stack([o.violations for o in out]),
                               np.stack([o.violations for o in jout]), rtol=1e-6, atol=1e-9)


def test_supervised_score_state_degrades_to_the_cpu():
    state = small_cluster("cpu")
    plain = ScenarioEvaluator(device="cpu").score_state(state)
    sup = DeviceSupervisor(op_timeout_s=60.0, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, probe=lambda: None)
    ev = ScenarioEvaluator(device="cpu", supervisor=sup)
    assert ev.score_state(state)[3] is False
    with faults.device_oom(ops=("scenario.score-state",), schedule=faults.first(1)) as log:
        obj, viol, stats, degraded = ev.score_state(state)
    assert log.fired == {"scenario.score-state": 1} and degraded is True
    np.testing.assert_allclose(obj, plain[0], rtol=1e-6)
    np.testing.assert_allclose(viol, plain[1], rtol=1e-6, atol=1e-9)
    for f in ("avg", "max", "replica_count_std"):
        np.testing.assert_allclose(getattr(stats, f).numpy(), getattr(plain[2], f).numpy(),
                                   rtol=1e-6)


def test_rightsize_carries_degraded_end_to_end():
    """A supervised evaluator and optimizer whose every device invocation
    fails: the rightsizer's screen and its anneals are degraded answers,
    and its verdict says so."""
    sup = DeviceSupervisor(op_timeout_s=60.0, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, probe=lambda: "down")
    opt = GoalOptimizer(config=FAST_CFG, device="cpu", supervisor=sup, degraded_budget_s=5.0)
    ev = ScenarioEvaluator(optimizer=opt, device="cpu", supervisor=sup)
    healthy = Rightsizer(ScenarioEvaluator(
        optimizer=GoalOptimizer(config=FAST_CFG, device="cpu"), device="cpu"),
    ).rightsize(small_cluster("cpu"), max_anneals=4)
    assert healthy["degraded"] is False
    with faults.device_oom(ops=faults.ENGINE_OPS):
        out = Rightsizer(ev).rightsize(small_cluster("cpu"), max_anneals=4)
    assert out["degraded"] is True


def test_lost_context_keeps_engines_unreleased(monkeypatch):
    """A sticky error (DEVICE_LOST) leaves no CUDA call that succeeds, and
    freeing a captured graph or a pinned buffer then raises from C++: the
    purge drops the engines from the cache but never releases them."""
    from cruise_control_tpu_torch.analyzer.engine import Engine

    released = []
    monkeypatch.setattr(Engine, "release", lambda self: released.append(self))
    opt, sup, _ = _supervised_optimizer(probe=lambda: "context lost")
    state = small_cluster("cpu")
    assert not opt.optimize(state).degraded
    engine = next(iter(opt._engines.values()))
    def sticky(op, fn, args, kwargs):
        raise faults.device_lost_error(op)

    with faults.device_fault(sticky, schedule=faults.first(1)):
        res = opt.optimize(state)
    assert res.degraded and res.history[0]["reason"] == "device_lost" and sup.context_lost
    assert sup.num_retries == 0 and sup.state_json()["contextLost"] is True
    assert not opt.has_engine_for(state.shape, config=FAST_CFG)
    assert released == [] and opt._abandoned_engines == [engine]
    again = opt.optimize(state)  # the probe fails in the lost context
    assert again.degraded and again.history[0]["reason"] == "breaker-open" and released == []


def test_oom_purge_releases_unpinned_engines(monkeypatch):
    from cruise_control_tpu_torch.analyzer.engine import Engine

    released = []
    real = Engine.release
    monkeypatch.setattr(Engine, "release", lambda self: (released.append(self), real(self)))
    opt, sup, _ = _supervised_optimizer()
    state = small_cluster("cpu")
    opt.optimize(state)
    engine = next(iter(opt._engines.values()))
    with faults.device_oom(schedule=faults.first(1)):
        assert opt.optimize(state).degraded
    assert released == [engine] and not sup.context_lost and opt._abandoned_engines == []


def test_summary_keys_match_jax():
    """`OptimizerResult.summary()` has the JAX package's keys, `degraded`
    among them, on an answer from the device path."""
    from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JGoalOptimizer
    from cruise_control_tpu.testing import fixtures as jf

    jres = JGoalOptimizer(config=_jax_cfg()).optimize(jf.small_cluster())
    res = GoalOptimizer(config=FAST_CFG, device="cpu").optimize(small_cluster("cpu"))
    assert res.summary().keys() == jres.summary().keys()
    assert res.summary()["degraded"] is jres.summary()["degraded"] is False


# ---------------------------------- service level (tests/test_faults.py :407-540)


@pytest.fixture(scope="module")
def supervised_service():
    """In-process facade with aggressive supervisor timings so breaker
    stories run in seconds (no HTTP listener needed)."""
    from cruise_control_tpu_torch.service.main import build_simulated_service

    config = CruiseControlConfig({
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "num.partition.metrics.windows": 3,
        "execution.progress.check.interval.ms": 100,
        "webserver.http.port": 0,
        "tpu.num.candidates": 128,
        "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 16,
        "tpu.num.rounds": 2,
        # generous: real compiles on a loaded CI box must never classify
        # as hangs (the acceptance test tightens it around the wedge only)
        "tpu.supervisor.op.timeout.s": 300.0,
        "tpu.supervisor.probe.timeout.s": 0.2,
        "tpu.supervisor.probe.interval.s": 0.0,
        "tpu.supervisor.breaker.failure.threshold": 1,
        "tpu.supervisor.max.retries": 0,
        "tpu.supervisor.degraded.greedy.budget.s": 20.0,
    })
    app, fetcher, admin, sampler = build_simulated_service(config, device="cpu")
    return app.cc


def test_acceptance_permanent_hang_degrades_then_probe_recovers(supervised_service):
    """ISSUE 3 acceptance: injected permanent engine hang =>
    * proposals() returns a valid greedy proposal set within the budget,
    * /state shows analyzer.degraded=true, breaker open,
    * an OPTIMIZER_DEGRADED anomaly is recorded,
    * after the fault clears the probe closes the breaker and the next
      proposal is TPU-backed again."""
    cc = supervised_service
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType

    # healthy warmup: TPU-backed proposals (generous budget — a slow cold
    # compile on a loaded box is not a hang)
    r0 = cc.proposals(OperationProgress(), ignore_cache=True)
    assert not r0.degraded

    # tight budget ONLY while the hang is injected: the wedge fires on the
    # first engine dispatch, so the bounded wait is exactly this budget
    cc.supervisor.op_timeout_s = 5.0
    try:
        with faults.device_wedged():
            t0 = time.monotonic()
            r1 = cc.proposals(OperationProgress(), ignore_cache=True)
            elapsed = time.monotonic() - t0
            # bounded: op budget (5s) + greedy fallback, nowhere near a hang
            assert elapsed < 90.0
            assert r1.degraded
            # a valid proposal set over the live model: every proposal
            # diffs the before placement, and the summary is servable
            summary = r1.summary()
            assert summary["degraded"] is True
            for p in list(r1.proposals)[:10]:
                assert p.old_replicas != p.new_replicas or p.old_leader != p.new_leader
            st = cc.state(["analyzer"])
            assert st["AnalyzerState"]["degraded"] is True
            assert st["AnalyzerState"]["supervisor"]["breaker"] == "open"
            assert st["AnalyzerState"]["supervisor"]["failureCounts"]["hang"] >= 1
            # the detector records the degradation anomaly (edge-triggered)
            records = cc.anomaly_detector.run_once()
            assert any(
                r.anomaly.anomaly_type is AnomalyType.OPTIMIZER_DEGRADED
                for r in records
            )
            # ... once per open episode, not once per round
            assert not any(
                r.anomaly.anomaly_type is AnomalyType.OPTIMIZER_DEGRADED
                for r in cc.anomaly_detector.run_once()
            )
            # still degraded while wedged: the half-open probe fails too
            r2 = cc.proposals(OperationProgress(), ignore_cache=True)
            assert r2.degraded
    finally:
        # recovery pays a fresh trace+compile (caches were purged on open):
        # back to the generous budget
        cc.supervisor.op_timeout_s = 300.0

    # the port holds the breaker open until an abandoned call's worker
    # returns (a departure by rule, ROADMAP queue 3): the wedged worker
    # unblocks at the context's exit, so wait for it first
    deadline = time.monotonic() + 30.0
    while cc.supervisor.abandoned_running() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cc.supervisor.abandoned_running() == 0
    # fault cleared: the next call's half-open probe heals the breaker
    r3 = cc.proposals(OperationProgress(), ignore_cache=True)
    assert not r3.degraded
    st = cc.state(["analyzer"])
    assert st["AnalyzerState"]["degraded"] is False
    assert st["AnalyzerState"]["supervisor"]["breaker"] == "closed"


def test_self_healing_fix_failure_is_visible(supervised_service):
    cc = supervised_service
    before = cc.sensors.counter("self-healing.fix-failed").count
    with faults.method_fault(
        cc, "rebalance", faults.raising(lambda: RuntimeError("boom"))
    ):
        assert cc.actions.rebalance("test-reason") is False
    assert cc.sensors.counter("self-healing.fix-failed").count == before + 1
    info = cc.anomaly_detector.detector_state()["lastSelfHealingFixFailure"]
    assert info["operation"] == "rebalance" and "boom" in info["error"]


def test_precompute_loop_counts_consecutive_failures(supervised_service):
    cc = supervised_service
    saved_expiration = cc._proposal_expiration_ms
    cc._proposal_expiration_ms = 20  # 10ms cycle
    cc._stop_precompute.clear()
    t = None
    try:
        with faults.method_fault(
            cc, "proposals", faults.raising(lambda: RuntimeError("model build broke"))
        ), faults.method_fault(cc, "_prewarm_next_bucket", faults.dropping()):
            t = threading.Thread(target=cc._precompute_loop, daemon=True)
            t.start()
            deadline = time.monotonic() + 5.0
            while (
                cc.sensors.counter("analyzer.precompute-failures").count < 3
                and time.monotonic() < deadline
            ):
                time.sleep(0.01)
            assert cc.sensors.counter("analyzer.precompute-failures").count >= 3
            assert (
                cc.sensors.gauge("analyzer.precompute-consecutive-failures").value >= 3
            )
            cc._stop_precompute.set()
            t.join(timeout=5)
            assert not t.is_alive()
    finally:
        cc._stop_precompute.set()
        if t is not None:
            t.join(timeout=5)
        cc._proposal_expiration_ms = saved_expiration


# ------------------- the analyzer core's recorder (tests/test_blackbox.py :187)


def test_core_disables_recorder_when_config_says_off(tmp_path):
    """blackbox.enabled=false (or an explicitly empty dir) must disable
    a recorder an earlier service in this process turned on — the
    recorder is process-wide and the zero-writes contract is pinned."""
    from cruise_control_tpu_torch.config.app_config import CruiseControlConfig
    from cruise_control_tpu_torch.service.facade import AnalyzerCore

    AnalyzerCore(CruiseControlConfig({
        "blackbox.dir": str(tmp_path / "bb"),
    }), device="cpu")
    assert RECORDER.enabled
    AnalyzerCore(CruiseControlConfig({"blackbox.enabled": False}), device="cpu")
    assert not RECORDER.enabled
