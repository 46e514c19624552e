"""The port's device scheduler (fleet/scheduler.py) and its preemption of
a segmented anneal, on the CPU.

The JAX package's tests/test_scheduler.py pins the scheduler's promise:
an URGENT request waits at most one slice of background work, BACKGROUND
is delayed but never starved, sheds are counted, brownout degrades
instead of skipping, and segmentation changes when the device is used,
never what it computes.  Its tests that need no service are pointed at
the port here, name for name (their line in tests/test_scheduler.py in
each docstring's first line is the JAX test's); with the device
supervisor, its pause-clock test (:438), the three `device_slowdown`
tests (:575-:636) and the slow chaos gate (:638) are here too, at the
end; then its service tests (:483-:828) over the port's simulated
service; test_controller_cycle_sheds_counted waits for the streaming
controller (slice 20, ROADMAP.md).  The port adds what only it has: the same-bucket
preemption through one GoalOptimizer, where the paused run lets go of the
engine that the urgent run needs (analyzer/engine.py `_let_go`), the fast
path and the shed ladder around real optimize calls, and the brownout
config's engine.  Each thread is joined with a timeout, so a deadlock
fails rather than hangs.
"""

import contextvars
import threading
import time

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.engine import (
    Engine,
    OptimizerConfig,
    SegmentContext,
    segmented_execution,
)
from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN
from cruise_control_tpu_torch.common.device_watchdog import _current_pause_clock
from cruise_control_tpu_torch.detector.anomalies import AnomalyType, FleetOverload
from cruise_control_tpu_torch.fleet.scheduler import (
    BackgroundShedError,
    DeviceScheduler,
    SchedulerOverloadError,
    WorkClass,
    effective_class,
    tagged,
)
from cruise_control_tpu_torch.testing import faults
from cruise_control_tpu_torch.testing.fixtures import small_cluster
from cruise_control_tpu_torch.service.tasks import UserTaskManager

FAST = OptimizerConfig(
    num_candidates=256, leadership_candidates=64, steps_per_round=24,
    num_rounds=4, seed=1,
)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


def _sliced_work(n_slices: int, slice_s: float):
    """A background body shaped like a segmented anneal: n slices of
    device wall with the engine's between-slices checkpoint honored."""
    from cruise_control_tpu_torch.analyzer.engine import current_segment_context

    def body():
        ctx = current_segment_context()
        for i in range(n_slices):
            time.sleep(slice_s)
            if ctx is not None and ctx.checkpoint is not None and i < n_slices - 1:
                ctx.checkpoint()
        return "done"

    return body


def _scheduler(**kw):
    kw.setdefault("slice_budget_s", 0.25)
    kw.setdefault("freshness_slo_s", 2.0)
    kw.setdefault("aging_s", 0.2)
    kw.setdefault("shed_queue_depth", 3)
    kw.setdefault("brownout_after_s", 60.0)
    return DeviceScheduler(**kw)


def test_segmented_anneal_byte_parity():
    """The acceptance pin: a segmented run (1-round slices, checkpoints
    firing) produces byte-identical placements, objectives and per-round
    history to the unsegmented fused run at equal total round budget."""
    state = small_cluster("cpu")
    e1 = Engine(state, DEFAULT_CHAIN, config=FAST)
    s1, h1 = e1.run()
    e2 = Engine(state, DEFAULT_CHAIN, config=FAST)
    checkpoints = []
    ctx = SegmentContext(1e-9, checkpoint=lambda: checkpoints.append(1))
    with segmented_execution(ctx):
        s2, h2 = e2.run()
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(
            np.asarray(getattr(s1, f)), np.asarray(getattr(s2, f))
        ), f
    r1 = [h for h in h1 if not h.get("timing")]
    r2 = [h for h in h2 if not h.get("timing")]
    assert r1 == r2  # identical round trajectories, early stops included
    t2 = next(h for h in h2 if h.get("timing"))
    assert t2["segmented"] and t2["segments"] > 1
    assert len(checkpoints) == t2["segments"] - 1


def test_urgent_preempts_background_within_one_slice():
    sched = _scheduler(slice_budget_s=0.25)
    slice_s = 0.2
    started = threading.Event()

    def background():
        started.set()
        return _sliced_work(6, slice_s)()

    bg = threading.Thread(
        target=lambda: sched.run(WorkClass.BACKGROUND, background, op="bg"),
        daemon=True,
    )
    bg.start()
    assert started.wait(5.0)
    time.sleep(slice_s / 2)  # background is mid-slice now
    t0 = time.monotonic()
    sched.run(WorkClass.URGENT, lambda: None, op="fix")
    urgent_wait = time.monotonic() - t0
    bg.join(10.0)
    assert not bg.is_alive()
    # queue-to-dispatch wait bounded by ONE slice (+ scheduling slack)
    assert urgent_wait <= slice_s + 0.25, urgent_wait
    assert sched.stats["preemptions"] >= 1
    assert sched.stats["sheds"]["urgent"] == 0


def test_background_sheds_under_overload_and_is_counted():
    sched = _scheduler(shed_queue_depth=2)
    release = threading.Event()
    hold = threading.Thread(
        target=lambda: sched.run(
            WorkClass.BACKGROUND, release.wait, op="hold", preemptible=False
        ),
        daemon=True,
    )
    hold.start()
    time.sleep(0.05)
    # fill the queue past the shed depth with (never-granted) waiters
    waiters = [
        threading.Thread(
            target=lambda: sched.run(
                WorkClass.INTERACTIVE, lambda: None, op="w"
            ),
            daemon=True,
        )
        for _ in range(2)
    ]
    for w in waiters:
        w.start()
    time.sleep(0.1)
    with pytest.raises(BackgroundShedError):
        sched.run(WorkClass.BACKGROUND, lambda: None, op="cycle")
    assert sched.stats["sheds"]["background"] == 1
    # urgent is NEVER shed: it queues and runs once the holder releases
    done = []
    urgent = threading.Thread(
        target=lambda: done.append(
            sched.run(WorkClass.URGENT, lambda: "ok", op="fix")
        ),
        daemon=True,
    )
    urgent.start()
    release.set()
    urgent.join(5.0)
    for w in waiters:
        w.join(5.0)
    assert done == ["ok"]
    assert sched.stats["sheds"]["urgent"] == 0


def test_background_ages_past_sustained_interactive_load():
    """Delayed, never starved: under a continuous INTERACTIVE stream, an
    aged BACKGROUND ticket is ranked with the interactive class and its
    older deadline wins the EDF tiebreak."""
    sched = _scheduler(aging_s=0.1, freshness_slo_s=0.8, shed_queue_depth=50)
    stop = threading.Event()
    bg_ran = threading.Event()

    def interactive_storm():
        while not stop.is_set():
            sched.run(WorkClass.INTERACTIVE, lambda: time.sleep(0.02), op="i")

    storm = [
        threading.Thread(target=interactive_storm, daemon=True)
        for _ in range(3)
    ]
    for t in storm:
        t.start()
    time.sleep(0.1)
    bg = threading.Thread(
        target=lambda: (
            sched.run(WorkClass.BACKGROUND, lambda: None, op="bg"),
            bg_ran.set(),
        ),
        daemon=True,
    )
    bg.start()
    ran = bg_ran.wait(10.0)
    stop.set()
    for t in storm:
        t.join(5.0)
    assert ran, "background starved under interactive load"


def test_reentrant_run_and_urgent_tagging():
    sched = _scheduler()
    calls = []

    def inner():
        calls.append("inner")
        return "v"

    def outer():
        # nested run executes inline under the held slot — no deadlock
        return sched.run(WorkClass.INTERACTIVE, inner, op="nested")

    assert sched.run(WorkClass.URGENT, outer, op="outer") == "v"
    assert calls == ["inner"]
    # pipeline tagging upgrades (never downgrades) the dispatch class
    with tagged(WorkClass.URGENT):
        assert effective_class(WorkClass.INTERACTIVE) is WorkClass.URGENT
    with tagged(WorkClass.BACKGROUND):
        assert effective_class(WorkClass.INTERACTIVE) is WorkClass.INTERACTIVE
    assert effective_class(WorkClass.INTERACTIVE) is WorkClass.INTERACTIVE


def test_brownout_after_sustained_overload_and_episode_anomaly():
    clock = {"t": 0.0}
    anomalies = []
    sched = DeviceScheduler(
        slice_budget_s=0.25, freshness_slo_s=2.0, aging_s=10.0,
        shed_queue_depth=1, brownout_after_s=5.0,
        brownout_factor=0.5, clock=lambda: clock["t"],
        anomaly_sink=anomalies.append,
    )
    release = threading.Event()
    hold = threading.Thread(
        target=lambda: sched.run(
            WorkClass.BACKGROUND, release.wait, op="hold", preemptible=False
        ),
        daemon=True,
    )
    hold.start()
    time.sleep(0.05)
    waiter = threading.Thread(
        target=lambda: sched.run(WorkClass.INTERACTIVE, lambda: None, op="w"),
        daemon=True,
    )
    waiter.start()
    time.sleep(0.05)
    # depth 1 >= shed_queue_depth -> overload episode starts; shed fires
    with pytest.raises(BackgroundShedError):
        sched.run(WorkClass.BACKGROUND, lambda: None, op="cycle")
    assert len(anomalies) == 1  # FLEET_OVERLOAD, once
    assert isinstance(anomalies[0], FleetOverload)
    assert anomalies[0].anomaly_type is AnomalyType.FLEET_OVERLOAD
    assert anomalies[0].fixable is False
    assert not sched.brownout_active
    # sustained past brownout.after.s: background now RUNS, browned out
    clock["t"] += 6.0
    cfg = OptimizerConfig(num_candidates=2048, leadership_candidates=512)
    assert sched.brownout_active
    reduced = sched.brownout_config(cfg)
    assert reduced.num_candidates == 1024
    assert reduced.leadership_candidates == 256
    assert reduced.prior_enabled == cfg.prior_enabled
    assert sched.stats["brownout_cycles"] == 1
    # still ONE anomaly for the whole episode
    assert len(anomalies) == 1
    release.set()
    hold.join(5.0)
    waiter.join(5.0)
    # queue drained below half depth -> episode ends; the NEXT episode
    # fires a fresh anomaly
    sched.run(WorkClass.INTERACTIVE, lambda: None, op="drain")
    assert not sched.brownout_active
    release2 = threading.Event()
    hold2 = threading.Thread(
        target=lambda: sched.run(
            WorkClass.BACKGROUND, release2.wait, op="hold2", preemptible=False
        ),
        daemon=True,
    )
    hold2.start()
    time.sleep(0.05)
    w2 = threading.Thread(
        target=lambda: sched.run(WorkClass.INTERACTIVE, lambda: None, op="x"),
        daemon=True,
    )
    w2.start()
    time.sleep(0.05)
    with pytest.raises(BackgroundShedError):
        sched.run(WorkClass.BACKGROUND, lambda: None, op="cycle2")
    assert len(anomalies) == 2
    release2.set()
    hold2.join(5.0)
    w2.join(5.0)


def test_interactive_admission_429_with_retry_after():
    sched = _scheduler(shed_queue_depth=1)
    release = threading.Event()
    hold = threading.Thread(
        target=lambda: sched.run(
            WorkClass.BACKGROUND, release.wait, op="hold", preemptible=False
        ),
        daemon=True,
    )
    hold.start()
    time.sleep(0.05)
    waiters = [
        threading.Thread(
            target=lambda: sched.run(
                WorkClass.INTERACTIVE, lambda: None, op="w"
            ),
            daemon=True,
        )
        for _ in range(2)
    ]
    for w in waiters:
        w.start()
    time.sleep(0.1)
    # queue >= 2x depth: severe overload -> 429 + Retry-After
    with pytest.raises(SchedulerOverloadError) as ei:
        sched.admit_interactive(default_retry_after_s=7.0)
    assert ei.value.retry_after_s >= 1.0
    assert sched.stats["sheds"]["interactive"] == 1
    release.set()
    hold.join(5.0)
    for w in waiters:
        w.join(5.0)


def test_abandoned_preempted_ticket_does_not_wedge_scheduler():
    """Regression (review): the DeviceSupervisor abandons a timed-out
    dispatch on the CALLER thread while its worker sits paused in a
    preemption checkpoint.  The release must pull the paused ticket out
    of the queue and cancel it — otherwise the zombie worker later
    re-acquires the slot with nobody left to release it and every
    subsequent dispatch blocks forever."""
    import contextvars

    from cruise_control_tpu_torch.analyzer.engine import current_segment_context

    sched = _scheduler(slice_budget_s=0.1)
    bg_started = threading.Event()
    go_checkpoint = threading.Event()
    urgent_release = threading.Event()
    urgent_started = threading.Event()
    worker_done = threading.Event()
    bg_error = []

    def bg_fn():
        ctx = current_segment_context()
        cvctx = contextvars.copy_context()

        def worker():
            # the supervisor-worker twin: checkpoint once the urgent
            # ticket is queued — it pauses us and hands over the slot
            go_checkpoint.wait(5.0)
            cvctx.run(ctx.checkpoint)
            worker_done.set()

        threading.Thread(target=worker, daemon=True).start()
        bg_started.set()
        # caller side: once the urgent holder owns the slot (our worker
        # is paused), "time out" like DeviceSupervisor._bounded would
        assert urgent_started.wait(5.0)
        time.sleep(0.1)
        raise TimeoutError("supervisor abandoned this dispatch")

    def run_bg():
        try:
            sched.run(WorkClass.BACKGROUND, bg_fn, op="bg")
        except TimeoutError as e:
            bg_error.append(e)

    bg = threading.Thread(target=run_bg, daemon=True)
    bg.start()
    assert bg_started.wait(5.0)
    urgent_t = threading.Thread(
        target=lambda: sched.run(
            WorkClass.URGENT,
            lambda: (urgent_started.set(), urgent_release.wait(10.0)),
            op="fix",
        ),
        daemon=True,
    )
    urgent_t.start()
    time.sleep(0.1)  # the urgent ticket is queued behind the bg holder
    go_checkpoint.set()
    bg.join(10.0)
    assert not bg.is_alive() and bg_error, "background run never unwound"
    assert worker_done.wait(5.0), "paused worker never released"
    urgent_release.set()
    urgent_t.join(5.0)
    # the scheduler is NOT wedged: a fresh dispatch completes promptly
    done = []
    probe = threading.Thread(
        target=lambda: done.append(
            sched.run(WorkClass.INTERACTIVE, lambda: "ok", op="probe")
        ),
        daemon=True,
    )
    probe.start()
    probe.join(5.0)
    assert done == ["ok"], "scheduler wedged after abandoned preemption"


def test_ticket_pause_clock_includes_in_progress_pause():
    """Regression (review round 2): a pause still in progress must be
    visible to the supervisor's pause clock — a single pause longer than
    the remaining hang budget would otherwise still trip
    DeviceHangError."""
    from cruise_control_tpu_torch.fleet.scheduler import _Ticket

    clock = {"t": 0.0}
    sched = DeviceScheduler(slice_budget_s=0.1, clock=lambda: clock["t"])
    t = _Ticket(WorkClass.BACKGROUND, "", "x", enqueued=0.0, deadline=1.0,
                seq=0)
    t.paused_s = 2.0
    assert sched._ticket_pause_s(t) == 2.0
    t.pause_started = clock["t"]
    clock["t"] += 3.0
    assert sched._ticket_pause_s(t) == 5.0  # 2 completed + 3 in progress


def test_interactive_fast_path_unsegmented_when_alone():
    """An INTERACTIVE request granted while nothing else waits gets the
    whole device as ONE unsegmented dispatch (no ambient segment context,
    no between-slice preemption checks) — the streaming controller's
    fused cycles ride this.  Explicit preemptible=True and BACKGROUND
    submissions keep today's segmented grants."""
    from cruise_control_tpu_torch.analyzer.engine import current_segment_context

    sched = _scheduler()
    seen = {}

    def body():
        seen["ctx"] = current_segment_context()
        return "ok"

    assert sched.run(WorkClass.INTERACTIVE, body, op="fused-cycle") == "ok"
    assert seen["ctx"] is None
    assert sched.stats["fast_path_grants"] == 1
    # the caller's explicit preemptible choice always wins
    sched.run(WorkClass.INTERACTIVE, body, op="explicit", preemptible=True)
    assert seen["ctx"] is not None
    assert sched.stats["fast_path_grants"] == 1
    # BACKGROUND never fast-paths, alone or not
    sched.run(WorkClass.BACKGROUND, body, op="bg")
    assert seen["ctx"] is not None
    assert sched.stats["fast_path_grants"] == 1
    assert sched.state_json()["fastPathGrants"] == 1


def test_interactive_fast_path_disabled_stays_segmented():
    """fleet.scheduler.fast.path.enabled=false pins the pre-fast-path
    grant behavior byte-for-byte: every non-urgent grant is segmented."""
    from cruise_control_tpu_torch.analyzer.engine import current_segment_context

    sched = _scheduler(fast_path_enabled=False)
    seen = {}

    def body():
        seen["ctx"] = current_segment_context()

    sched.run(WorkClass.INTERACTIVE, body, op="solo")
    assert seen["ctx"] is not None
    assert sched.stats["fast_path_grants"] == 0
    assert sched.state_json()["fastPathGrants"] == 0



# ------------------------------------------------ the port's own bars


def _decommission(state, broker: int):
    """`state` with `broker` dead (chip_smoke.py phase 5's decommission):
    its disks dead and its replicas offline."""
    import dataclasses

    alive = state.broker_alive.clone()
    alive[broker] = False
    return dataclasses.replace(
        state, broker_alive=alive, disk_alive=alive[:, None] & state.disk_alive,
        replica_offline=state.replica_offline | (state.replica_valid & ~alive[state.replica_broker]))


def _timing(result):
    return next(h for h in result.history if h.get("timing"))


def _same_result(a, b):
    for f in PLACEMENT:
        assert torch.equal(getattr(a.state_after, f), getattr(b.state_after, f)), f
    assert [h for h in a.history if "round" in h] == [h for h in b.history if "round" in h]
    assert len(a.proposals) == len(b.proposals)
    assert a.objective_before == b.objective_before and a.objective_after == b.objective_after
    np.testing.assert_array_equal(a.violations_after, b.violations_after)


class _HandOver(DeviceScheduler):
    """A scheduler whose first checkpoint signals `at_checkpoint` and waits
    (at most 30 s) until an URGENT ticket is queued, so the preemption
    lands at that boundary whatever the host's speed."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.at_checkpoint = threading.Event()

    def _checkpoint(self, ticket, ctx=None):
        if not self.at_checkpoint.is_set():
            self.at_checkpoint.set()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                with self._cond:
                    if any(t.work_class is WorkClass.URGENT for t in self._waiting):
                        break
                time.sleep(0.005)
        return super()._checkpoint(ticket, ctx)


def test_same_bucket_urgent_preempts_background_optimize():
    """A BACKGROUND optimize, paused at a checkpoint by an URGENT optimize
    of the same bucket (shape, max_rf, config) on another generation (a
    decommission), through one GoalOptimizer and one DeviceScheduler: the
    paused run lets go of the engine (its state stashed, its run lock
    released), the urgent run goes through on that engine within its
    grant, and the background run resumes on its own generation.  Both
    equal their solo runs; one engine served both."""
    st = small_cluster("cpu")
    decom = _decommission(st, 0)
    solo_bg = GoalOptimizer(config=FAST, device="cpu").optimize(st)
    solo_urgent = GoalOptimizer(config=FAST, device="cpu").optimize(decom)
    opt = GoalOptimizer(config=FAST, device="cpu")
    sched = _HandOver(slice_budget_s=1e-3, freshness_slo_s=60.0, aging_s=30.0,
                      shed_queue_depth=8, brownout_after_s=60.0)
    out, errors = {}, []

    def background():
        try:
            out["bg"] = sched.run(WorkClass.BACKGROUND, lambda: opt.optimize(st), op="drift")
        except BaseException as e:  # noqa: BLE001 -- reported by the test
            errors.append(e)

    def urgent():
        try:
            assert sched.at_checkpoint.wait(60.0)
            t0 = time.monotonic()
            out["urgent"] = sched.run(
                WorkClass.URGENT, lambda: (time.monotonic() - t0, opt.optimize(decom)),
                op="fix:broker-failure")
        except BaseException as e:  # noqa: BLE001 -- reported by the test
            errors.append(e)

    threads = [threading.Thread(target=background, daemon=True),
               threading.Thread(target=urgent, daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads), "the preemption deadlocked"
    assert errors == []
    wait, res_urgent = out["urgent"]
    _same_result(out["bg"], solo_bg)
    _same_result(res_urgent, solo_urgent)
    tb = _timing(out["bg"])
    assert tb["segmented"] and tb["pauses"] == 1 and tb["restores"] == 1
    assert "segmented" not in _timing(res_urgent)
    assert sched.stats["preemptions"] == 1 and sched.stats["dispatches"]["urgent"] == 1
    assert opt.engine_cache_misses == 1 and opt.engine_cache_hits == 1
    # queue-to-dispatch within one slice of background work (+ slack)
    assert wait <= max(s["wall_s"] for s in tb["slices"]) + 0.25, wait


def test_background_optimize_runs_segmented_and_matches_solo():
    """A BACKGROUND optimize nobody preempts: segmented, its checkpoints
    pause nothing and stash nothing, and its result is the solo run's."""
    st = small_cluster("cpu")
    solo = GoalOptimizer(config=FAST, device="cpu").optimize(st)
    opt = GoalOptimizer(config=FAST, device="cpu")
    res = _scheduler(slice_budget_s=1e-3).run(WorkClass.BACKGROUND, lambda: opt.optimize(st))
    _same_result(res, solo)
    t = _timing(res)
    assert t["segmented"] and t["segments"] > 1 and t["pauses"] == 0
    assert t["blocking_syncs"] == t["segments"]
    (engine,) = opt._engines.values()
    assert engine._ws.stash is None


def test_fast_path_grant_runs_optimize_unsegmented():
    """A lone INTERACTIVE optimize takes the fast path: the one-launch run,
    one blocking sync."""
    st = small_cluster("cpu")
    opt = GoalOptimizer(config=FAST, device="cpu")
    sched = _scheduler()
    res = sched.run(WorkClass.INTERACTIVE, lambda: opt.optimize(st), op="proposals")
    t = _timing(res)
    assert "segmented" not in t and t["blocking_syncs"] == 1
    assert sched.stats["fast_path_grants"] == 1


def test_brownout_config_is_one_more_engine_per_bucket():
    """`brownout_config` is a new OptimizerConfig and so a new cache key:
    the first browned-out optimize of a bucket builds one more engine, the
    next ones hit it."""
    st = small_cluster("cpu")
    opt = GoalOptimizer(config=FAST, device="cpu")
    sched = _scheduler()
    opt.optimize(st)
    reduced = sched.brownout_config(FAST)
    assert reduced.num_candidates == 128 and reduced.leadership_candidates == 32
    assert reduced == sched.brownout_config(FAST)
    for _ in range(2):
        opt.optimize(st, config=reduced)
    assert (opt.engine_cache_misses, opt.engine_cache_hits) == (2, 1)
    assert sched.stats["brownout_cycles"] == 2


def test_preemptible_grant_scopes_the_pause_clock():
    """A preemptible grant scopes the ticket's pause clock to its context
    (common/device_watchdog.py), which reads 0 with no pause; an URGENT
    grant and code outside any grant have none."""
    sched = _scheduler()
    seen = {}

    def body(tag):
        clock = _current_pause_clock()
        seen[tag] = None if clock is None else clock()

    sched.run(WorkClass.BACKGROUND, lambda: body("bg"))
    sched.run(WorkClass.URGENT, lambda: body("urgent"))
    body("outside")
    assert seen == {"bg": 0.0, "urgent": None, "outside": None}
    # the clock rides a copied context into a worker thread
    got = []
    sched.run(WorkClass.BACKGROUND, lambda: got.append(
        contextvars.copy_context().run(lambda: _current_pause_clock() is not None)))
    assert got == [True]


def test_state_json_reports_the_ladder():
    sched = _scheduler()
    sched.run(WorkClass.INTERACTIVE, lambda: None)
    s = sched.state_json()
    assert s["enabled"] and s["queueDepth"] == 0 and s["holder"] is None
    assert s["dispatches"]["interactive"] == 1 and s["fastPathGrants"] == 1
    assert s["shedTotal"] == {"urgent": 0, "interactive": 0, "background": 0}


# ------------------------------------------ the supervisor and the slowdown injector


def test_supervisor_hang_budget_excludes_scheduler_pause():
    """Regression (review): time a preempted dispatch spends parked at a
    checkpoint is the scheduler doing its job — it must extend the
    DeviceSupervisor's hang deadline, not consume it."""
    from cruise_control_tpu_torch.common.device_watchdog import (
        DeviceDegradedError,
        DeviceSupervisor,
        pause_clock_scope,
    )

    sup = DeviceSupervisor(op_timeout_s=0.4, max_retries=0)
    pause = {"s": 0.0}

    def paused_fn():
        time.sleep(0.2)
        pause["s"] += 0.5  # "the scheduler paused us for 0.5s"
        time.sleep(0.4)
        return "ok"

    with pause_clock_scope(lambda: pause["s"]):
        # 0.6s wall against a 0.4s budget, but 0.5s of it is pause
        assert sup.call(paused_fn, op="optimize") == "ok"
    # without a pause clock the same wall is a genuine hang
    with pytest.raises(DeviceDegradedError):
        sup.call(lambda: time.sleep(0.6) or "ok", op="optimize")


def test_device_slowdown_scales_wall_and_restores():
    from cruise_control_tpu_torch.common.device_watchdog import device_op
    from cruise_control_tpu_torch.common import device_watchdog as wd

    calls = []

    @device_op("engine.run")
    def fake_run():
        calls.append(1)
        time.sleep(0.05)
        return 42

    t0 = time.monotonic()
    assert fake_run() == 42
    base = time.monotonic() - t0

    with faults.device_slowdown(3.0) as log:
        t0 = time.monotonic()
        assert fake_run() == 42
        slowed = time.monotonic() - t0
    assert log.calls.get("engine.run") == 1
    assert log.fired.get("engine.run") == 1
    # ~3x the observed wall (generous bounds for CI noise)
    assert slowed >= 2.0 * base
    # nest-safe restore: the hook is gone, walls are back to normal
    assert wd._DEVICE_OP_HOOK is None
    t0 = time.monotonic()
    fake_run()
    assert time.monotonic() - t0 < 2.0 * base + 0.05


def test_device_slowdown_nests_inside_other_injectors():
    from cruise_control_tpu_torch.common.device_watchdog import device_op

    @device_op("engine.run")
    def fake_run():
        return "ok"

    @device_op("probe")
    def fake_probe():
        return "probe"

    with faults.device_slowdown(1.5) as outer:
        with faults.device_slowdown(
            1.5, ops=("probe",)
        ) as inner:
            assert fake_probe() == "probe"
            assert fake_run() == "ok"
    assert inner.calls.get("probe") == 1
    assert outer.calls.get("engine.run") == 1
    assert outer.calls.get("probe") is None  # inner consumed it first


def test_device_slowdown_rejects_bad_factor():
    with pytest.raises(ValueError):
        with faults.device_slowdown(0.5):
            pass


@pytest.mark.slow
def test_overload_chaos_gate_urgent_wait_bounded():
    """The acceptance soak: under device_slowdown x a 20-cluster synthetic
    burst, an injected broker-failure-fix dispatch's queue-to-dispatch
    wait stays <= one slice budget, BACKGROUND cycles shed (counted),
    zero URGENT sheds, and FLEET_OVERLOAD fires exactly once for the
    episode."""
    from cruise_control_tpu_torch.common.device_watchdog import device_op

    anomalies = []
    slice_s = 0.1
    sched = DeviceScheduler(
        slice_budget_s=slice_s * 1.5, freshness_slo_s=1.0, aging_s=0.5,
        shed_queue_depth=6, brownout_after_s=120.0,
        anomaly_sink=anomalies.append,
    )

    @device_op("engine.run")
    def device_cycle():
        # one "anneal slice" of device wall; the injector scales it
        time.sleep(0.02)

    def background_cycle():
        from cruise_control_tpu_torch.analyzer.engine import current_segment_context

        ctx = current_segment_context()
        for i in range(3):
            device_cycle()
            if ctx is not None and ctx.checkpoint is not None and i < 2:
                ctx.checkpoint()

    shed = [0]
    urgent_waits = []
    stop = threading.Event()

    def cluster_loop(cid):
        while not stop.is_set():
            try:
                sched.run(
                    WorkClass.BACKGROUND, background_cycle,
                    cluster_id=f"c{cid}", op="cycle",
                )
            except BackgroundShedError:
                shed[0] += 1
                time.sleep(0.02)

    with faults.device_slowdown(3.0) as log:
        threads = [
            threading.Thread(target=cluster_loop, args=(i,), daemon=True)
            for i in range(20)
        ]
        for t in threads:
            t.start()
        time.sleep(0.3)  # let the burst overload the queue
        for _ in range(5):
            t0 = time.monotonic()
            sched.run(
                WorkClass.URGENT, device_cycle, cluster_id="cX",
                op="fix:broker-failure",
            )
            urgent_waits.append(time.monotonic() - t0 - 0.02 * 3.0)
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(5.0)
    assert log.total_calls > 0  # the slowdown actually hit device ops
    # URGENT p99 (here: max of 5) queue-to-dispatch wait <= one slice
    # budget — one slowed background slice (0.06s) + scheduling slack
    assert max(urgent_waits) <= sched.slice_budget_s + 0.1, urgent_waits
    assert sched.stats["sheds"]["urgent"] == 0
    assert shed[0] >= 1, "background never shed under the burst"
    assert sched.stats["sheds"]["background"] == shed[0]
    episodes = sched.stats["overload_episodes"]
    assert len(anomalies) == episodes >= 1
    assert all(a.anomaly_type is AnomalyType.FLEET_OVERLOAD for a in anomalies)


# ------------------------- the service under the scheduler (tests/test_scheduler.py :483-828)


def test_precompute_refresh_is_background_class():
    """The periodic proposal refresh is exactly the steady-state load
    the shed ladder exists to relieve — it must dispatch BACKGROUND."""
    from cruise_control_tpu_torch.service.main import build_simulated_service
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fetcher, admin, sampler = build_simulated_service(
        _scheduler_service_config(), device="cpu"
    )
    try:
        cc = app.cc
        cc.proposals(
            OperationProgress(), ignore_cache=True,
            work_class=WorkClass.BACKGROUND,
        )
        assert cc.scheduler.stats["dispatches"]["background"] == 1
        assert cc.scheduler.stats["dispatches"]["interactive"] == 0
    finally:
        app.stop()


def test_cluster_override_of_shared_scheduler_and_tenant_keys_rejected():
    from cruise_control_tpu_torch.config.app_config import (
        ConfigException,
        CruiseControlConfig,
    )

    base = {"fleet.clusters": "east"}
    # the per-cluster freshness SLO IS overridable...
    cfg = CruiseControlConfig(
        {**base, "fleet.east.fleet.scheduler.freshness.slo.s": 10.0,
         "fleet.scheduler.freshness.slo.s": 45.0}
    )
    assert cfg.cluster_config("east").get(
        "fleet.scheduler.freshness.slo.s"
    ) == 10.0
    # ...every other scheduler/tenant knob configures the ONE shared
    # scheduler/purgatory and must be rejected, not silently ignored
    for key in (
        "fleet.east.fleet.scheduler.slice.budget.s",
        "fleet.east.fleet.tenant.retry.after.s",
    ):
        with pytest.raises(ConfigException):
            CruiseControlConfig({**base, key: 2.0}).cluster_config("east")


def test_tenant_retry_after_drain_rate_and_fallback():
    m = UserTaskManager(num_threads=2)
    try:
        # no history: config default wins
        assert m.retry_after_s("east", default_s=7.0) == 7.0
        # fabricate a drain history: 5 completions 1s apart -> 1 task/s
        import collections

        stamps = collections.deque(maxlen=32)
        base = time.monotonic()
        for i in range(5):
            stamps.append(base + i)
        m._completions["east"] = stamps
        gate = threading.Event()
        for _ in range(3):
            m.submit("proposals", lambda p: gate.wait(5.0), cluster_id="east")
        ra = m.retry_after_s("east", default_s=7.0)
        # 3 pending / 1 per second ~ 3s (never below 1, never 300)
        assert 2.0 <= ra <= 4.0, ra
        gate.set()
    finally:
        m.shutdown()


def test_tenant_overload_error_carries_retry_after():
    m = UserTaskManager(num_threads=2)
    try:
        gate = threading.Event()
        m.submit("proposals", lambda p: gate.wait(5.0), cluster_id="east",
                 cluster_max_active=1)
        from cruise_control_tpu_torch.service.tasks import TenantOverloadError

        with pytest.raises(TenantOverloadError):
            m.submit("proposals", lambda p: None, cluster_id="east",
                     cluster_max_active=1)
        gate.set()
    finally:
        m.shutdown()


def _scheduler_service_config(**extra):
    from cruise_control_tpu_torch.config.app_config import CruiseControlConfig

    props = {
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "num.partition.metrics.windows": 3,
        "execution.progress.check.interval.ms": 100,
        "webserver.http.port": 0,
        "tpu.num.candidates": 128,
        "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 16,
        "tpu.num.rounds": 2,
        # memory note: prewarm threads + pytest teardown don't mix
        "tpu.prewarm.enabled": "false",
        "fleet.scheduler.enabled": "true",
        "fleet.scheduler.slice.budget.s": 0.2,
    }
    props.update(extra)
    return CruiseControlConfig(props)


def test_service_proposals_fast_path_unsegmented_when_alone():
    # A lone INTERACTIVE proposals call takes the scheduler's fast path:
    # with nobody else queued there is no one to preempt for, so the
    # grant runs the plain unsegmented fused program.
    from cruise_control_tpu_torch.service.main import build_simulated_service
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fetcher, admin, sampler = build_simulated_service(
        _scheduler_service_config(), device="cpu"
    )
    try:
        cc = app.cc
        assert cc.scheduler is not None
        result = cc.proposals(OperationProgress(), ignore_cache=True)
        timing = next(h for h in result.history if h.get("timing"))
        assert timing.get("segmented") is not True
        assert cc.scheduler.stats["dispatches"]["interactive"] == 1
        assert cc.scheduler.stats["fast_path_grants"] == 1
        # published-proposal age surfaces on the gauge and /fleet rollup
        age = cc.sensors.snapshot()["analyzer.proposal-age-seconds"]["value"]
        assert age >= 0.0
        from cruise_control_tpu_torch.fleet.manager import shared_core_rollup

        shared = shared_core_rollup(cc.core)
        assert shared["scheduler"]["enabled"] is True
        assert shared["scheduler"]["dispatches"]["interactive"] == 1
        assert shared["scheduler"]["fastPathGrants"] == 1
    finally:
        app.stop()


def test_service_proposals_run_segmented_with_fast_path_off():
    from cruise_control_tpu_torch.service.main import build_simulated_service
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fetcher, admin, sampler = build_simulated_service(
        _scheduler_service_config(
            **{"fleet.scheduler.fast.path.enabled": "false"}
        ), device="cpu"
    )
    try:
        cc = app.cc
        assert cc.scheduler is not None
        result = cc.proposals(OperationProgress(), ignore_cache=True)
        timing = next(h for h in result.history if h.get("timing"))
        assert timing.get("segmented") is True
        assert cc.scheduler.stats["dispatches"]["interactive"] == 1
        assert cc.scheduler.stats["fast_path_grants"] == 0
    finally:
        app.stop()


def test_scheduler_default_off_is_todays_path():
    from cruise_control_tpu_torch.service.main import build_simulated_service
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fetcher, admin, sampler = build_simulated_service(
        _scheduler_service_config(**{"fleet.scheduler.enabled": "false"}), device="cpu"
    )
    try:
        cc = app.cc
        assert cc.scheduler is None
        result = cc.proposals(OperationProgress(), ignore_cache=True)
        timing = next(h for h in result.history if h.get("timing"))
        # the plain fused program: one dispatch, one blocking sync,
        # nothing segmented — byte-for-byte today's dispatch
        assert "segmented" not in timing
        assert timing["blocking_syncs"] == 1
        from cruise_control_tpu_torch.fleet.manager import shared_core_rollup

        assert "scheduler" not in shared_core_rollup(cc.core)
    finally:
        app.stop()


def test_self_healing_fix_dispatches_urgent():
    from cruise_control_tpu_torch.service.main import build_simulated_service

    app, fetcher, admin, sampler = build_simulated_service(
        _scheduler_service_config(), device="cpu"
    )
    try:
        cc = app.cc
        assert cc.actions.rebalance("test-fix") is True
        assert cc.scheduler.stats["dispatches"]["urgent"] >= 1
        assert cc.scheduler.stats["sheds"]["urgent"] == 0
    finally:
        app.stop()
