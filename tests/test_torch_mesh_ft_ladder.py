"""Mesh fault tolerance with segmented mesh runs on the CPU (gloo ranks): the
supervisor's mesh half (common/device_watchdog.py), the mesh engine's
checkpoints and resume (parallel/mesh.py) and the optimizer's width ladder
(analyzer/optimizer.py `_optimize_mesh_ft`).

The port's statements of the JAX package's tests/test_mesh_ft.py (the
tests of tests/test_torch_mesh_ft.py need no mesh):
- :136-:240 the taxonomy with the rank group's errors; the probe latch (a
  killed rank's probe fails, the others answer); attribution of a dead
  rank under a width breaker, sparing the single-device breaker; a strict
  subset of the ranks stopped (SIGSTOP), a COLLECTIVE_STALL naming it;
- :340 a segmented 1x4 run with snapshots and a resume at 1x2 from one of
  them, each byte for byte the JAX package's engine on the same fixture,
  the checkpoint unchanged by the resume;
- :424 a process killed (-9) inside a mesh dispatch: the black box's
  verdict names the width in flight;
- :481 the scoped purge; :518 the default wiring;
- :580 the degrade-and-resume ladder, a rank SIGKILLed at a slice
  boundary, against the JAX optimizer's result on the same fixture.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.testing.fixtures import RandomClusterSpec as JSpec
from cruise_control_tpu.testing.fixtures import random_cluster as j_cluster
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, GoalOptimizer, OptimizerConfig
from cruise_control_tpu_torch.analyzer.engine import SegmentContext, segmented_execution
from cruise_control_tpu_torch.common.blackbox import RECORDER, read_spool, spool_verdict
from cruise_control_tpu_torch.common.device_watchdog import (
    MESH_FAILURE_CLASSES,
    BreakerState,
    CircuitBreaker,
    CollectiveStallError,
    DeviceDegradedError,
    DeviceLostError,
    DeviceSupervisor,
    FailureClass,
    classify_failure,
    probe_devices,
)
from cruise_control_tpu_torch.common.dispatch import dispatch_meter
from cruise_control_tpu_torch.common.sensors import SensorRegistry
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.parallel import MeshFtController, ShardedEngine, model_mesh
from cruise_control_tpu_torch.parallel.ranks import (
    RankCommandError,
    RankDiedError,
    RankTimeoutError,
    close_rank_groups,
    cpu_devices,
    live_group,
    rank_group,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
DEVS = cpu_devices(N)
#: the JAX package's CFG (tests/test_mesh_ft.py): early stop off, so the
#: slice count is fixed and a fault lands at a known boundary
CFG = dict(num_candidates=60, leadership_candidates=16, swap_candidates=8, steps_per_round=6,
           num_rounds=4, early_stop_violations=-1.0, seed=3)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


@pytest.fixture(autouse=True)
def _fresh_groups():
    """Each test starts its own rank groups: the faults below kill them."""
    yield
    RECORDER.configure(None)
    close_rank_groups()


@pytest.fixture(scope="module")
def states():
    js = j_cluster(JSpec(num_brokers=12, num_partitions=160, skew=1.5), seed=21)
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return js, from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


@pytest.fixture(scope="module")
def jax_result(states):
    """The JAX package's optimizer on the fixture (its sharded and
    interrupted runs are this result, byte for byte, by its own pins)."""
    return JOptimizer(config=JConfig(**CFG)).optimize(states[0])


def _same_as_jax(t_state, j_state) -> bool:
    return all(np.array_equal(getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f)))
               for f in PLACEMENT)


# ------------------------------------------------------------- :136-:240


def test_mesh_failure_taxonomy_with_the_rank_errors():
    assert MESH_FAILURE_CLASSES == {FailureClass.DEVICE_LOST, FailureClass.COLLECTIVE_STALL}
    assert classify_failure(DeviceLostError("gone", (3,))) is FailureClass.DEVICE_LOST
    assert classify_failure(CollectiveStallError("wedged", (1, 2))) is FailureClass.COLLECTIVE_STALL
    # a rank process that dies is a lost card; one that stops answering, a hang
    assert classify_failure(RankDiedError("rank 3 exited", 3)) is FailureClass.DEVICE_LOST
    assert classify_failure(RankTimeoutError("rank 1 silent", 1)) is FailureClass.HANG
    # a rank's command error is classified by what the rank raised
    sticky = RankCommandError("rank 2 failed 'run': CUDA error: an illegal memory access "
                              "was encountered", 2)
    assert classify_failure(sticky) is FailureClass.DEVICE_LOST
    assert classify_failure(RankCommandError("rank 2 failed 'run': ValueError: bad", 2)) is None
    assert FailureClass.HANG not in MESH_FAILURE_CLASSES
    assert FailureClass.TRANSIENT not in MESH_FAILURE_CLASSES
    # a rank's lost card is not the caller's CUDA context
    sup = DeviceSupervisor(op_timeout_s=5.0, device="cpu")
    sup._count(FailureClass.DEVICE_LOST, "optimize", RankDiedError("rank 3 exited", 3))
    assert not sup.context_lost
    sup._count(FailureClass.DEVICE_LOST, "optimize", RuntimeError("device-side assert triggered"))
    assert sup.context_lost


def test_a_killed_ranks_probe_fails_and_the_others_answer():
    g = rank_group(DEVS)
    assert all(d is None for d in probe_devices(DEVS, timeout_s=10.0).values())
    g.kill_rank(2)
    results = probe_devices(DEVS, timeout_s=10.0)
    assert results[2] is not None and "rank 2" in results[2]
    assert all(d is None for i, d in results.items() if i != 2)
    # no live group: every device is named unprobed
    g.close()
    assert all(d is not None for d in probe_devices(DEVS, timeout_s=1.0).values())


def test_supervisor_attributes_a_dead_rank_and_spares_the_main_breaker():
    sup = DeviceSupervisor(op_timeout_s=30.0, max_retries=0, probe_timeout_s=10.0, device="cpu")
    width_brk = CircuitBreaker(failure_threshold=1, probe_interval_s=60.0)
    g = rank_group(DEVS)

    def lose_rank_3():
        g.kill_rank(3)
        return g.call("probe")

    with pytest.raises(DeviceDegradedError) as ei:
        sup.call(lose_rank_3, op="optimize", breaker=width_brk, mesh_devices=DEVS)
    assert ei.value.failure_class is FailureClass.DEVICE_LOST
    assert ei.value.device_ids == (3,)
    assert width_brk.state is BreakerState.OPEN
    # the single-device breaker never heard about it
    assert sup.breaker.state is BreakerState.CLOSED and sup.available()
    assert not sup.context_lost
    assert sup.device_health()[3]["healthy"] is False
    assert sup.state_json()["deviceHealth"]["3"]["healthy"] is False


def test_supervisor_upgrades_a_subset_stall_to_collective_stall(tmp_path, states):
    RECORDER.configure(str(tmp_path / "spool-1.jsonl"))
    engine = ShardedEngine(states[1], DEFAULT_CHAIN, mesh=model_mesh(DEVS),
                           config=OptimizerConfig(**CFG))
    g = live_group(DEVS)
    os.kill(g.pids[3], signal.SIGSTOP)
    sup = DeviceSupervisor(op_timeout_s=1.0, max_retries=0, probe_timeout_s=2.0,
                           breaker_failure_threshold=100, device="cpu")
    with pytest.raises(DeviceDegradedError) as ei:
        sup.call(lambda: engine.run(), op="optimize", mesh_devices=DEVS)
    assert ei.value.failure_class is FailureClass.COLLECTIVE_STALL
    assert ei.value.device_ids == (3,)
    health = sup.device_health()
    assert health[3]["healthy"] is False and all(health[i]["healthy"] for i in (0, 1, 2))
    assert not g.alive  # the group with the stalled rank was killed
    records = read_spool(str(tmp_path / "spool-1.jsonl"))
    begin = [r for r in records if r["t"] == "device-op" and r["ph"] == "B" and r["op"] == "mesh.run"]
    assert begin and begin[-1]["mesh_shape"] == [1, N] and begin[-1]["n_devices"] == N
    probes = [r for r in records if r.get("kind") == "mesh-probe" or r.get("t") == "mesh-probe"]
    assert probes and probes[-1]["suspects"] == [3]


# ---------------------------------------------------------------------- :340


def test_segmented_mesh_parity_and_a_reduced_width_resume_match_jax(states, jax_result):
    _, ts = states
    cfg = OptimizerConfig(**CFG)
    se4 = ShardedEngine(ts, DEFAULT_CHAIN, mesh=model_mesh(DEVS), config=cfg)
    final, _ = se4.run()
    # the JAX package's plain engine, whose mesh runs are bit for bit it
    from cruise_control_tpu.analyzer import DEFAULT_CHAIN as JCHAIN
    from cruise_control_tpu.analyzer.engine import Engine as JEngine

    j_final, _ = JEngine(states[0], JCHAIN, config=JConfig(**CFG)).run()
    assert _same_as_jax(final, j_final)
    snaps = []
    ctx = SegmentContext(0.0, snapshot_every=1, snapshot_sink=snaps.append)
    with segmented_execution(ctx), dispatch_meter() as m_on:
        final_seg, hist_seg = se4.run()
    ctx.wait_snapshot()
    timing = hist_seg[-1]
    assert timing["segmented"] is True and timing["segments"] >= 3
    assert timing["snapshots"] >= 2 and timing["snapshot_s"] >= 0.0
    assert m_on.counts["mesh.snapshot"] == timing["snapshots"]
    assert _same_as_jax(final_seg, j_final)
    # checkpointing off: no snapshot dispatch
    with segmented_execution(SegmentContext(0.0)), dispatch_meter() as m_off:
        final_off, _ = se4.run()
    assert m_off.counts.get("mesh.snapshot", 0) == 0
    assert _same_as_jax(final_off, j_final)
    se4.release()
    # a mid-anneal checkpoint resumed on a narrower mesh
    ck = snaps[1]
    assert ck.base >= 1 and ck.n_chains == 1
    before = {k: v.copy() for k, v in {**ck.carry, **ck.seg}.items()}
    se2 = ShardedEngine(ts, DEFAULT_CHAIN, mesh=model_mesh(DEVS[:2]), config=cfg)
    final2, hist2 = se2.run(resume=ck)
    assert hist2[-1]["resumed_from_round"] == ck.base and hist2[-1]["mesh_shape"] == [1, 2]
    assert _same_as_jax(final2, j_final)
    # the resume never writes into the checkpoint: a second one is exact
    after = {**ck.carry, **ck.seg}
    assert all(before[k].tobytes() == after[k].tobytes() for k in before)  # NaN rows too
    final2b, _ = se2.run(resume=ck)
    assert _same_as_jax(final2b, j_final)
    se2.release()


# ---------------------------------------------------------------------- :424


_MESH_KILL_CHILD = textwrap.dedent("""
    import os, sys, threading
    sys.path.insert(0, {repo!r})

    def main():
        from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, OptimizerConfig
        from cruise_control_tpu_torch.common.blackbox import RECORDER
        from cruise_control_tpu_torch.parallel import ShardedEngine, cpu_devices, model_mesh
        from cruise_control_tpu_torch.testing import faults
        from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster

        RECORDER.configure(os.path.join({spool_dir!r}, f"spool-{{os.getpid()}}.jsonl"))
        state = random_cluster(RandomClusterSpec(num_brokers=8, num_partitions=48, skew=1.0),
                               seed=0, device="cpu")
        cfg = OptimizerConfig(num_candidates=32, leadership_candidates=8, swap_candidates=0,
                              steps_per_round=2, num_rounds=2, seed=0)
        se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh(cpu_devices(4)), config=cfg)
        # the wedged collective: the mesh dispatch blocks with its Begin
        # record (the width stamped) on disk
        with faults.device_fault(lambda op, fn, a, k: threading.Event().wait(),
                                 ops=("mesh.run",)):
            se.run()
        print("UNREACHABLE")

    if __name__ == "__main__":
        main()
""")


def test_kill9_mid_mesh_dispatch_verdict_names_the_width(tmp_path):
    spool_dir = str(tmp_path / "spool")
    os.makedirs(spool_dir)
    script = tmp_path / "child.py"
    script.write_text(_MESH_KILL_CHILD.format(repo=REPO, spool_dir=spool_dir))
    child = subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if any(r["t"] == "device-op" and r["ph"] == "B" and r.get("op") == "mesh.run"
                   and r.get("n_devices") == 4 for r in read_spool(spool_dir)):
                break
            if child.poll() is not None:
                _, err = child.communicate(timeout=10)
                pytest.fail(f"child exited rc={child.returncode} before hanging:\n"
                            f"{err.decode(errors='replace')[-2000:]}")
            time.sleep(0.05)
        else:
            pytest.fail("the child never dispatched on the mesh")
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
    verdict = spool_verdict(spool_dir)
    assert verdict["mesh_in_flight"]["op"] == "mesh.run"
    assert verdict["mesh_in_flight"]["mesh_shape"] == [1, 4]
    assert verdict["mesh_in_flight"]["n_devices"] == 4


# ---------------------------------------------------------------------- :481


class _Dummy:
    def __init__(self):
        self.released = False
        self._cc_pins, self._cc_evicted = 0, False

    def release(self):
        self.released = True


def test_purge_is_scoped_to_the_failing_cards():
    sup = DeviceSupervisor(op_timeout_s=5.0, breaker_failure_threshold=1, device="cpu")
    opt = GoalOptimizer(config=OptimizerConfig(**CFG), device="cpu", parallel_mode="sharded",
                        mesh_max_devices=N, supervisor=sup, mesh_ft=MeshFtController())
    single, wide, narrow = _Dummy(), _Dummy(), _Dummy()
    opt._engines[("shape", 3, "cfg")] = single
    cards = tuple(f"cuda:{i}" for i in range(8))
    opt._parallel_engines[("mesh", "shape", "cfg", cards)] = wide
    opt._parallel_engines[("mesh", "shape", "cfg", cards[:4])] = narrow
    opt._purge_parallel_for_mesh_failure((5,), list(range(8)))
    assert wide.released and not narrow.released and not single.released
    assert ("mesh", "shape", "cfg", cards[:4]) in opt._parallel_engines
    assert ("shape", 3, "cfg") in opt._engines
    # the single-device breaker opens: only the single-device engines go
    sup.breaker.record_failure()
    assert sup.breaker.state is BreakerState.OPEN
    opt._maybe_purge_after_open()
    assert single.released and not opt._engines
    assert ("mesh", "shape", "cfg", cards[:4]) in opt._parallel_engines
    # mesh ft off: the mesh rides the single-device breaker and goes too
    opt._mesh_ft = MeshFtController(enabled=False)
    opt._breaker_epoch = sup.open_epoch - 1
    opt._maybe_purge_after_open()
    assert narrow.released and not opt._parallel_engines


# ---------------------------------------------------------------------- :518


def test_goal_optimizer_default_mesh_ft_wiring():
    sup = DeviceSupervisor(op_timeout_s=5.0, device="cpu")
    cfg = OptimizerConfig(**CFG)
    opt = GoalOptimizer(config=cfg, device="cpu", parallel_mode="sharded", mesh_max_devices=N,
                        supervisor=sup)
    assert opt._mesh_ft is not None and opt._mesh_ft.enabled
    assert opt._mesh_ft.checkpoint_every_slices == 0
    assert GoalOptimizer(config=cfg, device="cpu", supervisor=sup)._mesh_ft is None
    assert GoalOptimizer(config=cfg, device="cpu", parallel_mode="sharded",
                         mesh_max_devices=N)._mesh_ft is None


# ---------------------------------------------------------------------- :580


def test_degrade_and_resume_ladder_matches_jax(states, jax_result):
    """The rank on device 3 is SIGKILLed at the second slice boundary of a
    supervised sharded anneal: the ladder names the loss, opens the width-4
    breaker (never the single-device one), rebuilds over the survivors at
    width 2, resumes from the last checkpoint, and the final placements are
    the JAX optimizer's, byte for byte, with one MESH_DEGRADED event."""
    from cruise_control_tpu_torch.service.facade import CruiseControl

    _, ts = states
    reg = SensorRegistry()
    sup = DeviceSupervisor(op_timeout_s=120.0, max_retries=0, probe_timeout_s=10.0,
                           sensors=reg, device="cpu")
    ft = MeshFtController(checkpoint_every_slices=1, sensors=reg)
    opt = GoalOptimizer(config=OptimizerConfig(**CFG), device="cpu", parallel_mode="sharded",
                        mesh_max_devices=N, supervisor=sup, mesh_ft=ft, sensors=reg)
    lost = 3
    seen = {"n": 0}

    def chk():
        seen["n"] += 1
        if seen["n"] == 2:
            live_group(DEVS).kill_rank(lost)

    with segmented_execution(SegmentContext(0.0, chk)):
        result = opt.optimize(ts)
    assert not result.degraded, "the ladder must serve from the mesh"
    rec = next(h for h in reversed(result.history) if h.get("mesh_ft"))
    assert rec["lost_devices"] == [lost]
    assert rec["width"] == 2 and rec["full_width"] == N
    assert rec["resumed"] is True and rec["resumed_from_round"] >= 1
    timing = next(h for h in result.history if h.get("timing") and h.get("segmented"))
    assert timing["resumed_from_round"] == rec["resumed_from_round"]
    assert timing["mesh_shape"] == [1, 2]
    # byte parity with the JAX optimizer's uninterrupted result
    assert _same_as_jax(result.state_after, jax_result.state_after)
    assert result.balancedness_after == jax_result.balancedness_after
    # one episode, one event; the breakers scoped
    assert ft.episodes == 1 and ft.episode_open
    stub = types.SimpleNamespace(optimizer=opt)
    event = CruiseControl._detect_mesh_degraded(stub)
    assert event is not None and event.failure_class == "device_lost"
    assert event.from_width == N and event.to_width == 2
    assert CruiseControl._detect_mesh_degraded(stub) is None
    snap = ft.state_json()
    assert snap["breakers"][str(N)]["state"] == "open"
    assert snap["breakers"]["2"]["state"] == "closed"
    assert sup.breaker.state is BreakerState.CLOSED and sup.available()
    # the width-4 engine (touching the lost rank's device) was purged; the
    # width-2 engine stays cached for the next request
    cached = [k[3] for k in opt._parallel_engines]
    assert cached == [tuple(DEVS[:2])]
    assert reg.get("analyzer.mesh-ft.resumes").count == 1
    assert reg.get("analyzer.mesh-ft.device-lost").count == 1
    assert reg.get("analyzer.mesh-ft.active-width").snapshot()["value"] == 2
