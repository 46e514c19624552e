"""The port's mesh fault-tolerance controller (parallel/ft.py) on the CPU.

tests/test_mesh_ft.py's tests that need no mesh, pointed at the port:
test_controller_per_width_breakers_and_probe_lifecycle,
test_controller_episode_fires_once_and_rearms_at_full_width,
test_offer_snapshot_cadence_one_in_flight_and_off_path,
test_config_mesh_ft_accessor_and_validation and
test_mesh_degraded_anomaly_and_facade_detector.  The tests that drive a
mesh are tests/test_torch_mesh_ft_ladder.py.
"""

import threading
import types

import pytest

from cruise_control_tpu_torch.analyzer.engine import SegmentContext
from cruise_control_tpu_torch.common.device_watchdog import BreakerState
from cruise_control_tpu_torch.parallel.ft import CheckpointSlot, MeshFtController


# ------------------------------------------ tests/test_mesh_ft.py :252-578


def test_controller_per_width_breakers_and_probe_lifecycle():
    now = {"t": 0.0}
    ft = MeshFtController(probe_interval_s=10.0, clock=lambda: now["t"])
    brk = ft.acquire_width(8)
    assert brk is not None and brk.state is BreakerState.CLOSED
    brk.record_failure()
    assert brk.state is BreakerState.OPEN
    # widths are independent breakers
    assert ft.acquire_width(4) is not None
    assert ft.acquire_width(8) is None  # probe not due yet
    now["t"] = 11.0
    probe = ft.acquire_width(8)  # the attempt IS the half-open probe
    assert probe is brk and brk.state is BreakerState.HALF_OPEN
    ft.note_width_result(8, ok=False)  # failed probe re-arms the timer
    assert brk.state is BreakerState.OPEN and ft.acquire_width(8) is None
    now["t"] = 22.0
    assert ft.acquire_width(8) is brk
    ft.note_width_result(8, ok=True)
    assert brk.state is BreakerState.CLOSED


def test_controller_episode_fires_once_and_rearms_at_full_width():
    ft = MeshFtController()
    assert ft.poll_event() is None
    ft.note_degrade(lost=(6,), from_width=8, to_width=4,
                    failure_class="device_lost")
    assert ft.episodes == 1 and ft.episode_open
    event = ft.poll_event()
    assert event["lost_devices"] == [6] and event["episode"] == 1
    assert ft.poll_event() is None  # exactly once per episode
    # walking further down the ladder inside the episode: no re-fire
    ft.note_degrade(lost=(3,), from_width=4, to_width=2,
                    failure_class="collective_stall")
    assert ft.episodes == 1 and ft.poll_event() is None
    assert ft.last_event["to_width"] == 2
    # completing at reduced width keeps the episode open...
    ft.note_run_completed(width=2, full_width=8)
    assert ft.episode_open
    # ...recovery to FULL width closes it, re-arming the anomaly
    ft.note_run_completed(width=8, full_width=8)
    assert not ft.episode_open
    ft.note_degrade(lost=(1,), from_width=8, to_width=4,
                    failure_class="device_lost")
    assert ft.episodes == 2 and ft.poll_event()["episode"] == 2
    state = ft.state_json()
    assert state["episodes"] == 2 and state["activeWidth"] == 4


def test_offer_snapshot_cadence_one_in_flight_and_off_path():
    slot = CheckpointSlot()
    assert slot.latest() is None
    gate = threading.Event()
    landed = []

    def slow_sink(ckpt):
        gate.wait(10.0)
        slot.offer(ckpt)
        landed.append(ckpt)

    ctx = SegmentContext(0.0, snapshot_every=2, snapshot_sink=slow_sink)
    ctx.offer_snapshot(lambda: "b1")  # boundary 1: not due
    assert ctx.snapshots_taken == 0
    ctx.offer_snapshot(lambda: "b2")  # boundary 2: captured, persisting
    ctx.offer_snapshot(lambda: "b3")  # boundary 3: not due
    ctx.offer_snapshot(lambda: "b4")  # boundary 4: due but in flight → skip
    assert ctx.snapshots_taken == 1 and ctx.snapshots_skipped == 1
    assert slot.latest() is None  # persist still blocked
    gate.set()
    ctx.wait_snapshot()
    assert slot.latest() == "b2" and landed == ["b2"]
    # a raising sink is logged, never raised into the run it protects
    bad = SegmentContext(
        0.0, snapshot_every=1,
        snapshot_sink=lambda c: (_ for _ in ()).throw(OSError("disk full")),
    )
    bad.offer_snapshot(lambda: "x")
    bad.wait_snapshot()
    assert bad.snapshots_taken == 1
    # snapshot_every=0 (the default): capture must never even be called
    off = SegmentContext(0.0, snapshot_sink=slot.offer)
    off.offer_snapshot(lambda: pytest.fail("off path must not capture"))
    assert off.snapshots_taken == 0


def test_config_mesh_ft_accessor_and_validation():
    from cruise_control_tpu_torch.config import ConfigException, CruiseControlConfig

    c = CruiseControlConfig({
        "tpu.parallel.mode": "sharded",
        "tpu.mesh.ft.checkpoint.every.slices": 2,
    })
    ft = c.mesh_ft_controller()
    assert ft is not None and ft.enabled and ft.checkpoint_every_slices == 2
    assert CruiseControlConfig({}).mesh_ft_controller() is None  # single
    off = CruiseControlConfig({
        "tpu.parallel.mode": "sharded", "tpu.mesh.ft.enabled": False,
    }).mesh_ft_controller()
    assert off is not None and not off.enabled
    with pytest.raises(ConfigException):
        CruiseControlConfig({"tpu.mesh.ft.checkpoint.every.slices": -1})


def test_mesh_degraded_anomaly_and_facade_detector():
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType, MeshDegraded
    from cruise_control_tpu_torch.service.facade import CruiseControl

    a = MeshDegraded(
        lost_devices=[6], from_width=8, to_width=4,
        failure_class="device_lost", episode=1,
    )
    assert a.anomaly_type is AnomalyType.MESH_DEGRADED
    assert a.fixable is False  # alert-only: the width ladder IS the fix
    assert "8->4" in a.description() and "device_lost" in a.description()
    # the facade detector drains the controller's once-per-episode event
    ft = MeshFtController()
    stub = types.SimpleNamespace(
        optimizer=types.SimpleNamespace(_mesh_ft=ft)
    )
    assert CruiseControl._detect_mesh_degraded(stub) is None
    ft.note_degrade(lost=(6,), from_width=8, to_width=4,
                    failure_class="device_lost")
    anomaly = CruiseControl._detect_mesh_degraded(stub)
    assert isinstance(anomaly, MeshDegraded)
    assert anomaly.lost_devices == [6] and anomaly.to_width == 4
    assert CruiseControl._detect_mesh_degraded(stub) is None  # drained
    # no controller (single-device mode): detector is a no-op
    none_stub = types.SimpleNamespace(optimizer=types.SimpleNamespace())
    assert CruiseControl._detect_mesh_degraded(none_stub) is None
