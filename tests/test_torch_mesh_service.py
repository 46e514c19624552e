"""The mesh modes through the port's optimizer and service against the JAX
package's, on the CPU.

`GoalOptimizer(parallel_mode="sharded" | "grid:2x2", mesh_ft disabled)` and
`build_simulated_service` with `tpu.parallel.mode` set to them and
`tpu.mesh.ft.enabled=false` serve their proposals from a rank group of 4
gloo ranks (`tpu.mesh.max.devices` names the CPU's rank count); the JAX
package's optimizer and service, on its virtual CPU devices capped at 4,
give the same proposals, the same placements and the same balancedness;
the goal-chain objectives within rtol 1e-6 (ROADMAP queue 3's CPU bars).
Under the default `tpu.mesh.ft.enabled=true` (supervised, the width ladder
armed) both services serve the same proposals too.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.config import CruiseControlConfig as JCCConfig
from cruise_control_tpu.parallel.ft import MeshFtController as JMeshFt
from cruise_control_tpu.service.main import build_simulated_service as j_build
from cruise_control_tpu.service.progress import OperationProgress as JProgress
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.config import CruiseControlConfig as TCCConfig
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.parallel import close_rank_groups, cpu_devices, rank_group
from cruise_control_tpu_torch.service.main import build_simulated_service as t_build
from cruise_control_tpu_torch.service.progress import OperationProgress as TProgress

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
PROPS = {
    "tpu.num.candidates": 128, "tpu.leadership.candidates": 32, "tpu.steps.per.round": 16,
    "tpu.num.rounds": 2, "tpu.prewarm.enabled": "false", "tpu.mesh.ft.enabled": "false",
    "tpu.mesh.max.devices": 4,
}


@pytest.fixture(scope="module", autouse=True)
def world():
    g = rank_group(cpu_devices(4))
    yield g
    close_rank_groups()


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _keys(proposals):
    return sorted((p.partition, p.topic, p.old_leader, p.new_leader, tuple(p.old_replicas),
                   tuple(p.new_replicas), tuple(p.disk_moves)) for p in proposals)


def _same_result(t, j) -> None:
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t.state_after, f).numpy(),
                                      np.asarray(getattr(j.state_after, f)), err_msg=f)
    assert _keys(t.proposals) == _keys(j.proposals)
    assert t.balancedness_after == j.balancedness_after
    np.testing.assert_allclose(t.objective_after, j.objective_after, rtol=1e-6)
    np.testing.assert_allclose(t.violations_after, np.asarray(j.violations_after), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("mode", ["sharded", "grid:2x2"])
def test_optimizer_mesh_modes_match_jax(mode):
    js = jf.dead_broker_cluster()
    j = JOptimizer(config=JConfig(**FAST), parallel_mode=mode, mesh_max_devices=4,
                   mesh_ft=JMeshFt(enabled=False)).optimize(js)
    opt = TOptimizer(config=TConfig(**FAST), parallel_mode=mode, device="cpu", mesh_max_devices=4)
    t = opt.optimize(_port(js))
    _same_result(t, j)
    tt = next(h for h in t.history if h.get("timing"))
    jt = next(h for h in j.history if h.get("timing"))
    assert tt["mesh_shape"] == jt["mesh_shape"] == ([1, 4] if mode == "sharded" else [2, 2])
    assert tt["backend"] == "gloo" and tt["ranks"] == 4


@pytest.mark.parametrize("mode", ["sharded", "grid:2x2"])
def test_service_serves_mesh_proposals_like_jax(mode):
    props = {**PROPS, "tpu.parallel.mode": mode}
    t_app, *_ = t_build(TCCConfig(props), seed=3, device="cpu")
    j_app, *_ = j_build(JCCConfig(props), seed=3)
    try:
        t = t_app.cc.proposals(TProgress(), ignore_cache=True)
        j = j_app.cc.proposals(JProgress(), ignore_cache=True)
        _same_result(t, j)
        timing = next(h for h in t.history if h.get("timing"))
        assert timing["mesh_shape"] == ([1, 4] if mode == "sharded" else [2, 2])
        assert t_app.cc.optimizer.parallel_mode == mode
        assert t_app.cc.sensors.get("analyzer.mesh-runs").count == 1
    finally:
        t_app.cc.shutdown()
        j_app.cc.shutdown()


@pytest.mark.parametrize("mode", ["sharded", "grid:2x2"])
def test_service_with_mesh_ft_enabled_serves_like_jax(mode):
    props = {k: v for k, v in PROPS.items() if k != "tpu.mesh.ft.enabled"}
    props["tpu.parallel.mode"] = mode
    t_app, *_ = t_build(TCCConfig(props), seed=3, device="cpu")
    j_app, *_ = j_build(JCCConfig(props), seed=3)
    try:
        ft = t_app.cc.optimizer._mesh_ft
        assert ft is not None and ft.enabled and t_app.cc.optimizer.supervisor is not None
        t = t_app.cc.proposals(TProgress(), ignore_cache=True)
        j = j_app.cc.proposals(JProgress(), ignore_cache=True)
        _same_result(t, j)
        assert not t.degraded and not any(h.get("mesh_ft") for h in t.history)
        assert ft.state_json()["activeWidth"] == 4 and ft.episodes == 0
    finally:
        t_app.cc.shutdown()
        j_app.cc.shutdown()
