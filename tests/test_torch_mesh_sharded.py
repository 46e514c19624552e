"""The port's candidate-sharded mesh against the JAX package's MeshEngine, on
the CPU: sharded layouts 1x2 and 1x4 on dead_broker_cluster and
jbod_cluster (test_torch_mesh_parity.py has the other two fixtures).

The JAX side is `MeshEngine` on the virtual CPU devices tests/conftest.py
gives; the port's is one module-scoped gloo rank group of 4 spawned
processes.  For each fixture and width the port's placements are byte for
byte the JAX mesh's and the port's plain engine's, the round records
(accepted counts) the JAX mesh's (temperatures rtol 1e-6: they scale the
initial objective, which the JAX package's compiled program may round an
ulp apart, as tests/test_torch_fused.py says), every rank's final carry
the plain engine's bit for bit, and the ranks gathered once a step.
The heavy JAX compiles are spread over files so `--dist loadfile`
spreads them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.parallel.mesh import MeshEngine as JMeshEngine
from cruise_control_tpu.parallel.mesh import model_mesh as j_model_mesh
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.parallel import ShardedEngine, close_rank_groups, cpu_devices, model_mesh, rank_group
from cruise_control_tpu_torch.parallel.mesh import _carry_digest

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FIXTURES = ["dead_broker_cluster", "jbod_cluster"]
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
DEVS = cpu_devices(4)


@pytest.fixture(scope="module", autouse=True)
def world():
    g = rank_group(DEVS)
    yield g
    close_rank_groups()


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _rounds(history):
    return [h for h in history if "round" in h]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", FIXTURES)
def test_sharded_placements_match_the_jax_mesh_and_the_plain_engine(name, n):
    js = getattr(jf, name)()
    j_final, j_hist = JMeshEngine(js, J_CHAIN, mesh=j_model_mesh(jax.devices()[:n]),
                                  config=JConfig(**FAST)).run()
    st = _port(js)
    plain = TEngine(st, T_CHAIN, config=TConfig(**FAST))
    p_final, p_hist = plain.run()
    se = ShardedEngine(st, T_CHAIN, mesh=model_mesh(DEVS[:n]), config=TConfig(**FAST))
    t_final, t_hist = se.run()
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                      err_msg=f"{name} 1x{n}: {f} differs from the JAX mesh")
        assert torch.equal(getattr(t_final, f), getattr(p_final, f)), f
    tr, jr = _rounds(t_hist), _rounds(j_hist)
    assert [h["accepted"] for h in tr] == [h["accepted"] for h in jr]
    assert [h.get("extra", False) for h in tr] == [h.get("extra", False) for h in jr]
    np.testing.assert_allclose([h["temperature"] for h in tr], [h["temperature"] for h in jr],
                               rtol=1e-6)
    timing = t_hist[-1]
    assert timing["mesh_shape"] == [1, n] and timing["blocking_syncs"] == 1
    assert se.carry_digests() == [_carry_digest(plain._ws.carry)] * n
    assert se.last_info["gather_calls"] == [len(tr) * FAST["steps_per_round"]] * n
    se.release()
