"""The port's grid layout (a portfolio of candidate-sharded chains) against
the JAX package's MeshEngine, on the CPU: 2x2 on the four small fixtures.

As test_torch_mesh_portfolio.py does for 2x1 and 4x1: each chain's
objective bit for bit the JAX package's op-by-op evaluation of the chain's
final carry (the compiled program's within rtol 1e-6, ROADMAP queue 3's
CPU bars), the JAX winner, its placement byte for byte; and here the two
ranks of each model row end with bitwise-equal carries after gathering
once a step.
"""

import dataclasses

import jax
import numpy as np
import pytest

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.parallel.mesh import MeshEngine as JMeshEngine
from cruise_control_tpu.parallel.mesh import grid_mesh as j_grid_mesh
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.parallel import GridEngine, close_rank_groups, cpu_devices, grid_mesh, rank_group

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FIXTURES = ["small_cluster", "rack_violated_cluster", "dead_broker_cluster", "jbod_cluster"]
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


def jax_chains(js, R: int, M: int):
    """The JAX mesh's run as its `_run` makes it, with every chain's carry:
    (compiled objectives, op-by-op objectives, winner, winner's state)."""
    je = JMeshEngine(js, J_CHAIN, mesh=j_grid_mesh(R, M, jax.devices()[:R * M]),
                     config=JConfig(**FAST))
    keys = jax.random.split(jax.random.PRNGKey(FAST["seed"]), R)
    carry = je._jit_init(je.statics, keys)
    carry, _ys, objs = je._fn("_jit_run")(je.statics, carry)
    objs = np.asarray(jax.device_get(objs))
    carry = jax.device_get(carry)
    eng = je.engine
    eager = []
    with jax.disable_jit():
        for r in range(R):
            c = jax.tree.map(lambda x, r=r: jax.numpy.asarray(x[r]), carry)
            eager.append(np.float32(eng.carry_objective(eng.statics, c)))
    winner = int(np.argmin(objs))
    final = je.final_state(jax.tree.map(lambda x: x[winner], carry))
    return objs, np.asarray(eager, np.float32), winner, final


@pytest.mark.parametrize("name", FIXTURES)
def test_grid_chains_winner_and_rows_match_jax(name):
    R, M = 2, 2
    js = getattr(jf, name)()
    j_objs, j_eager, j_winner, j_final = jax_chains(js, R, M)
    ge = GridEngine(_port(js), T_CHAIN, mesh=grid_mesh(R, M, DEVS), config=TConfig(**FAST))
    t_final, t_hist = ge.run()
    info = ge.last_info
    np.testing.assert_array_equal(info["objectives"].view(np.int32), j_eager.view(np.int32),
                                  err_msg=f"{name} 2x2: chain objectives")
    np.testing.assert_allclose(info["objectives"], j_objs, rtol=1e-6)
    assert info["winner"] == j_winner
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                      err_msg=f"{name} 2x2: the winner's {f}")
    digests = ge.carry_digests()
    assert digests[0] == digests[1] and digests[2] == digests[3]
    ran = len([h for h in t_hist if "round" in h])
    assert ge.last_info["gather_calls"][info["winner"] * M] == ran * FAST["steps_per_round"]
    assert t_hist[-1]["collectives"] == ran * FAST["steps_per_round"]
    ge.release()
