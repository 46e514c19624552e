"""The port's restart portfolios against the JAX package's MeshEngine, on the
CPU: layout 4x1 (one chain a rank, no collective) on the four small
fixtures, as test_torch_mesh_portfolio.py holds 2x1.

Each chain r runs from split(PRNGKey(seed), R)[r], as the JAX package's
mesh.py:608-612 splits it.  The JAX side runs its own two programs (init,
then the fused anneal) and evaluates each chain's final carry objective op
by op (`jax.disable_jit`); the port's per-chain objectives are those bit for
bit, and the JAX compiled program's within rtol 1e-6 (XLA contracts the
objective's multiply-adds in its compiled programs; ROADMAP queue 3's CPU
bars).  The winner is the JAX package's, and its placement is byte for
byte the JAX run's; each rank's final carry is its own row's (one rank a
row here).
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
from cruise_control_tpu_torch.parallel import MeshEngine, close_rank_groups, cpu_devices, grid_mesh, rank_group

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


def check_layout(name: str, R: int, M: int) -> None:
    js = getattr(jf, name)()
    j_objs, j_eager, j_winner, j_final = jax_chains(js, R, M)
    me = MeshEngine(_port(js), T_CHAIN, mesh=grid_mesh(R, M, DEVS), config=TConfig(**FAST))
    t_final, t_hist = me.run()
    info = me.last_info
    t_objs = info["objectives"]
    assert t_objs.dtype == np.float32 and t_objs.shape == (R,)
    np.testing.assert_array_equal(t_objs.view(np.int32), j_eager.view(np.int32),
                                  err_msg=f"{name} {R}x{M}: chain objectives")
    np.testing.assert_allclose(t_objs, j_objs, rtol=1e-6)
    assert info["winner"] == j_winner == int(np.argmin(j_eager))
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                      err_msg=f"{name} {R}x{M}: the winner's {f}")
    digests = me.carry_digests()
    assert all(len(set(digests[r * M:(r + 1) * M])) == 1 for r in range(R))
    assert t_hist[-1]["mesh_shape"] == [R, M]
    me.release()


@pytest.mark.parametrize("name", FIXTURES)
def test_portfolio_chains_and_winner_match_jax(name):
    check_layout(name, 4, 1)
