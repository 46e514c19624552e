"""Multi-device parallelism: ONE rank-group engine layer (mesh.py).

Every multi-device mode is a view of the same run over an explicit 2D
(restart, model) layout of devices, one rank process a device
(ranks.py, the port's counterpart of `jax.sharding.Mesh`):

  * sharded.py   -- (1, n): one chain, candidate axis sharded n ways;
  * portfolio.py -- (n, 1): independent SA chains racing to the best
    objective;
  * grid.py      -- (R, M): a portfolio OF candidate-sharded chains.

model_shard.py is the sharded-MODEL mode's rank engine (the model's
replica and partition rows split over the model axis).  ft.py holds the
mesh fault-tolerance controller that the config's `tpu.mesh.ft.*` keys
build, which the optimizer's width ladder drives
(analyzer/optimizer.py `_optimize_mesh_ft`).
"""

from cruise_control_tpu_torch.parallel.ft import CheckpointSlot, MeshFtController
from cruise_control_tpu_torch.parallel.grid import GridEngine
from cruise_control_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    RESTART_AXIS,
    MeshEngine,
    default_mesh,
    grid_mesh,
    model_mesh,
    normalize_mesh,
)
from cruise_control_tpu_torch.parallel.model_shard import ModelShardEngine, ShardPlan
from cruise_control_tpu_torch.parallel.portfolio import portfolio_run
from cruise_control_tpu_torch.parallel.ranks import (
    Layout,
    RankDiedError,
    RankGroupError,
    RankTimeoutError,
    close_rank_groups,
    cpu_devices,
    rank_group,
)
from cruise_control_tpu_torch.parallel.sharded import ShardedEngine

__all__ = [
    "CheckpointSlot",
    "GridEngine",
    "Layout",
    "MODEL_AXIS",
    "MeshEngine",
    "MeshFtController",
    "ModelShardEngine",
    "RESTART_AXIS",
    "RankDiedError",
    "RankGroupError",
    "RankTimeoutError",
    "ShardPlan",
    "ShardedEngine",
    "close_rank_groups",
    "cpu_devices",
    "default_mesh",
    "grid_mesh",
    "model_mesh",
    "normalize_mesh",
    "portfolio_run",
    "rank_group",
]
