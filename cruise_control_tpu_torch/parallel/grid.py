"""2D-layout optimization: restart portfolio OVER candidate-sharded chains.

``GridEngine`` is the (restart=R, model=M) view of the shared mesh engine
layer (parallel/mesh.py): R independent annealing chains race to the best
objective, each with its candidate axis sharded M ways.  The collectives
run on each chain's model row only, so chains never interact until the
caller's winner selection.

Deliberately thin: the process groups live in parallel/mesh.py and
parallel/ranks.py, shared with sharded.py and portfolio.py.
"""

from __future__ import annotations

from cruise_control_tpu_torch.analyzer.engine import OptimizerConfig
from cruise_control_tpu_torch.analyzer.objective import GoalChain
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS, OptimizationOptions
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.parallel.mesh import MODEL_AXIS, RESTART_AXIS, MeshEngine, grid_mesh
from cruise_control_tpu_torch.parallel.ranks import Layout

__all__ = ["GridEngine", "grid_mesh", "MODEL_AXIS", "RESTART_AXIS"]


class GridEngine(MeshEngine):
    """MeshEngine constructed from an explicit 2D (restart, model) layout.

    Kept as a named class for the ``tpu.parallel.mode=grid:RxM`` wiring and
    its tests: a grid mode must be handed a genuine 2D layout, not silently
    reshaped from whatever devices were lying around."""

    def __init__(
        self,
        state: ClusterState,
        chain: GoalChain,
        mesh: Layout,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        options: OptimizationOptions = DEFAULT_OPTIONS,
        config: OptimizerConfig = OptimizerConfig(),
        bucket=None,
        model_shard_min_partitions: int = 0,
        *,
        timeout_s: float | None = None,
    ):
        if tuple(mesh.axis_names) != (RESTART_AXIS, MODEL_AXIS):
            raise ValueError(f"grid mesh must have axes ({RESTART_AXIS!r}, {MODEL_AXIS!r})")
        super().__init__(state, chain, mesh=mesh, constraint=constraint, options=options,
                         config=config, bucket=bucket,
                         model_shard_min_partitions=model_shard_min_partitions,
                         timeout_s=timeout_s)
