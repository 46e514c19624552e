"""Multi-device parallel optimization: SA restart portfolio.

The reference parallelizes only across *cached proposal computations*
(reference analyzer/GoalOptimizer.java:100-107 precompute thread pool); a
single optimization is strictly sequential.  On the cards the restart axis
is free parallelism: independent annealing chains with different keys
race to the best objective.

``portfolio_run`` is the explicit-schedule entry point (the caller hands a
[rounds, steps] temperature schedule); it runs the shared mesh engine
layer (parallel/mesh.py) over a (restart=n, model=1) layout, one chain a
rank, and picks the winner from the chains' objectives.
"""

from __future__ import annotations

from cruise_control_tpu_torch.analyzer.engine import Engine
from cruise_control_tpu_torch.common.device_watchdog import device_op
from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.parallel.mesh import RESTART_AXIS, MeshEngine, default_mesh
from cruise_control_tpu_torch.parallel.ranks import Layout

__all__ = ["RESTART_AXIS", "default_mesh", "portfolio_run"]


@device_op("portfolio.run")
def portfolio_run(engine: Engine, mesh: Layout, temps, *, seed: int = 0,
                  timeout_s: float | None = None) -> tuple[ClusterState, dict]:
    """Run one annealing chain per layout row; return the best final state.

    temps: f32[S] (one round) or f32[rounds, S] (multi-round): between
    rounds each chain refreshes its aggregates and rebuilds its sampling
    plan, as the fused engine does.  Chain r's key is
    split(PRNGKey(seed), R)[r].  Built from the caller's EXISTING engine
    (`MeshEngine.from_engine`), which is never mutated; the mesh engine's
    ranks are released after the run."""
    me = MeshEngine.from_engine(engine, mesh, timeout_s=timeout_s)
    try:
        return me.run_schedule(temps, seed=seed)
    finally:
        me.release()
