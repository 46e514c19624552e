"""Candidate-sharded optimization: one chain, K candidates split over ranks.

``ShardedEngine`` is the 1-chain view of the shared mesh engine layer
(parallel/mesh.py): a (restart=1, model=n) layout.  Each step the full-K
candidate stream is drawn from the replicated key, each rank scores and
accepts its K/n slice, and one all_gather of the packed candidate columns
reassembles the full-K bundle for the conflict resolution that runs
identically on every rank.  The model and carry are replicated, so a
1-rank and an n-rank run of the same seeded anneal give byte-identical
placements (mesh.py module docstring).

Deliberately thin: every process group and collective lives in
parallel/mesh.py and parallel/ranks.py, shared with grid.py and
portfolio.py.

Reference analog: none -- the reference optimizer is a single-threaded
Java loop (analyzer/goals/AbstractGoal.java:66-107).
"""

from __future__ import annotations

from cruise_control_tpu_torch.parallel.mesh import MODEL_AXIS, MeshEngine, model_mesh

__all__ = ["MODEL_AXIS", "ShardedEngine", "model_mesh"]


class ShardedEngine(MeshEngine):
    """One annealing chain whose candidate axis is sharded over the layout.

    The constructor (state, chain, mesh, constraint, options, config,
    bucket) is MeshEngine's; a 1D (model,) layout (`model_mesh()`) is
    normalized to (restart=1, model=n).  At n=1 a rank's run IS the plain
    engine's (no slice, no collective)."""
