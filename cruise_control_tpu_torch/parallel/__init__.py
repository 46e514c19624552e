"""Multi-device parallelism.

Only the mesh fault-tolerance controller is here so far: the config's
`tpu.mesh.ft.*` keys build it (config/app_config.py
`mesh_ft_controller`).  The mesh engine layer that would use it (the JAX
package's parallel/{mesh,grid,portfolio,sharded,model_shard}.py) is not
ported yet, so the service refuses every `tpu.parallel.mode` but
"single" (service/facade.py `refuse_unported_modes`).
"""

from cruise_control_tpu_torch.parallel.ft import CheckpointSlot, MeshFtController

__all__ = ["CheckpointSlot", "MeshFtController"]
