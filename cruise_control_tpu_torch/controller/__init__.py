"""Streaming controller — always-on incremental rebalancing.

An always-on control loop (controller/streaming.py) that keeps the
flattened ClusterState on the device, scatters each metric window's delta
into it in place (models/whatif.py LiveState), re-anneals incrementally on
every window roll (warm start + the learned move-acceptance prior of
controller/prior.py, which the engine's relocation destination draws
read: `OptimizerConfig.prior_enabled`, `Engine.rebind_prior`), and
publishes each result into the facade's proposal cache so the service
always holds a continuously fresh proposal.
"""

from cruise_control_tpu_torch.controller.prior import MoveAcceptancePrior, PriorTable
from cruise_control_tpu_torch.controller.streaming import StreamingController

__all__ = ["MoveAcceptancePrior", "PriorTable", "StreamingController"]
