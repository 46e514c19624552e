"""Streaming controller pieces ported so far: the learned move-acceptance
prior (controller/prior.py), which the engine's relocation destination
draws read (`OptimizerConfig.prior_enabled`, `Engine.rebind_prior`)."""

from cruise_control_tpu_torch.controller.prior import MoveAcceptancePrior, PriorTable

__all__ = ["MoveAcceptancePrior", "PriorTable"]
