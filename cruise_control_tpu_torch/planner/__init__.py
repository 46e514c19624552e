"""Scenario planner — batched what-if simulation, forecasting, rightsizing.

It answers "what happens if" (lose a rack, add brokers, traffic doubles)
by editing the flattened cluster model (models/whatif.py), batch-scoring
the hypotheticals on the same goal chain proposals use
(analyzer/scenario_eval.py: one graph launch on the card for a whole
batch), extrapolating load from windowed history (planner/forecast.py),
and searching broker counts for the minimum footprint that satisfies
every hard goal (planner/rightsizer.py).  The JAX package's planner, with
its public names.
"""

from cruise_control_tpu_torch.planner.forecast import LoadForecaster, TopicTrend
from cruise_control_tpu_torch.planner.rightsizer import ProvisionStatus, Rightsizer
from cruise_control_tpu_torch.planner.scenario import (
    BrokerAdd,
    Scenario,
    apply_scenario,
    plan_shape,
)

__all__ = [
    "BrokerAdd",
    "LoadForecaster",
    "ProvisionStatus",
    "Rightsizer",
    "Scenario",
    "TopicTrend",
    "apply_scenario",
    "plan_shape",
]
