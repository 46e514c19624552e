"""Config layer: typed ConfigDef + domain-grouped application config.

Reference: cruise-control-core common/config/ + config/KafkaCruiseControlConfig.java.
"""

from cruise_control_tpu_torch.config.app_config import (
    CruiseControlConfig,
    cruise_control_config_def,
    load_properties,
)
from cruise_control_tpu_torch.config.balancing import BalancingConstraint, DEFAULT_CONSTRAINT
from cruise_control_tpu_torch.config.config_def import (
    AbstractConfig,
    ConfigDef,
    ConfigException,
    ConfigType,
    Importance,
)

__all__ = [
    "AbstractConfig",
    "BalancingConstraint",
    "ConfigDef",
    "ConfigException",
    "ConfigType",
    "CruiseControlConfig",
    "DEFAULT_CONSTRAINT",
    "Importance",
    "cruise_control_config_def",
    "load_properties",
]
