"""Model completeness requirements.

Reference: monitor/ModelCompletenessRequirements.java and
MonitorUtils.combineLoadRequirementOptions (the stricter of two
requirements wins when goals are combined).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelCompletenessRequirements:
    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.98
    include_all_topics: bool = False

    def stronger(self, other: "ModelCompletenessRequirements | None") -> "ModelCompletenessRequirements":
        """Combine two requirements, keeping the stricter of each field
        (reference MonitorUtils.combineLoadRequirementOptions)."""
        if other is None:
            return self
        return ModelCompletenessRequirements(
            min_required_num_windows=max(
                self.min_required_num_windows, other.min_required_num_windows
            ),
            min_monitored_partitions_percentage=max(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage,
            ),
            include_all_topics=self.include_all_topics or other.include_all_topics,
        )

    def weaker(self, other: "ModelCompletenessRequirements | None") -> "ModelCompletenessRequirements":
        if other is None:
            return self
        return ModelCompletenessRequirements(
            min_required_num_windows=min(
                self.min_required_num_windows, other.min_required_num_windows
            ),
            min_monitored_partitions_percentage=min(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage,
            ),
            include_all_topics=self.include_all_topics and other.include_all_topics,
        )


DEFAULT_REQUIREMENTS = ModelCompletenessRequirements()
