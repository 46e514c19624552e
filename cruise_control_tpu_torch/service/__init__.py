"""Service layer: facade, REST API, user tasks, progress, purgatory.

Reference: KafkaCruiseControl.java + servlet/ + async/.
"""

from cruise_control_tpu_torch.service.facade import CruiseControl, SelfHealingAdapter
from cruise_control_tpu_torch.service.progress import OperationProgress
from cruise_control_tpu_torch.service.purgatory import Purgatory, ReviewStatus
from cruise_control_tpu_torch.service.server import (
    GET_ENDPOINTS,
    POST_ENDPOINTS,
    CruiseControlApp,
)
from cruise_control_tpu_torch.service.tasks import USER_TASK_ID_HEADER, UserTask, UserTaskManager
