"""The device scheduler (fleet/scheduler.py) and the fleet's leases
(fleet/leases.py).  The fleet manager comes with the service."""

from cruise_control_tpu_torch.fleet.leases import (
    FencedError,
    FileLeaseStore,
    Lease,
    LeaseManager,
    LeaseStore,
)

__all__ = [
    "FencedError",
    "FileLeaseStore",
    "Lease",
    "LeaseManager",
    "LeaseStore",
]
