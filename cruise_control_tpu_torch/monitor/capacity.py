"""Broker capacity resolution.

Reference: config/BrokerCapacityConfigResolver.java (SPI),
BrokerCapacityConfigFileResolver.java (reads config/capacity*.json with
JBOD per-logdir DISK maps and a brokerId=-1 default), BrokerCapacityInfo.java.
The JSON schema is kept compatible with the reference's capacity files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Protocol

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource

DEFAULT_BROKER_ID = -1


@dataclasses.dataclass(frozen=True)
class BrokerCapacityInfo:
    """Reference config/BrokerCapacityInfo.java."""

    capacity: np.ndarray  # f32[4] indexed by Resource (DISK = sum of logdirs)
    disk_capacities: dict[str, float] | None = None  # logdir -> MB (JBOD)
    num_cores: int = 1
    estimation_info: str = ""

    @property
    def is_jbod(self) -> bool:
        return bool(self.disk_capacities) and len(self.disk_capacities) > 1


class BrokerCapacityConfigResolver(Protocol):
    """SPI (reference config/BrokerCapacityConfigResolver.java)."""

    def capacity_for_broker(self, rack: str, host: str, broker_id: int) -> BrokerCapacityInfo:
        ...


class FixedCapacityResolver:
    """Same capacity for every broker — test/synthetic default."""

    def __init__(self, capacity, disk_capacities: dict[str, float] | None = None, num_cores: int = 1):
        self._info = BrokerCapacityInfo(
            np.asarray(capacity, np.float32), disk_capacities, num_cores
        )

    def capacity_for_broker(self, rack: str, host: str, broker_id: int) -> BrokerCapacityInfo:
        return self._info


class FileCapacityResolver:
    """Reads the reference's capacity JSON schema
    (reference config/BrokerCapacityConfigFileResolver.java, schema
    config/capacity.json + capacityJBOD.json: DISK either a scalar or a
    {logdir: MB} map; brokerId "-1" provides the default)."""

    def __init__(self, path: str):
        with open(path) as f:
            doc = json.load(f)
        self._by_id: dict[int, BrokerCapacityInfo] = {}
        for entry in doc["brokerCapacities"]:
            bid = int(entry["brokerId"])
            cap = entry["capacity"]
            disk = cap["DISK"]
            disks = None
            if isinstance(disk, dict):
                disks = {k: float(v) for k, v in disk.items()}
                disk_total = sum(disks.values())
            else:
                disk_total = float(disk)
            cpu = cap["CPU"]
            if isinstance(cpu, dict):
                # cores schema (reference config/capacityCores.json):
                # CPU = {"num.cores": N}; utilization stays percent-based
                # with the core count carried alongside
                cores = int(cpu["num.cores"])
                cpu_cap = 100.0
            else:
                cores = int(entry.get("numCores", 1))
                cpu_cap = float(cpu)
            arr = np.zeros(NUM_RESOURCES, np.float32)
            arr[Resource.CPU] = cpu_cap
            arr[Resource.NW_IN] = float(cap["NW_IN"])
            arr[Resource.NW_OUT] = float(cap["NW_OUT"])
            arr[Resource.DISK] = disk_total
            self._by_id[bid] = BrokerCapacityInfo(arr, disks, cores)
        if DEFAULT_BROKER_ID not in self._by_id:
            raise ValueError("capacity file must define the default broker (-1)")

    def capacity_for_broker(self, rack: str, host: str, broker_id: int) -> BrokerCapacityInfo:
        return self._by_id.get(broker_id, self._by_id[DEFAULT_BROKER_ID])
