"""CPU utilization estimation.

Reference: model/ModelUtils.java:53-84 (follower CPU derived from leader
byte rates via static coefficients; leader CPU per core estimation) and
model/LinearRegressionModelParameters.java (optional trained linear
regression from broker samples).

The regression here is a tiny closed-form least-squares on host (numpy) —
training data volumes are trivial; no reason to involve the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# reference ModelUtils static coefficients (ModelUtils.java:30-36):
# CPU contribution weights of leader bytes-in / bytes-out / follower bytes-in
LEADER_BYTES_IN_CPU_WEIGHT = 0.7
LEADER_BYTES_OUT_CPU_WEIGHT = 0.15
FOLLOWER_BYTES_IN_CPU_WEIGHT = 0.15


#: (leader bytes-in, leader bytes-out, follower bytes-in) weight triple —
#: reference MonitorConfig {leader.network.inbound, leader.network.outbound,
#: follower.network.inbound}.weight.for.cpu.util
DEFAULT_CPU_WEIGHTS = (
    LEADER_BYTES_IN_CPU_WEIGHT,
    LEADER_BYTES_OUT_CPU_WEIGHT,
    FOLLOWER_BYTES_IN_CPU_WEIGHT,
)


def follower_cpu_util(
    leader_bytes_in: float,
    leader_bytes_out: float,
    leader_cpu: float,
    weights: tuple[float, float, float] = DEFAULT_CPU_WEIGHTS,
) -> float:
    """CPU a follower of this partition would use, from leader-side rates
    (reference ModelUtils.getFollowerCpuUtilFromLeaderLoad:53-67)."""
    w_in, w_out, w_follow = weights
    total = w_in * leader_bytes_in + w_out * leader_bytes_out
    if total <= 0:
        return 0.0
    return leader_cpu * (w_follow * leader_bytes_in) / total


def follower_cpu_util_array(
    leader_loads: np.ndarray,
    leader_cpu: np.ndarray,
    weights: tuple[float, float, float] = DEFAULT_CPU_WEIGHTS,
) -> np.ndarray:
    """Vectorized follower CPU for [N, 4] leader loads."""
    from cruise_control_tpu_torch.common.resources import Resource

    w_in, w_out, w_follow = weights
    bin_ = leader_loads[:, Resource.NW_IN]
    bout = leader_loads[:, Resource.NW_OUT]
    total = w_in * bin_ + w_out * bout
    out = np.where(
        total > 0, leader_cpu * w_follow * bin_ / np.maximum(total, 1e-12), 0.0
    )
    return out.astype(np.float32)


@dataclasses.dataclass
class LinearRegressionModelParameters:
    """Broker CPU =~ w . [leader_bytes_in, leader_bytes_out, follower_bytes_in]
    (reference model/LinearRegressionModelParameters.java).

    Accumulates training samples; `train` solves least squares; once
    trained, `estimate` replaces the static-coefficient path.

    Bucketed readiness (reference MonitorConfig
    linear.regression.model.{cpu.util.bucket.size,
    required.samples.per.bucket, min.num.cpu.util.buckets}): samples are
    binned by CPU utilization percent, and training requires enough
    DISTINCT load levels — a model fit only on idle-broker samples would
    extrapolate garbage at peak.
    """

    min_samples_to_train: int = 100
    #: CPU-util bucket width in percent points
    cpu_util_bucket_size: int = 5
    #: samples a bucket needs before it counts as covered
    required_samples_per_bucket: int = 100
    #: covered buckets required before training may run
    min_num_cpu_util_buckets: int = 5

    def __post_init__(self):
        self._x: list[np.ndarray] = []
        self._y: list[float] = []
        self.coefficients: np.ndarray | None = None

    def add_sample(self, leader_bytes_in: float, leader_bytes_out: float,
                   follower_bytes_in: float, cpu_util: float):
        self._x.append(np.array([leader_bytes_in, leader_bytes_out, follower_bytes_in]))
        self._y.append(cpu_util)

    @property
    def num_samples(self) -> int:
        return len(self._y)

    @property
    def trained(self) -> bool:
        return self.coefficients is not None

    def bucket_coverage(self) -> dict[int, int]:
        """{bucket index: sample count}, bucketing CPU util (0..1) by
        cpu_util_bucket_size percent points."""
        counts: dict[int, int] = {}
        width = max(1, self.cpu_util_bucket_size)
        for y in self._y:
            b = int(min(max(y, 0.0), 1.0) * 100) // width
            counts[b] = counts.get(b, 0) + 1
        return counts

    def ready_to_train(self) -> bool:
        if len(self._y) < self.min_samples_to_train:
            return False
        covered = sum(
            1 for n in self.bucket_coverage().values()
            if n >= self.required_samples_per_bucket
        )
        return covered >= self.min_num_cpu_util_buckets

    def train(self, *, force: bool = False) -> bool:
        """force (the explicit /train path) skips the bucket-COVERAGE gate —
        an operator may fit on whatever load levels exist — but never the
        minimum-sample floor: a fit on a handful of points is noise."""
        if len(self._y) < self.min_samples_to_train:
            return False
        if not force and not self.ready_to_train():
            return False
        x = np.stack(self._x)
        y = np.asarray(self._y)
        coef, *_ = np.linalg.lstsq(x, y, rcond=None)
        self.coefficients = np.maximum(coef, 0.0)
        return True

    def estimate(self, leader_bytes_in: float, leader_bytes_out: float,
                 follower_bytes_in: float) -> float:
        if self.coefficients is None:
            raise ValueError("model not trained")
        return float(
            self.coefficients @ np.array([leader_bytes_in, leader_bytes_out, follower_bytes_in])
        )

    def follower_cpu_array(self, leader_loads: np.ndarray) -> np.ndarray:
        """Trained follower-CPU estimate for [N, 4] leader loads: a follower
        ingests the partition's bytes-in as replication traffic, so its CPU
        is the regression's follower-bytes-in coefficient applied to NW_IN
        (reference ModelUtils.java:84 switches to the trained estimator once
        LinearRegressionModelParameters has converged)."""
        from cruise_control_tpu_torch.common.resources import Resource

        if self.coefficients is None:
            raise ValueError("model not trained")
        return (self.coefficients[2] * leader_loads[:, Resource.NW_IN]).astype(np.float32)

    def state(self) -> dict:
        return {
            "trained": self.trained,
            "numSamples": self.num_samples,
            "coefficients": None if self.coefficients is None else self.coefficients.tolist(),
        }
