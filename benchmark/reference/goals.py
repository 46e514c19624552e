"""The plain reference of the goal chain: aggregates, violations, scores
and the scalarised objective of one placement, in plain PyTorch on the
host, in float64 (the reference) or in a lower precision (the control).

A frozen copy of the arithmetic of the port's goals
(cruise_control_tpu_torch/analyzer/goals/*.py, models/aggregates.py and
analyzer/objective.py), written from upstream Cruise Control's goal
semantics without any kernel, cache or device: every aggregate is one
`index_add_` over the replica rows, every goal one masked reduction.  It
imports nothing of the program.

One departure from plain float64: the integer band edges of the count
goals (ceil and floor of the average count times the threshold) are
computed in float32, as the program states them.  The edge is a whole
replica; a float64 product landing a hair under an integer where the
float32 one lands on it would move the edge by one replica and report a
different violation for the same placement.
"""

from __future__ import annotations

import numpy as np
import torch

CPU, NW_IN, NW_OUT, DISK = 0, 1, 2, 3
#: weight multiplier of a hard goal, decay between adjacent priorities and
#: the tiebreaker's weight relative to the smallest goal weight
HARD_BOOST = 1e4
PRIORITY_DECAY = 0.5
TIE_WEIGHT = 1e-3

CAPACITY_GOALS = {"CpuCapacityGoal": CPU, "NetworkInboundCapacityGoal": NW_IN,
                  "NetworkOutboundCapacityGoal": NW_OUT, "DiskCapacityGoal": DISK}
DISTRIBUTION_GOALS = {"CpuUsageDistributionGoal": CPU,
                      "NetworkInboundUsageDistributionGoal": NW_IN,
                      "NetworkOutboundUsageDistributionGoal": NW_OUT,
                      "DiskUsageDistributionGoal": DISK}
HARD_GOALS = frozenset({"OfflineReplicaGoal", "RackAwareGoal", "ReplicaCapacityGoal",
                        "IntraBrokerDiskCapacityGoal", *CAPACITY_GOALS})
#: resources checked per host where a host holds several brokers
HOST_RESOURCES = (CPU, NW_IN, NW_OUT)


def chain_weights(names) -> list[float]:
    """Each goal's violation weight: decay^rank, boosted for a hard goal."""
    return [PRIORITY_DECAY ** i * (HARD_BOOST if n in HARD_GOALS else 1.0)
            for i, n in enumerate(names)]


def _t(a, dtype):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def _seg(values, index, n):
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype)
    return out.index_add_(0, index, values)


class Cluster:
    """One placement of a cluster's columns as tensors of `dtype`, with its
    aggregates.  `dims` holds the topic, partition and rack counts;
    `placement` overrides the columns' replica_broker, replica_is_leader
    and replica_disk."""

    def __init__(self, cols: dict, dims: dict, dtype=torch.float64,
                 placement: dict | None = None):
        p = dict(cols, **(placement or {}))
        self.dtype = dtype
        i64 = torch.int64
        self.valid = torch.as_tensor(p["replica_valid"])
        self.rb = _t(p["replica_broker"], i64)
        self.lead = torch.as_tensor(p["replica_is_leader"]).bool()
        self.rd = _t(p["replica_disk"], i64)
        self.part = _t(p["replica_partition"], i64)
        self.topic = _t(p["replica_topic"], i64)
        self.pos = _t(p["replica_pos"], i64)
        self.ll = _t(p["replica_load_leader"], dtype)
        self.fl = _t(p["replica_load_follower"], dtype)
        self.cap = _t(p["broker_capacity"], dtype)
        self.rack = _t(p["broker_rack"], i64)
        self.host = _t(p["broker_host"], i64)
        self.alive_b = torch.as_tensor(p["broker_alive"]).bool()
        self.bvalid = torch.as_tensor(p["broker_valid"]).bool()
        self.disk_cap = _t(p["disk_capacity"], dtype)
        self.disk_alive = torch.as_tensor(p["disk_alive"]).bool()
        self.offline = torch.as_tensor(p["replica_offline"]).bool()
        self.B, self.D = self.cap.shape[0], self.disk_cap.shape[1]
        self.T, self.P = dims["num_topics"], dims["num_partitions"]
        self.racks = dims["num_racks"]
        self.H = int(self.host[self.bvalid].max()) + 1 if bool(self.bvalid.any()) else 0
        self.alive = self.bvalid & self.alive_b
        self._aggregates()

    def _aggregates(self):
        v, B, rb = self.valid, self.B, self.rb
        rows = torch.nonzero(v).flatten()
        b = rb[rows]
        lead = self.lead[rows]
        load = torch.where(lead[:, None], self.ll[rows], self.fl[rows])
        self.load = _seg(load, b, B)
        ones = torch.ones(rows.numel(), dtype=torch.int64)
        self.rcount = _seg(ones, b, B)
        self.lcount = _seg(lead.to(torch.int64), b, B)
        self.pot = _seg(self.ll[rows, NW_OUT], b, B)
        self.lbin = _seg(torch.where(lead, self.ll[rows, NW_IN], torch.zeros((), dtype=self.dtype)),
                         b, B)
        self.topic_count = _seg(ones, self.topic[rows] * B + b, self.T * B).reshape(self.T, B)
        self.part_rack = _seg(ones, self.part[rows] * self.racks + self.rack[b],
                              self.P * self.racks).reshape(self.P, self.racks)
        self.disk_load = _seg(load[:, DISK], b * self.D + self.rd[rows], B * self.D).reshape(B, self.D)
        self.n_valid = float(rows.numel())


def _relu(x):
    return torch.clamp(x, min=0.0)


def _zero(c):
    return torch.zeros((), dtype=c.dtype)


def _band(values, mask, upper, lower, scale):
    z = torch.zeros((), dtype=values.dtype)
    over = _relu(torch.where(mask, values - upper, z))
    under = _relu(torch.where(mask, lower - values, z))
    return (over + under).sum() / (scale + 1e-12)


def _cv(values, mask):
    n = max(int(mask.sum()), 1)
    z = torch.zeros((), dtype=values.dtype)
    mean = torch.where(mask, values, z).sum() / n
    dev = values - mean
    var = torch.where(mask, dev * dev, z).sum() / n
    return torch.sqrt(var) / (mean + 1e-12)


def _edge_dtype(dtype):
    return torch.float32 if dtype == torch.float64 else dtype


def _count_band(c: Cluster, counts, threshold):
    mask = c.alive
    counts = torch.where(mask, counts, torch.zeros((), dtype=counts.dtype)).to(c.dtype)
    n = max(int(mask.sum()), 1)
    e = _edge_dtype(c.dtype)
    avg = counts.sum().to(e) / torch.tensor(float(n), dtype=e)
    upper = torch.ceil(avg * threshold).to(c.dtype)
    lower = torch.floor(avg * max(0.0, 2.0 - threshold)).to(c.dtype)
    return _band(counts, mask, upper, lower, counts.sum())


def _capacity(c: Cluster, r: int, thresh: float):
    z = _zero(c)
    cap = torch.where(c.alive, c.cap[:, r], z)
    load = torch.where(c.alive, c.load[:, r], z)
    scale = cap.sum() + 1e-12
    broker_excess = _relu(load - thresh * cap)
    if r not in HOST_RESOURCES:
        return broker_excess.sum() / scale
    H = c.H
    hseg = torch.where(c.bvalid, c.host, torch.tensor(H))
    per_host = _seg(c.alive.to(torch.int64), hseg, H + 1)[:H]
    h_load = _seg(load, hseg, H + 1)[:H]
    h_cap = _seg(cap, hseg, H + 1)[:H]
    host_excess = _relu(h_load - thresh * h_cap)
    multi = per_host > 1
    host_term = torch.where(multi, host_excess, z).sum()
    broker_term = torch.where(~multi, _seg(broker_excess, hseg, H + 1)[:H], z).sum()
    return (host_term + broker_term) / scale


def violation(name: str, c: Cluster, k: dict):
    """Goal `name`'s violation of cluster `c` under constraint `k`."""
    z = _zero(c)
    if name == "OfflineReplicaGoal":
        dead = ~c.alive_b[c.rb] | ~c.disk_alive[c.rb, c.rd]
        return torch.tensor(float((c.valid & dead).sum()) / (c.n_valid + 1e-12), dtype=c.dtype)
    if name == "RackAwareGoal":
        excess = _relu((c.part_rack - 1).to(c.dtype))
        return excess.sum() / (c.n_valid + 1e-12)
    if name == "ReplicaCapacityGoal":
        count = torch.where(c.alive, c.rcount, torch.zeros((), dtype=torch.int64))
        return _relu((count - k["max_replicas_per_broker"]).to(c.dtype)).sum() / (c.n_valid + 1e-12)
    if name in CAPACITY_GOALS:
        r = CAPACITY_GOALS[name]
        return _capacity(c, r, k["capacity_threshold"][r])
    if name == "PotentialNwOutGoal":
        thresh = k["capacity_threshold"][NW_OUT]
        cap = torch.where(c.alive, c.cap[:, NW_OUT], z)
        pot = torch.where(c.alive, c.pot, z)
        return _relu(pot - thresh * cap).sum() / (cap.sum() + 1e-12)
    if name in DISTRIBUTION_GOALS:
        r = DISTRIBUTION_GOALS[name]
        t = k["balance_threshold"][r]
        cap = torch.where(c.alive, c.cap[:, r], z)
        load = torch.where(c.alive, c.load[:, r], z)
        avg_pct = load.sum() / (cap.sum() + 1e-12)
        return _band(load, c.alive, avg_pct * t * cap, avg_pct * max(0.0, 2.0 - t) * cap,
                     load.sum())
    if name == "ReplicaDistributionGoal":
        return _count_band(c, c.rcount, k["replica_count_balance_threshold"])
    if name == "LeaderReplicaDistributionGoal":
        return _count_band(c, c.lcount, k["leader_replica_count_balance_threshold"])
    if name == "TopicReplicaDistributionGoal":
        mask = c.alive[None, :]
        counts = torch.where(mask, c.topic_count, torch.zeros((), dtype=torch.int64)).to(c.dtype)
        n = max(int(c.alive.sum()), 1)
        t = k["topic_replica_count_balance_threshold"]
        e = _edge_dtype(c.dtype)
        avg = counts.sum(dim=1, keepdim=True).to(e) / torch.tensor(float(n), dtype=e)
        upper = torch.ceil(avg * t).to(c.dtype)
        lower = torch.floor(avg * max(0.0, 2.0 - t)).to(c.dtype)
        return _band(counts, mask, upper, lower, counts.sum())
    if name == "LeaderBytesInDistributionGoal":
        t = k["balance_threshold"][NW_IN]
        lbin = torch.where(c.alive, c.lbin, z)
        avg = lbin.sum() / max(int(c.alive.sum()), 1)
        return _band(lbin, c.alive, avg * t, z, lbin.sum())
    if name == "PreferredLeaderElectionGoal":
        eligible = c.alive_b[c.rb] & ~c.offline
        bad = c.valid & (c.pos == 0) & eligible & ~c.lead
        return torch.tensor(float(bad.sum()) / max(c.P, 1), dtype=c.dtype)
    if name in ("IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"):
        mask = c.disk_alive & c.alive[:, None]
        cap = torch.where(mask, c.disk_cap, z)
        load = torch.where(mask, c.disk_load, z)
        if name == "IntraBrokerDiskCapacityGoal":
            thresh = k["capacity_threshold"][DISK]
            dead = torch.where(~mask, c.disk_load, z)
            return (_relu(load - thresh * cap).sum() + dead.sum()) / (cap.sum() + 1e-12)
        t = k["balance_threshold"][DISK]
        avg_pct = load.sum(dim=1, keepdim=True) / (cap.sum(dim=1, keepdim=True) + 1e-12)
        return _band(load, mask, avg_pct * t * cap, avg_pct * max(0.0, 2.0 - t) * cap, load.sum())
    raise NotImplementedError(f"the reference has no arithmetic for goal {name!r}")


def score(name: str, c: Cluster):
    """Goal `name`'s continuous tiebreaker score (0 where it has none)."""
    if name in DISTRIBUTION_GOALS:
        r = DISTRIBUTION_GOALS[name]
        pct = c.load[:, r] / (c.cap[:, r] + 1e-12)
        return _cv(torch.where(c.alive, pct, _zero(c)), c.alive)
    if name == "ReplicaDistributionGoal":
        return _cv(torch.where(c.alive, c.rcount, 0).to(c.dtype), c.alive)
    if name == "LeaderReplicaDistributionGoal":
        return _cv(torch.where(c.alive, c.lcount, 0).to(c.dtype), c.alive)
    if name == "LeaderBytesInDistributionGoal":
        return _cv(torch.where(c.alive, c.lbin, _zero(c)), c.alive)
    return _zero(c)


def evaluate(c: Cluster, names, constraint: dict) -> tuple[float, np.ndarray]:
    """(objective, violations f64[G]) of cluster `c` under the chain `names`:
    the weighted violations plus the tiebreaker, summed in c's dtype."""
    viol = torch.stack([violation(n, c, constraint).to(c.dtype) for n in names])
    scores = torch.stack([score(n, c).to(c.dtype) for n in names])
    w = chain_weights(names)
    obj = (torch.tensor(w, dtype=torch.float64).to(c.dtype) * viol).sum() \
        + TIE_WEIGHT * min(w) * scores.sum()
    return float(obj), viol.to(torch.float64).numpy()
