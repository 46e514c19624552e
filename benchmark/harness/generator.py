"""The benchmark's cluster generator: host columns from a spec and a seed.

A copy of the port's `random_cluster_fast` (cruise_control_tpu_torch/
testing/fixtures.py), kept here so that the yardstick does not move with
the program, rewritten to emit plain numpy columns: the same columns go to
the program's model builder and to the reference.  The semantics are
upstream Cruise Control's `RandomCluster` generator
(cruise-control/src/test/java/.../model/RandomCluster.java): brokers on
racks round robin, replication factors drawn per partition, replicas
placed on distinct brokers with an exponential skew toward low broker
ids, one lognormal load per partition shared by its replicas, a follower
carrying no NW_OUT and 0.3 of the leader's CPU, and a JBOD broker's disk
capacity split evenly over its logdirs (config/capacityJBOD.json).

The load of a partition is one draw of its own stream (`draw_loads`), so
a request's new load generation redraws every partition's leader load
around the spec's means without touching the placement.
"""

from __future__ import annotations

import numpy as np

CPU, NW_IN, NW_OUT, DISK = 0, 1, 2, 3
#: follower load: NW_OUT -> 0, CPU -> this share of the leader's
FOLLOWER_CPU_SHARE = 0.3

#: the replica and broker columns of a cluster, by the program's field names
REPLICA_COLUMNS = (
    "replica_broker", "replica_partition", "replica_topic", "replica_pos", "replica_is_leader",
    "replica_valid", "replica_orig_broker", "replica_offline", "replica_disk",
    "replica_load_leader", "replica_load_follower",
)
BROKER_COLUMNS = (
    "broker_capacity", "broker_rack", "broker_host", "broker_alive", "broker_new",
    "broker_valid", "disk_capacity", "disk_alive",
)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def means(spec: dict) -> np.ndarray:
    return np.array([spec["mean_cpu"], spec["mean_nw_in"], spec["mean_nw_out"],
                     spec["mean_disk"]], np.float64)


def generate(spec: dict, seed: int) -> tuple[dict, dict]:
    """(columns, dims) of the spec's cluster for `seed`: the placement and
    the seed's own loads."""
    g = rng(seed, 0)
    B, P, T = spec["num_brokers"], spec["num_partitions"], spec["num_topics"]
    racks = spec["num_racks"]
    D = max(1, spec.get("disks_per_broker", 1))

    cap = np.tile(np.asarray(spec["broker_capacity"], np.float32), (B, 1))
    rf = np.minimum(g.integers(spec["min_replication"], spec["max_replication"] + 1, size=P), B)
    R = int(rf.sum())
    r_part = np.repeat(np.arange(P, dtype=np.int32), rf)
    r_pos = (np.arange(R) - np.repeat(np.cumsum(rf) - rf, rf)).astype(np.int32)

    # weighted iid placement, then the rows that drew a broker their
    # partition already holds draw again
    w = np.exp(-spec["skew"] * np.arange(B) / max(1, B - 1))
    cdf = np.cumsum(w / w.sum())
    r_broker = np.minimum(np.searchsorted(cdf, g.random(R)), B - 1).astype(np.int32)
    for _ in range(64):
        key = r_part.astype(np.int64) * B + r_broker
        order = np.argsort(key, kind="stable")
        dup_sorted = np.zeros(R, bool)
        dup_sorted[1:] = key[order][1:] == key[order][:-1]
        dup = np.zeros(R, bool)
        dup[order] = dup_sorted
        if not dup.any():
            break
        r_broker[dup] = np.minimum(np.searchsorted(cdf, g.random(int(dup.sum()))),
                                   B - 1).astype(np.int32)
    else:
        raise RuntimeError("could not place every partition on distinct brokers")

    cols = dict(
        replica_broker=r_broker,
        replica_partition=r_part,
        replica_topic=(r_part % T).astype(np.int32),
        replica_pos=r_pos,
        replica_is_leader=r_pos == 0,
        replica_valid=np.ones(R, bool),
        replica_orig_broker=r_broker.copy(),
        replica_offline=np.zeros(R, bool),
        replica_disk=(g.integers(0, D, R).astype(np.int32) if D > 1 else np.zeros(R, np.int32)),
        broker_capacity=cap,
        broker_rack=(np.arange(B) % racks).astype(np.int32),
        broker_host=np.arange(B, dtype=np.int32),
        broker_alive=np.ones(B, bool),
        broker_new=np.zeros(B, bool),
        broker_valid=np.ones(B, bool),
        disk_capacity=np.tile(cap[:, DISK:DISK + 1] / D, (1, D)).astype(np.float32),
        disk_alive=np.ones((B, D), bool),
    )
    cols["replica_load_leader"], cols["replica_load_follower"] = draw_loads(spec, seed, 0, r_part)
    dims = dict(num_replicas=R, num_brokers=B, num_partitions=P, num_topics=T,
                num_racks=racks, num_hosts=B, max_disks_per_broker=D)
    return cols, dims


def draw_loads(spec: dict, seed: int, generation: int, r_part: np.ndarray):
    """(leader, follower) f32[R, 4] loads of one load generation: each
    partition's leader load lognormal around the spec's means, shared by
    its replicas."""
    P = spec["num_partitions"]
    g = rng(seed, 1, generation)
    p_load = (means(spec) * np.exp(g.normal(0.0, spec.get("deviation", 0.5), (P, 4))))
    leader = p_load.astype(np.float32)[r_part]
    follower = leader.copy()
    follower[:, NW_OUT] = 0.0
    follower[:, CPU] *= np.float32(FOLLOWER_CPU_SHARE)
    return leader, follower


def kill(cols: dict, brokers: np.ndarray) -> dict:
    """The columns with `brokers` dead: their replicas offline, their
    logdirs dead (the self-healing input of a broker failure)."""
    out = dict(cols)
    alive = cols["broker_alive"].copy()
    alive[brokers] = False
    out["broker_alive"] = alive
    disk_alive = cols["disk_alive"].copy()
    disk_alive[brokers] = False
    out["disk_alive"] = disk_alive
    out["replica_offline"] = cols["replica_valid"] & ~alive[cols["replica_broker"]]
    return out
