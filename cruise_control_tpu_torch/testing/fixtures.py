"""Synthetic cluster fixtures for tests and benchmarks.

Semantics modeled on the reference's test generators:
  * deterministic fixtures — reference
    cruise-control/src/test/java/.../common/DeterministicCluster.java
  * randomized generator — reference
    cruise-control/src/test/java/.../model/RandomCluster.java:36-100
They draw from numpy's generator with the same calls in the same order as
the JAX package's fixtures, so one spec and seed give identical arrays in
both packages; the tensors land on the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.models.builder import (
    BrokerSpec,
    ClusterModelBuilder,
    PartitionSpec,
    state_from_numpy,
)
from cruise_control_tpu_torch.models.state import ClusterShape, ClusterState


def small_cluster(device=None) -> ClusterState:
    """3 brokers on 3 racks, 2 topics, deliberately unbalanced.

    Loose analog of DeterministicCluster.smallClusterModel (reference
    common/DeterministicCluster.java:52-149): broker 0 overloaded, broker 2
    nearly empty.
    """
    b = ClusterModelBuilder()
    cap = np.array([100.0, 1000.0, 1000.0, 10000.0], np.float32)
    b.add_broker(BrokerSpec(0, rack="r0", capacity=cap))
    b.add_broker(BrokerSpec(1, rack="r1", capacity=cap))
    b.add_broker(BrokerSpec(2, rack="r2", capacity=cap))
    loads = {
        ("T1", 0): [18.0, 90.0, 100.0, 750.0],
        ("T1", 1): [15.0, 80.0, 90.0, 650.0],
        ("T2", 0): [12.0, 70.0, 80.0, 550.0],
        ("T2", 1): [10.0, 60.0, 70.0, 450.0],
    }
    # all leaders and most replicas piled on broker 0
    b.add_partition(PartitionSpec("T1", 0, [0, 1], np.array(loads[("T1", 0)], np.float32)))
    b.add_partition(PartitionSpec("T1", 1, [0, 1], np.array(loads[("T1", 1)], np.float32)))
    b.add_partition(PartitionSpec("T2", 0, [0, 2], np.array(loads[("T2", 0)], np.float32)))
    b.add_partition(PartitionSpec("T2", 1, [0, 1], np.array(loads[("T2", 1)], np.float32)))
    return b.build(device)


def rack_violated_cluster(device=None) -> ClusterState:
    """Both replicas of each partition on the same rack — RackAwareGoal must fix.

    Analog of DeterministicCluster.rackAwareSatisfiable semantics
    (reference common/DeterministicCluster.java:178-206).
    """
    b = ClusterModelBuilder()
    cap = np.array([100.0, 1000.0, 1000.0, 10000.0], np.float32)
    b.add_broker(BrokerSpec(0, rack="r0", capacity=cap))
    b.add_broker(BrokerSpec(1, rack="r0", capacity=cap))
    b.add_broker(BrokerSpec(2, rack="r1", capacity=cap))
    b.add_broker(BrokerSpec(3, rack="r1", capacity=cap))
    load = np.array([5.0, 20.0, 25.0, 100.0], np.float32)
    b.add_partition(PartitionSpec("T1", 0, [0, 1], load))  # same rack r0
    b.add_partition(PartitionSpec("T1", 1, [2, 3], load))  # same rack r1
    b.add_partition(PartitionSpec("T1", 2, [0, 2], load))  # ok
    return b.build(device)


def dead_broker_cluster(device=None) -> ClusterState:
    """4 brokers, one dead — self-healing must evacuate it.

    Analog of DeterministicCluster dead-broker fixtures (reference
    common/DeterministicCluster.java:356)."""
    b = ClusterModelBuilder()
    cap = np.array([100.0, 1000.0, 1000.0, 10000.0], np.float32)
    for i in range(4):
        b.add_broker(BrokerSpec(i, rack=f"r{i % 2}", capacity=cap, alive=(i != 3)))
    load = np.array([4.0, 15.0, 20.0, 80.0], np.float32)
    for p in range(6):
        brokers = [(p + i) % 4 for i in range(2)]
        b.add_partition(PartitionSpec("T1", p, brokers, load))
    return b.build(device)


def jbod_cluster(device=None) -> ClusterState:
    """4 JBOD brokers (2 logdirs each, one failed) with skewed disk load —
    exercises the intra-broker disk axes (D > 1, bad_disks) that the
    single-disk fixtures never touch."""
    b = ClusterModelBuilder()
    cap = np.array([100.0, 1000.0, 1000.0, 3000.0], np.float32)
    b.add_broker(BrokerSpec(0, rack="r0", capacity=cap, disk_capacities=[1000.0, 2000.0]))
    b.add_broker(BrokerSpec(1, rack="r0", capacity=cap,
                            disk_capacities=[1500.0, 1500.0], bad_disks=[1]))
    b.add_broker(BrokerSpec(2, rack="r1", capacity=cap, disk_capacities=[2000.0, 1000.0]))
    b.add_broker(BrokerSpec(3, rack="r1", capacity=cap, disk_capacities=[1500.0, 1500.0]))
    load = np.array([5.0, 40.0, 50.0, 400.0], np.float32)
    for p in range(6):
        brokers = [p % 4, (p + 1) % 4]
        b.add_partition(PartitionSpec(
            "T1", p, brokers, load, replica_disks=[p % 2, 0]
        ))
    return b.build(device)


#: host of each broker of `collision_cluster`: four brokers share h0 and
#: three share h1, so several surviving moves meet on one host
COLLISION_HOSTS = ("h0", "h0", "h0", "h1", "h1", "h2", "h3", "h4", "h0", "h1", "h5", "h6")


def collision_cluster(device=None) -> ClusterState:
    """12 JBOD brokers (2 logdirs each) on 7 hosts, for apply_moves' order
    of float additions (`apply_collision_case`)."""
    b = ClusterModelBuilder()
    cap = np.array([100.0, 1e9, 1e9, 2e9], np.float32)
    for i, host in enumerate(COLLISION_HOSTS):
        b.add_broker(BrokerSpec(i, rack=f"r{i % 3}", host=host, capacity=cap,
                                disk_capacities=[1e9, 1e9]))
    load = np.array([1.0, 10.0, 10.0, 100.0], np.float32)
    for p in range(8):
        brokers = [p % 12, (p + 5) % 12]
        b.add_partition(PartitionSpec("T1" if p % 2 else "T2", p, brokers, load,
                                      replica_disks=[p % 2, (p + 1) % 2]))
    return b.build(device)


def apply_collision_case(state: ClusterState, seed: int = 0):
    """A hand-built survivor set for apply_moves on `collision_cluster`:
    (sv_r, payr, sv_l, payl, aggregates), numpy arrays.

    Four relocation rows (three survive), one swap as its two linked rows
    (src->dst and dst->src of brokers 4 and 7), three leadership rows (two
    survive); the rows that do not survive touch survivors' brokers.
    Every broker is the src of at most one surviving row and the dst of at
    most one, as select_survivors guarantees.  Host h0 gets four events
    (two relocation srcs, a relocation dst, a leadership src) and h1 four.
    Loads and aggregates span 1e-2..1e8, so any other order of the float
    additions shows in the last bits.  `aggregates` holds float values to
    put in the carry's broker_load, broker_potential_nw_out,
    broker_leader_bytes_in, disk_load and host_load first."""
    rng = np.random.default_rng(seed)
    s = state.shape
    B, D, H = s.B, s.max_disks_per_broker, s.num_hosts

    def mixed(*shape):
        return (10.0 ** rng.uniform(-2.0, 8.0, shape)).astype(np.float32)

    i32 = np.int32
    src = np.array([0, 1, 6, 0, 4, 7], i32)
    dst = np.array([3, 5, 2, 1, 7, 4], i32)
    n_rel = src.size
    payr = dict(
        r=np.array([0, 2, 12, 4, 8, 13], i32), src=src, dst=dst,
        d_src=np.array([0, 1, 1, 0, 1, 0], i32), d_dst=np.array([1, 0, 1, 1, 0, 1], i32),
        load=mixed(n_rel, NUM_RESOURCES), is_lead=np.array([True, False, True, False, False, True]),
        pot=mixed(n_rel), lbin=mixed(n_rel), topic=np.array([0, 1, 0, 1, 0, 1], i32),
        part=np.array([0, 1, 6, 2, 4, 7], i32),
    )
    sv_r = np.array([True, True, True, False, True, True])
    n_lead = 3
    payl = dict(
        rf=np.array([1, 3, 5], i32), rt=np.array([9, 11, 15], i32),
        src_b=np.array([8, 10, 0], i32), dst_b=np.array([9, 11, 3], i32),
        dl_f=-mixed(n_lead, NUM_RESOURCES), dl_t=mixed(n_lead, NUM_RESOURCES),
        dlbin_src=mixed(n_lead), dlbin_dst=mixed(n_lead),
        d_f=np.array([1, 0, 0], i32), d_t=np.array([0, 1, 1], i32),
    )
    sv_l = np.array([True, True, False])
    aggregates = dict(
        broker_load=mixed(B, NUM_RESOURCES), broker_potential_nw_out=mixed(B),
        broker_leader_bytes_in=mixed(B), disk_load=mixed(B, D), host_load=mixed(H, NUM_RESOURCES),
    )
    return sv_r, payr, sv_l, payl, aggregates


#: select_survivors' synthetic cases (`select_case`)
SELECT_CASES = ("ties", "signed_zero", "two_partitions", "random", "part2_out_of_range",
                "none_accepted", "k16383", "k16384", "north_star_segments")
#: select_survivors' array inputs, in its argument order
SELECT_INPUTS = ("accept", "delta", "src", "dst", "part1", "part2")


def select_case(name: str, seed: int = 0) -> dict:
    """Inputs of select_survivors for one synthetic case (numpy arrays
    `SELECT_INPUTS`, and the sizes K, B, P, n_r, n_s; a quarter of the
    candidates are leadership rows, 1/32 swaps).  Cases: ties, signed
    zeros, two partitions a candidate, random deltas, part2 outside the
    segments on both sides (dropped on the write, clamped on the read), no
    candidate accepted (9 brokers, 13 partitions, K = 4,096); K = 16,383
    (not a multiple of any block size) and 16,384 over 64 brokers and 500
    partitions; the north star's segments (2,600 brokers, 200,000
    partitions, K = 16,384).  `seed` varies the draws, not the sizes."""
    B, P, K = {"k16383": (64, 500, 16383), "k16384": (64, 500, 16384),
               "north_star_segments": (2600, 200_000, 16384)}.get(name, (9, 13, 4096))
    rng = np.random.default_rng([SELECT_CASES.index(name), seed])
    delta = rng.normal(size=K).astype(np.float32)
    if name == "ties":
        delta = rng.choice(np.float32([-2.0, -1.0, -1.0, 0.5]), K)
    elif name == "signed_zero":
        delta = rng.choice(np.float32([-0.0, 0.0, -1e-30, 1e-30, -3.0]), K)
    part1 = rng.integers(0, P, K).astype(np.int32)
    part2 = part1
    if name in ("two_partitions", "part2_out_of_range", "k16383", "k16384", "north_star_segments"):
        part2 = rng.integers(0, P, K).astype(np.int32)
    if name == "part2_out_of_range":
        out = rng.random(K) < 0.2
        part2 = np.where(out, rng.choice(np.int32([P, P + 5, -B - 1, -B - 40]), K), part2)
    accept = rng.random(K) < (0.0 if name == "none_accepted" else 0.7)
    n_s, n_l = K // 32, K // 4
    return dict(accept=accept, delta=delta, src=rng.integers(0, B, K).astype(np.int32),
                dst=rng.integers(0, B, K).astype(np.int32), part1=part1,
                part2=part2.astype(np.int32), K=K, B=B, P=P, n_r=K - n_s - n_l, n_s=n_s)


@dataclasses.dataclass
class RandomClusterSpec:
    """Knobs of the random generator (reference common/ClusterProperty.java)."""

    num_brokers: int = 50
    num_racks: int = 5
    num_topics: int = 20
    num_partitions: int = 1000
    min_replication: int = 2
    max_replication: int = 3
    mean_cpu: float = 2.0  # per-partition leader CPU %
    mean_nw_in: float = 100.0
    mean_nw_out: float = 120.0
    mean_disk: float = 500.0
    deviation: float = 0.5  # lognormal-ish spread
    broker_capacity: tuple[float, float, float, float] = (100.0, 20_000.0, 20_000.0, 500_000.0)
    num_dead_brokers: int = 0
    num_new_brokers: int = 0
    skew: float = 0.0  # 0 = uniform placement; >0 biases placement to low-id brokers
    replica_capacity: int | None = None  # pad replica axis to this
    disks_per_broker: int = 1  # >1 = JBOD (reference config/capacityJBOD.json)


def random_cluster(spec: RandomClusterSpec, seed: int = 0, device=None) -> ClusterState:
    rng = np.random.default_rng(seed)
    b = ClusterModelBuilder(replica_capacity=spec.replica_capacity)
    cap = np.asarray(spec.broker_capacity, np.float32)
    D = max(1, spec.disks_per_broker)
    disks = (
        [float(cap[Resource.DISK]) / D] * D if D > 1 else None
    )  # JBOD: split capacity evenly across logdirs
    for i in range(spec.num_brokers):
        alive = i < spec.num_brokers - spec.num_dead_brokers
        new = i >= spec.num_brokers - spec.num_new_brokers if alive else False
        b.add_broker(
            BrokerSpec(i, rack=f"r{i % spec.num_racks}", capacity=cap, alive=alive,
                       new_broker=new, disk_capacities=disks)
        )
    means = np.array(
        [spec.mean_cpu, spec.mean_nw_in, spec.mean_nw_out, spec.mean_disk], np.float64
    )
    # placement weights: optionally skewed so the cluster starts unbalanced
    w = np.exp(-spec.skew * np.arange(spec.num_brokers) / max(1, spec.num_brokers - 1))
    # round-robin topic assignment so exactly num_partitions are generated
    for pid in range(spec.num_partitions):
        t = pid % spec.num_topics
        p = pid // spec.num_topics
        rf = int(rng.integers(spec.min_replication, spec.max_replication + 1))
        rf = min(rf, spec.num_brokers)
        brokers = rng.choice(spec.num_brokers, size=rf, replace=False, p=w / w.sum()).tolist()
        load = (means * np.exp(rng.normal(0.0, spec.deviation, NUM_RESOURCES))).astype(np.float32)
        rdisks = [int(x) for x in rng.integers(0, D, size=rf)] if D > 1 else None
        b.add_partition(
            PartitionSpec(f"T{t}", p, [int(x) for x in brokers], load, replica_disks=rdisks)
        )
    return b.build(device)


def random_cluster_fast(spec: RandomClusterSpec, seed: int = 0, device=None) -> ClusterState:
    """Vectorized large-cluster generator (north-star scale: 200k partitions).

    Same distribution semantics as random_cluster but builds the state's
    arrays directly with numpy.  Weighted placement samples iid from the
    skew distribution and resamples the (rare) rows that drew duplicate
    brokers.
    """
    rng = np.random.default_rng(seed)
    B, P, T = spec.num_brokers, spec.num_partitions, spec.num_topics
    alive_count = B - spec.num_dead_brokers

    # broker axis
    cap = np.tile(np.asarray(spec.broker_capacity, np.float32), (B, 1))
    rack = (np.arange(B) % spec.num_racks).astype(np.int32)
    host = np.arange(B, dtype=np.int32)
    alive = np.arange(B) < alive_count
    new = np.zeros(B, bool)
    if spec.num_new_brokers:
        new[alive_count - spec.num_new_brokers: alive_count] = True

    # replication factors + replica slots
    rf = rng.integers(spec.min_replication, spec.max_replication + 1, size=P)
    rf = np.minimum(rf, B)
    R = int(rf.sum())
    r_part = np.repeat(np.arange(P, dtype=np.int32), rf)
    r_pos = (np.arange(R) - np.repeat(np.cumsum(rf) - rf, rf)).astype(np.int32)
    r_topic = (r_part % T).astype(np.int32)

    # weighted iid placement + duplicate fixup
    w = np.exp(-spec.skew * np.arange(B) / max(1, B - 1))
    cdf = np.cumsum(w / w.sum())
    r_broker = np.searchsorted(cdf, rng.random(R)).astype(np.int32)
    for _ in range(64):
        # detect duplicate (partition, broker) pairs
        key = r_part.astype(np.int64) * B + r_broker
        order = np.argsort(key, kind="stable")
        dup_sorted = np.zeros(R, bool)
        dup_sorted[1:] = key[order][1:] == key[order][:-1]
        dup = np.zeros(R, bool)
        dup[order] = dup_sorted
        if not dup.any():
            break
        r_broker[dup] = np.searchsorted(cdf, rng.random(int(dup.sum()))).astype(np.int32)
    else:
        raise RuntimeError("could not de-duplicate placement (too few brokers?)")

    # loads: per-partition lognormal around the means, shared by replicas
    means = np.array(
        [spec.mean_cpu, spec.mean_nw_in, spec.mean_nw_out, spec.mean_disk], np.float64
    )
    p_load = (means * np.exp(rng.normal(0.0, spec.deviation, (P, NUM_RESOURCES)))).astype(
        np.float32
    )
    r_ll = p_load[r_part]
    # follower load: NW_OUT -> 0, CPU -> 0.3x (default_follower_load, vectorized)
    r_fl = r_ll.copy()
    r_fl[:, Resource.NW_OUT] = 0.0
    r_fl[:, Resource.CPU] *= 0.3

    r_leader = r_pos == 0
    r_offline = ~alive[r_broker]

    D = max(1, spec.disks_per_broker)
    shape = ClusterShape(
        num_replicas=R,
        num_brokers=B,
        num_partitions=P,
        num_topics=T,
        num_racks=spec.num_racks,
        num_hosts=B,
        max_disks_per_broker=D,
    )
    # JBOD: split broker disk capacity evenly across D logdirs and place
    # replicas on random disks (reference config/capacityJBOD.json semantics)
    disk_cap = np.tile(cap[:, Resource.DISK:Resource.DISK + 1] / D, (1, D)).copy()
    r_disk = (
        rng.integers(0, D, R).astype(np.int32) if D > 1 else np.zeros(R, np.int32)
    )
    arrays = dict(
        replica_broker=r_broker,
        replica_partition=r_part,
        replica_topic=r_topic,
        replica_pos=r_pos,
        replica_is_leader=r_leader,
        replica_valid=np.ones(R, bool),
        replica_orig_broker=r_broker.copy(),
        replica_offline=r_offline,
        replica_disk=r_disk,
        replica_load_leader=r_ll,
        replica_load_follower=r_fl,
        broker_capacity=cap,
        broker_rack=rack,
        broker_host=host,
        broker_alive=alive,
        broker_new=new,
        broker_valid=np.ones(B, bool),
        disk_capacity=disk_cap,
        disk_alive=np.tile(alive[:, None], (1, D)).copy(),
    )
    return state_from_numpy(arrays, shape, resolve_device(device))


def prior_table(shape: ClusterShape, seed: int = 0, mix: float = 0.5):
    """A warm learned prior for a cluster of `shape` (controller/prior.py
    `PriorTable`): per topic, acceptance mass on a few brokers drawn from
    `seed` (a quarter of the topics have none, and draw uniformly), at
    `mix`."""
    from cruise_control_tpu_torch.controller.prior import PriorTable

    rng = np.random.default_rng(seed)
    T, B = shape.num_topics, shape.B
    w = np.zeros((T, B), np.float32)
    for t in range(T):
        if rng.random() < 0.25:
            continue
        hot = rng.choice(B, size=min(B, int(rng.integers(1, 6))), replace=False)
        w[t, hot] = rng.uniform(0.5, 4.0, hot.size).astype(np.float32)
    return PriorTable(weights=w, mix=mix, observations=float(w.sum()))


def set_offline_rows(a: dict) -> None:
    """replica_offline of the arrays' liveness."""
    ok = a["broker_alive"][a["replica_broker"]] & a["disk_alive"][a["replica_broker"], a["replica_disk"]]
    a["replica_offline"] = a["replica_valid"] & ~ok


def _drop_partition(a: dict, part: int) -> None:
    """The partition's replica rows made padding rows (as the builder pads)."""
    rows = a["replica_valid"] & (a["replica_partition"] == part)
    pad = int(np.nonzero(~a["replica_valid"])[0][-1])
    for f, v in a.items():
        if f.startswith("replica_"):
            v[rows] = v[pad]


def generation_sequence(base: dict) -> list[tuple[str, dict, dict]]:
    """Model generations of one shape, each the `base` arrays (a state's
    fields as host numpy arrays, by name, with padding replica rows and at
    least one padding broker) with one change to a value an engine derives
    from a generation: the loads, liveness (n_alive, a dead broker's
    offline rows), a broker's capacity (the capacity totals and their
    weights), a logdir's capacity (total_disk_cap), offline rows (a dead
    logdir), n_valid with the replicas still front-packed, n_source with a
    hole in the replica rows, n_dest (the options' excluded brokers),
    n_brokers (the first padding broker made real) and shared_hosts (two
    brokers on one host).  Returns (name, arrays, OptimizationOptions
    keyword arguments) for each."""
    B = base["broker_valid"].size
    n_real = int(base["broker_valid"].sum())
    parts = base["replica_partition"][base["replica_valid"]]
    out = []

    def gen(name, edit, **opts):
        a = {f: v.copy() for f, v in base.items()}
        edit(a)
        out.append((name, a, opts))

    gen("loads", lambda a: a["replica_load_leader"].__imul__(np.float32(1.3)))

    def dead(a):
        a["broker_alive"][1] = False
        a["disk_alive"][1] = False
        set_offline_rows(a)

    gen("liveness", dead)
    gen("capacity", lambda a: a["broker_capacity"][2].__imul__(np.float32(2.0)))
    gen("disk_capacity", lambda a: a["disk_capacity"][3].__imul__(np.float32(1.5)))

    def dead_disk(a):
        a["disk_alive"][0, 0] = False
        set_offline_rows(a)

    gen("offline_rows", dead_disk)
    gen("n_valid", lambda a: _drop_partition(a, int(parts.max())))
    gen("n_source", lambda a: _drop_partition(a, int(parts.min())))
    gen("n_dest", lambda a: None, excluded_brokers_for_replica_move=np.arange(B) == 4)

    def new_broker(a):
        b = n_real
        a["broker_valid"][b] = a["broker_alive"][b] = a["broker_new"][b] = True
        a["broker_capacity"][b] = a["broker_capacity"][0]
        a["disk_capacity"][b] = a["disk_capacity"][0]
        a["disk_alive"][b] = True
        a["broker_rack"][b] = 0
        a["broker_host"][b] = b

    gen("n_brokers", new_broker)
    gen("shared_hosts", lambda a: a["broker_host"].__setitem__(3, a["broker_host"][2]))
    return out
