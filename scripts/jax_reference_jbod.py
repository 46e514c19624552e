"""The JAX package's results on the JBOD path, as references for the port.

Runs, with the JAX package (cruise_control_tpu) on the CPU:
  config3        BASELINE.md configuration 3 exactly as bench.py's config_3
                 builds it (500 brokers, 50,000 partitions, 4 logdirs a
                 broker, seed 42; RackAware, DiskCapacity and the two
                 intra-broker disk goals; bench.py's SEARCH);
  rebalance_disk the same cluster with DEFAULT_INTRA_BROKER_GOAL_ORDER and
                 intra_broker=True (the service's rebalance_disk).
Prints one JSON line each: the shape, the violated goals after, the
objective before and after, the rounds, the proposals and the wall time
(host clock, this machine's CPU; not a device number).

    JAX_PLATFORMS=cpu python scripts/jax_reference_jbod.py [config3] [rebalance_disk]
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: bench.py's MID_SPEC (bench.py:65) and SEARCH (bench.py:78)
MID_SPEC = dict(num_brokers=500, num_racks=20, num_topics=100, num_partitions=50_000, skew=0.5,
                broker_capacity=(100.0, 300_000.0, 300_000.0, 3_000_000.0), mean_cpu=0.2,
                mean_nw_in=500.0, mean_nw_out=600.0, mean_disk=5000.0)
SEARCH = dict(num_candidates=16384, leadership_candidates=4096, steps_per_round=64, num_rounds=8,
              seed=0)
CONFIG3_CHAIN = ["RackAwareGoal", "DiskCapacityGoal", "IntraBrokerDiskCapacityGoal",
                 "IntraBrokerDiskUsageDistributionGoal"]


def main(names) -> None:
    from cruise_control_tpu.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
    from cruise_control_tpu.analyzer.objective import GoalChain
    from cruise_control_tpu.testing.fixtures import RandomClusterSpec, random_cluster_fast

    state = random_cluster_fast(RandomClusterSpec(**{**MID_SPEC, "disks_per_broker": 4}), seed=42)
    runs = {
        "config3": (CONFIG3_CHAIN, {}),
        "rebalance_disk": (list(DEFAULT_INTRA_BROKER_GOAL_ORDER), {"intra_broker": True}),
    }
    for name in names:
        goals, extra = runs[name]
        opt = GoalOptimizer(chain=GoalChain.from_names(goals),
                            config=OptimizerConfig(**SEARCH, **extra))
        t0 = time.monotonic()
        res = opt.optimize(state)
        wall = time.monotonic() - t0
        rounds = [h for h in res.history if "round" in h]
        s = state.shape
        print(json.dumps({
            "run": name, "package": "cruise_control_tpu (JAX, CPU)", "replicas": s.R,
            "brokers": s.B, "partitions": s.P, "disks_per_broker": s.max_disks_per_broker,
            "goals": goals, "violated_after": res.violated_goals_after(),
            "violations_after": [float(v) for v in res.violations_after],
            "objective_before": res.objective_before, "objective_after": res.objective_after,
            "rounds": len(rounds), "accepted": [h["accepted"] for h in rounds],
            "proposals": len(res.proposals), "replica_moves": res.num_inter_broker_moves,
            "leader_moves": res.num_leadership_moves,
            "disk_moves": sum(bool(p.disk_moves) for p in res.proposals),
            "wall_s_cpu_host": wall,
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["config3", "rebalance_disk"])
