"""The reference against a cluster checked by hand, its reading of a
corrupted answer, and its agreement with the program's chain."""

import collections

import numpy as np
import pytest
import torch

from conftest import small_cell
from harness import generator
from reference import answer, goals, scenario

K = small_cell("kafka_200k.rebalance").config["constraint"]
DIMS = dict(num_replicas=6, num_brokers=4, num_partitions=3, num_topics=1, num_racks=2,
            num_hosts=4, max_disks_per_broker=1)
Proposal = collections.namedtuple(
    "Proposal", "partition old_replicas new_replicas old_leader new_leader disk_moves")


def tiny() -> dict:
    """4 brokers on racks 0, 0, 1, 1; p0 on brokers 0, 1 (one rack), p1 on
    2, 0 and p2 on 3, 1, the first of each the leader."""
    lead = np.array([10.0, 100.0, 100.0, 1000.0], np.float32)
    foll = np.array([3.0, 100.0, 0.0, 1000.0], np.float32)
    pos = np.array([0, 1, 0, 1, 0, 1], np.int32)
    return dict(
        replica_broker=np.array([0, 1, 2, 0, 3, 1], np.int32),
        replica_partition=np.array([0, 0, 1, 1, 2, 2], np.int32),
        replica_topic=np.zeros(6, np.int32), replica_pos=pos, replica_is_leader=pos == 0,
        replica_valid=np.ones(6, bool), replica_orig_broker=np.array([0, 1, 2, 0, 3, 1], np.int32),
        replica_offline=np.zeros(6, bool), replica_disk=np.zeros(6, np.int32),
        replica_load_leader=np.tile(lead, (6, 1)), replica_load_follower=np.tile(foll, (6, 1)),
        broker_capacity=np.tile(np.array([100.0, 1000.0, 1000.0, 10000.0], np.float32), (4, 1)),
        broker_rack=np.array([0, 0, 1, 1], np.int32), broker_host=np.arange(4, dtype=np.int32),
        broker_alive=np.ones(4, bool), broker_new=np.zeros(4, bool), broker_valid=np.ones(4, bool),
        disk_capacity=np.full((4, 1), 10000.0, np.float32), disk_alive=np.ones((4, 1), bool))


def test_tiny_cluster_by_hand():
    c = goals.Cluster(tiny(), DIMS)
    assert c.load[:, 0].tolist() == [13.0, 6.0, 10.0, 10.0]
    v = {n: float(goals.violation(n, c, K)) for n in (
        "RackAwareGoal", "OfflineReplicaGoal", "ReplicaDistributionGoal",
        "LeaderReplicaDistributionGoal", "CpuCapacityGoal", "DiskCapacityGoal",
        "CpuUsageDistributionGoal")}
    assert v["RackAwareGoal"] == pytest.approx(1 / 6)
    assert v["OfflineReplicaGoal"] == v["ReplicaDistributionGoal"] == 0.0
    assert v["LeaderReplicaDistributionGoal"] == v["CpuCapacityGoal"] == v["DiskCapacityGoal"] == 0
    # loads 13, 6, 10, 10 against the band 0.0975 x (0.9, 1.1) x 100
    assert v["CpuUsageDistributionGoal"] == pytest.approx((13 - 10.725 + 8.775 - 6) / 39)
    assert float(goals.score("CpuUsageDistributionGoal", c)) == pytest.approx(
        np.sqrt(0.00061875) / 0.0975)
    dead = goals.Cluster(generator.kill(tiny(), np.array([3])), DIMS)
    assert float(goals.violation("OfflineReplicaGoal", dead, K)) == pytest.approx(1 / 6)
    obj, viol = goals.evaluate(c, ["RackAwareGoal", "CpuUsageDistributionGoal"], K)
    w = goals.chain_weights(["RackAwareGoal", "CpuUsageDistributionGoal"])
    assert w == [1e4, 0.5]
    assert obj == pytest.approx(1e4 / 6 + 0.5 * viol[1] + 1e-3 * 0.5 * np.sqrt(0.00061875) / 0.0975)


def _answer(cols, broker):
    after = {f: cols[f].copy() for f in ("replica_broker", "replica_is_leader", "replica_disk")}
    after["replica_broker"][:] = broker
    return after


def test_a_sound_answer_and_a_corrupted_one():
    cols = tiny()
    # move p0's follower from broker 1 to broker 2 (rack awareness repaired)
    after = _answer(cols, [0, 2, 2, 0, 3, 1])
    good = [Proposal(0, (0, 1), (0, 2), 0, 0, ())]
    assert answer.placement_faults(cols, DIMS, after) == 0
    assert answer.proposal_faults(cols, after, good) == 0
    assert float(goals.violation("RackAwareGoal", goals.Cluster(cols, DIMS, placement=after),
                                 K)) == 0.0
    # the answer that says broker 1 but placed the replica on broker 3
    assert answer.proposal_faults(cols, after, [Proposal(0, (0, 1), (0, 3), 0, 0, ())]) == 1
    assert answer.proposal_faults(cols, after, []) == 1
    assert answer.proposal_faults(cols, after, good + good) == 1
    # two replicas of p0 on one broker, and a partition with no leader
    bad = _answer(cols, [0, 0, 2, 0, 3, 1])
    bad["replica_is_leader"][4] = False
    assert answer.placement_faults(cols, DIMS, bad) == 2
    assert answer.proposal_faults(cols, bad, good) >= 1


def test_scenario_application_by_hand():
    cols = tiny()
    c, d = scenario.apply(cols, DIMS, dict(kill_racks=[1], add_brokers=[[2, 0]],
                                           topic_factors={0: 2.0}))
    assert d["num_brokers"] == 6 and c["broker_alive"].tolist() == [1, 1, 0, 0, 1, 1]
    assert c["broker_host"][4:].tolist() == [4, 5] and c["broker_rack"][4:].tolist() == [0, 0]
    assert c["replica_offline"].tolist() == [0, 0, 1, 0, 1, 0]
    assert (c["replica_load_leader"] == 2 * cols["replica_load_leader"]).all()
    cl = goals.Cluster(c, d)
    assert float(goals.violation("OfflineReplicaGoal", cl, K)) == pytest.approx(2 / 6)


@pytest.mark.parametrize("cell", ["kafka_200k.rebalance", "kafka_200k_jbod.rebalance_ring"])
def test_reference_agrees_with_the_program(cell):
    """The program's float32 chain on the CPU against the reference's
    float64 on a small cluster of the cell's spec and chain."""
    from cruise_control_tpu_torch.analyzer.objective import GoalChain
    from cruise_control_tpu_torch.config.balancing import BalancingConstraint
    from cruise_control_tpu_torch.models.builder import state_from_numpy
    from cruise_control_tpu_torch.models.state import ClusterShape

    c = small_cell(cell)
    cols, dims = generator.generate(c.config["spec"], 11)
    names = c.config["goals"]
    st = state_from_numpy(cols, ClusterShape(**dims), "cpu")
    kc = BalancingConstraint(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in c.config["constraint"].items()})
    obj, viol, _ = GoalChain.from_names(names).evaluate(st, constraint=kc)
    r_obj, r_viol = goals.evaluate(goals.Cluster(cols, dims), names, c.config["constraint"])
    assert float(obj) == pytest.approx(r_obj, rel=1e-5)
    np.testing.assert_allclose(viol.numpy(), r_viol, rtol=1e-4, atol=1e-7)
    b_obj, _ = goals.evaluate(goals.Cluster(cols, dims, torch.bfloat16), names,
                              c.config["constraint"])
    assert abs(b_obj - r_obj) > 1e-4 * abs(r_obj)
