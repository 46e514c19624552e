"""The port's executor and detectors against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through both packages;
the bar is identity, with no tolerance:

- the inter-broker, intra-broker and leadership drains of
  `ExecutionTaskPlanner` under each replica-movement strategy, with random
  slot maps (0 slots and a dead broker's 1,000,000 among them),
  in-progress sets and `max_total`: the same execution ids in the same
  order, call after call until both queues are empty (the port's
  inter-broker drain scans a cursor per broker);
- a whole execution (200 brokers, 4,000 partitions, 1,500 proposals with
  inter-broker, leadership and JBOD moves, one dropped and one stalled
  partition, a cluster cap of 100, the same uuid and injected clock):
  every task transition as (execution id, state, ms), the
  `ExecutionResult`, every partition's replicas and leader and the
  topology's generation after each tick (the port's simulated admin lands
  a tick's reassignments in one rebuild), and the journal files byte for
  byte;
- `GoalViolationDetector` on four fixtures, with and without the
  detection threshold multiplier: the same fixable and unfixable lists;
- tests/test_detector.py's dead-broker self-healing loop through both
  packages: the same executed topology.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

PKGS = ("cruise_control_tpu", "cruise_control_tpu_torch")
STRATEGIES = (
    "BaseReplicaMovementStrategy",
    "PrioritizeLargeReplicaMovementStrategy",
    "PrioritizeSmallReplicaMovementStrategy",
    "PostponeUrpReplicaMovementStrategy",
)


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        proposals=mod("analyzer.proposals"), executor=mod("executor"), admin=mod("executor.admin"),
        topology=mod("monitor.topology"), detector=mod("detector"), objective=mod("analyzer.objective"),
        balancing=mod("config.balancing"), fixtures=mod("testing.fixtures"),
    )


def _proposals(m, raw) -> list:
    return [
        m.proposals.ExecutionProposal(
            partition=p["partition"], topic=p["topic"], old_leader=p["old_leader"], new_leader=p["new_leader"],
            old_replicas=p["old"], new_replicas=p["new"], disk_moves=p["disk_moves"],
            inter_broker_data_to_move=p["data"], intra_broker_data_to_move=p["intra"],
        )
        for p in raw
    ]


def _raw_proposals(rng, num_brokers: int, partitions: list, n_inter: int, n_leader: int, n_intra: int,
                   ties: bool = False) -> list:
    """Proposals over distinct partitions of `partitions` ((topic, partition,
    replicas) triples): inter-broker moves (one or two replicas replaced, a
    new leader drawn from the new set), leadership-only transfers and JBOD
    disk moves.  `ties` draws data sizes from a few values."""
    picks = rng.permutation(len(partitions))[: n_inter + n_leader + n_intra]
    out = []
    for k, i in enumerate(picks.tolist()):
        topic, part, reps = partitions[i]
        reps = tuple(int(b) for b in reps)
        data = float(rng.choice([100.0, 200.0, 300.0])) if ties else float(rng.integers(1_000, 60_000))
        p = dict(topic=topic, partition=part, old=reps, old_leader=reps[0], disk_moves=(), data=data, intra=0.0)
        if k < n_inter:
            outside = np.setdiff1d(np.arange(num_brokers), reps)
            n_swap = 1 + int(rng.random() < 0.3 and len(reps) > 1)
            new = list(reps)
            for j, b in zip(rng.choice(len(reps), n_swap, replace=False).tolist(),
                            rng.choice(outside, n_swap, replace=False).tolist()):
                new[j] = int(b)
            p.update(new=tuple(new), new_leader=int(rng.choice(new)))
        elif k < n_inter + n_leader:
            p.update(new=reps, new_leader=int(rng.choice(reps[1:])), data=0.0)
        else:
            b = int(rng.choice(reps))
            p.update(new=reps, new_leader=reps[0], disk_moves=((b, 0, 1),), data=0.0,
                     intra=float(rng.integers(100, 5_000)))
        out.append(p)
    return out


def _random_partitions(rng, num_brokers: int, num_topics: int, per_topic: int) -> list:
    parts = []
    for t in range(num_topics):
        for n in range(per_topic):
            rf = int(rng.integers(2, 4))
            parts.append((t, n, tuple(int(b) for b in rng.choice(num_brokers, rf, replace=False))))
    return parts


# ------------------------------------------------------------------ drains


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_drains_choose_the_same_tasks(strategy, seed):
    rng = np.random.default_rng(seed)
    B = 24
    parts = _random_partitions(rng, B, 4, 60)
    raw = _raw_proposals(rng, B, parts, n_inter=150, n_leader=30, n_intra=30, ties=True)
    keys = [(p["topic"], p["partition"]) for p in raw]
    context = {"urp_partitions": {keys[i] for i in rng.choice(len(keys), 40, replace=False).tolist()}}
    planners = []
    for name in PKGS:
        m = _pkg(name)
        pl = m.executor.ExecutionTaskPlanner(m.executor.STRATEGIES_BY_NAME[strategy])
        tasks = pl.add_execution_proposals(_proposals(m, raw), context)
        planners.append((pl, [t.execution_id for t in tasks]))
    assert planners[0][1] == planners[1][1]
    (jax_pl, _), (port_pl, _) = planners
    calls = 0
    while jax_pl.remaining_inter_broker_moves or jax_pl.remaining_intra_broker_moves \
            or jax_pl.remaining_leadership_moves:
        calls += 1
        assert calls < 400, "the drains stopped making progress"
        # a slot map over a random subset of the brokers, in a random
        # order: 0 slots, a few, and a dead broker's 1,000,000
        brokers = rng.permutation(B)[: int(rng.integers(B // 2, B + 1))].tolist()
        choices = np.array([0, 1, 2, 3, 5, 1_000_000])
        slots = {int(b): int(rng.choice(choices, p=[0.2, 0.25, 0.2, 0.15, 0.15, 0.05])) for b in brokers}
        left = [(t.proposal.topic, t.proposal.partition) for t in jax_pl.remaining_inter_broker_moves]
        in_prog = {left[i] for i in rng.choice(len(left), min(len(left), int(rng.integers(0, 8))),
                                               replace=False).tolist()} if left else set()
        max_total = None if rng.random() < 0.3 else int(rng.integers(0, 40))
        got = [pl.get_inter_broker_replica_movement_tasks(dict(slots), set(in_prog), max_total=max_total)
               for pl in (jax_pl, port_pl)]
        assert [t.execution_id for t in got[0]] == [t.execution_id for t in got[1]]
        intra_total = None if rng.random() < 0.5 else int(rng.integers(0, 10))
        got = [pl.get_intra_broker_replica_movement_tasks(dict(slots), max_total=intra_total)
               for pl in (jax_pl, port_pl)]
        assert [t.execution_id for t in got[0]] == [t.execution_id for t in got[1]]
        if not jax_pl.remaining_inter_broker_moves and not jax_pl.remaining_intra_broker_moves:
            n = int(rng.integers(1, 50))
            got = [pl.get_leadership_movement_tasks(n) for pl in (jax_pl, port_pl)]
            assert [t.execution_id for t in got[0]] == [t.execution_id for t in got[1]]
        for attr in ("remaining_inter_broker_moves", "remaining_intra_broker_moves",
                     "remaining_leadership_moves"):
            assert [t.execution_id for t in getattr(jax_pl, attr)] == \
                [t.execution_id for t in getattr(port_pl, attr)]
    assert not (port_pl.remaining_inter_broker_moves or port_pl.remaining_intra_broker_moves
                or port_pl.remaining_leadership_moves)


def test_port_drain_adopts_recovered_tasks_like_the_reference():
    """adopt_tasks (journal recovery) keeps ids and feeds the same drain."""
    rng = np.random.default_rng(5)
    B = 12
    raw = _raw_proposals(rng, B, _random_partitions(rng, B, 2, 40), n_inter=40, n_leader=0, n_intra=0)
    out = []
    for name in PKGS:
        m = _pkg(name)
        tasks = [m.executor.ExecutionTask(100 + 3 * i, p, m.executor.TaskType.INTER_BROKER_REPLICA_ACTION)
                 for i, p in enumerate(_proposals(m, raw))]
        pl = m.executor.ExecutionTaskPlanner()
        pl.adopt_tasks(tasks[::-1])
        seq = []
        while pl.remaining_inter_broker_moves:
            seq.append([t.execution_id for t in
                        pl.get_inter_broker_replica_movement_tasks({b: 2 for b in range(B)}, set(), 7)])
        out.append((seq, pl.add_execution_proposals(_proposals(m, raw[:1]))[0].execution_id))
    assert out[0] == out[1]


# ------------------------------------------------------- whole execution


def _topology(m, parts, num_brokers: int):
    brokers = tuple(m.topology.BrokerNode(b, rack=f"r{b % 10}", host=f"h{b}") for b in range(num_brokers))
    infos = tuple(m.topology.PartitionInfo(f"T{t}", n, leader=reps[0], replicas=reps) for t, n, reps in parts)
    return m.topology.ClusterTopology(brokers=brokers, partitions=infos)


def _execute(name: str, parts, raw, num_brokers: int, journal_dir, *, dropped, stalled) -> dict:
    m = _pkg(name)
    meta = m.topology.StaticMetadataProvider(_topology(m, parts, num_brokers))
    admin = m.admin.SimulatedClusterAdmin(
        meta, link_rate_bytes_per_s=20_000.0, drop_partitions={dropped}, fail_partitions={stalled},
        intra_move_bytes=3_000.0,
    )
    ticks = []
    orig_tick = admin.tick

    def tick(seconds):
        done = orig_tick(seconds)
        topo = meta.topology()
        ticks.append((tuple(done), topo.generation,
                      tuple((p.topic, p.partition, p.leader, p.replicas) for p in topo.partitions)))
        return done

    admin.tick = tick
    clock = {"ms": 1_700_000_000_000}

    def now():
        clock["ms"] += 7
        return clock["ms"]

    journal = m.executor.ExecutionJournal(str(journal_dir / "journal.jsonl"))
    ex = m.executor.Executor(admin, topic_names={t: f"T{t}" for t in range(10)}, clock=now, journal=journal)
    transitions = []
    hook = ex._journal_task

    def observe(task, state, now_ms):
        transitions.append((task.execution_id, state.value, now_ms))
        hook(task, state, now_ms)

    ex._journal_task = observe
    options = m.executor.ExecutionOptions(
        max_num_cluster_movements=100, replication_throttle_bytes_per_s=15_000.0,
        reaper_stuck_timeout_s=4.0, progress_check_interval_s=0.5,
    )
    res = ex.execute_proposals(_proposals(m, raw), options, uuid="parity-execution",
                               removed_brokers={num_brokers - 1})
    journal.close()
    return dict(result=dataclasses.asdict(res), transitions=transitions, ticks=ticks,
                journal=(journal_dir / "journal.jsonl").read_bytes(),
                reexecuted=sorted(ex._reexecutions.items()), dropped=list(admin.dropped_reassignments))


def test_whole_execution_is_the_reference_exactly(tmp_path):
    rng = np.random.default_rng(17)
    B = 200
    parts = _random_partitions(rng, B, 10, 400)
    raw = _raw_proposals(rng, B, parts, n_inter=1_000, n_leader=300, n_intra=200)
    inter = [p for p in raw if p["old"] != p["new"]]
    dropped = (f"T{inter[3]['topic']}", inter[3]["partition"])
    stalled = (f"T{inter[10]['topic']}", inter[10]["partition"])
    runs = []
    for name in PKGS:
        d = tmp_path / name
        d.mkdir()
        runs.append(_execute(name, parts, raw, B, d, dropped=dropped, stalled=stalled))
    jax_run, port_run = runs
    r = jax_run["result"]
    # the case exercises what it claims: a re-executed drop, a reaped stall,
    # completions of every kind
    assert jax_run["dropped"] == [dropped] and jax_run["reexecuted"] == [(dropped, 1)]
    assert r["aborted"] >= 1 and r["completed"] >= 1_400 and r["ticks"] > 20
    assert len(jax_run["ticks"]) == r["ticks"]
    assert port_run["result"] == r
    assert port_run["transitions"] == jax_run["transitions"]
    assert len(port_run["ticks"]) == len(jax_run["ticks"])
    for i, (got, want) in enumerate(zip(port_run["ticks"], jax_run["ticks"])):
        assert got == want, f"tick {i + 1} differs"
    assert port_run["journal"] == jax_run["journal"]


def test_simulated_tick_generation_counts_each_landed_reassignment():
    """One tick landing n reassignments moves the generation by n in both
    packages, and leaves the same partitions."""
    out = []
    for name in PKGS:
        m = _pkg(name)
        parts = [(0, n, (n % 4, (n + 1) % 4)) for n in range(12)]
        meta = m.topology.StaticMetadataProvider(_topology(m, parts, 6))
        admin = m.admin.SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1e9)
        admin.reassign_partitions([m.admin.ReassignmentSpec("T0", n, (5, n % 4), 10.0) for n in (7, 2, 9, 4)])
        g0 = meta.topology().generation
        done = admin.tick(1.0)
        topo = meta.topology()
        out.append((done, topo.generation - g0, [(p.leader, p.replicas) for p in topo.partitions]))
        # an unknown partition raises where the reference raised, after the
        # earlier completions landed
        admin.reassign_partitions([m.admin.ReassignmentSpec("T0", 1, (5, 0), 1.0),
                                   m.admin.ReassignmentSpec("T9", 0, (5, 0), 1.0),
                                   m.admin.ReassignmentSpec("T0", 3, (5, 0), 1.0)])
        with pytest.raises(KeyError):
            admin.tick(1.0)
        topo = meta.topology()
        out.append((sorted(admin.in_progress_reassignments()), topo.generation - g0,
                    [(p.leader, p.replicas) for p in topo.partitions]))
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0][1] == 4


# ------------------------------------------------------------- detectors


@pytest.mark.parametrize("multiplier", [1.0, 2.5])
@pytest.mark.parametrize("fixture", ["small_cluster", "rack_violated_cluster", "dead_broker_cluster",
                                     "jbod_cluster"])
def test_goal_violation_detector_lists_match(fixture, multiplier):
    got = []
    for name in PKGS:
        m = _pkg(name)
        build = getattr(m.fixtures, fixture)
        provider = build if name == "cruise_control_tpu" else (lambda: build("cpu"))
        constraint = dataclasses.replace(
            m.balancing.DEFAULT_CONSTRAINT, goal_violation_distribution_threshold_multiplier=multiplier)
        v = m.detector.GoalViolationDetector(provider, m.objective.DEFAULT_CHAIN, constraint).detect()
        got.append(None if v is None else (v.fixable_violations, v.unfixable_violations))
    assert got[0] == got[1]
    if multiplier == 1.0 and fixture != "small_cluster":
        assert got[0] is not None


def test_goal_violation_detector_unfixable_disk_matches():
    """Total leader disk load above the alive disk capacity: DiskCapacityGoal
    is unfixable in both packages."""
    got = []
    for name in PKGS:
        m = _pkg(name)
        state = m.fixtures.dead_broker_cluster() if name == "cruise_control_tpu" \
            else m.fixtures.dead_broker_cluster("cpu")
        ll = np.array(state.replica_load_leader)
        ll[:, 3] *= 1e4
        wrap = jnp.asarray if name == "cruise_control_tpu" else torch.from_numpy
        state = dataclasses.replace(state, replica_load_leader=wrap(ll))
        v = m.detector.GoalViolationDetector(lambda: state, m.objective.DEFAULT_CHAIN).detect()
        got.append((v.fixable_violations, v.unfixable_violations))
    assert got[0] == got[1]
    assert "DiskCapacityGoal" in got[0][1]


def test_self_healing_dead_broker_matches_reference():
    """tests/test_detector.py's dead-broker fixture through both packages:
    the same proposals, the same executed topology."""
    tops = []
    for name in PKGS:
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        analyzer, monitor, executor, detector = (mod(x) for x in ("analyzer", "monitor", "executor", "detector"))
        synthetic = mod("testing.synthetic")
        base = synthetic.synthetic_topology(num_brokers=5, topics={"T0": 10}, seed=9)
        meta = monitor.StaticMetadataProvider(base)
        sampler = synthetic.SyntheticWorkloadSampler(base, seed=9)
        agg = monitor.WindowedMetricSampleAggregator(3, 1000, 1, monitor.KAFKA_METRIC_DEF)
        fetcher = monitor.MetricFetcherManager(sampler, agg, None)
        for w in range(4):
            fetcher.fetch_once(sampler.all_partition_entities(), w * 1000, (w + 1) * 1000 - 1)
        dev = {} if name == "cruise_control_tpu" else {"device": "cpu"}
        lm = monitor.LoadMonitor(meta, monitor.FixedCapacityResolver([100.0, 1e5, 1e5, 1e6]), agg, **dev)
        t = meta.topology()
        meta.set_topology(dataclasses.replace(
            t, brokers=tuple(dataclasses.replace(b, alive=b.broker_id != 4) for b in t.brokers)))
        admin = executor.SimulatedClusterAdmin(meta, link_rate_bytes_per_s=1e12)
        req = monitor.ModelCompletenessRequirements(min_required_num_windows=2)
        fixed = {}

        class Actions:
            is_busy = False

            def remove_brokers(self, broker_ids, reason):
                cfg = analyzer.OptimizerConfig(num_candidates=128, leadership_candidates=32,
                                               steps_per_round=16, num_rounds=2)
                res = analyzer.GoalOptimizer(config=cfg, **dev).optimize(lm.cluster_model(req))
                ex = executor.Executor(admin, catalog=lm.last_catalog)
                fixed["result"] = dataclasses.asdict(ex.execute_proposals(
                    res.proposals, executor.ExecutionOptions(progress_check_interval_s=1.0),
                    removed_brokers=set(broker_ids)))
                fixed["proposals"] = [(p.partition, p.new_replicas, p.new_leader) for p in res.proposals]
                return True

        notifier = detector.SelfHealingNotifier(
            self_healing={detector.AnomalyType.BROKER_FAILURE: True},
            broker_failure_alert_threshold_ms=0, broker_failure_self_healing_threshold_ms=0)
        det = detector.AnomalyDetector(notifier, Actions())
        det.register_detector(detector.BrokerFailureDetector(meta.topology).detect)
        recs = det.run_once()
        after = meta.topology()
        tops.append(dict(status=[r.status for r in recs], **fixed, generation=after.generation,
                         partitions=[(p.topic, p.partition, p.leader, p.replicas) for p in after.partitions]))
    assert tops[0]["status"] == ["FIX_STARTED"]
    assert tops[0]["proposals"]
    assert tops[1] == tops[0]
    assert all(4 not in p[3] for p in tops[1]["partitions"])
