"""The port's shape buckets and builder against the JAX package's.

- `ShapeBucketPolicy`: the same series, validation and next-bucket shape.
- `pad_state`, `prewarm_state`, `ClusterModelBuilder(bucket_policy=)` and
  `build_state_columnar`: the same arrays, array for array, and the same
  catalog; the columnar build is fed the JAX testing module's
  `synthetic_topology(...).columns()`, as the JAX monitor feeds it.
- Bucket padding is invisible in the port: on the `small`, `dead-broker`
  and `jbod` fixtures with the chains of tests/test_bucketing.py, the
  exact and the padded build give the same objective, violations,
  balancedness and proposals, bit for bit, and the padded run's
  placements are the JAX package's padded run's.
- At the end, tests/test_bucketing.py's config and facade tests (:347,
  :374, :401), on the port's config and facade.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_DEFAULT
from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.objective import GoalChain as JChain
from cruise_control_tpu.models import builder as jb
from cruise_control_tpu.models.state import ShapeBucketPolicy as JPolicy
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu.testing.synthetic import synthetic_topology
from cruise_control_tpu_torch import models as tm
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_DEFAULT
from cruise_control_tpu_torch.analyzer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.objective import GoalChain as TChain
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from types import SimpleNamespace

#: tests/test_bucketing.py's FAST and POLICY
FAST = dict(num_candidates=128, leadership_candidates=32, swap_candidates=16,
            steps_per_round=8, num_rounds=2, max_extra_rounds=2, seed=3)
POLICY = dict(growth=1.25, floor=8)
#: tests/test_bucketing.py's chains of the non-headline fixtures
JBOD_CHAIN = ["OfflineReplicaGoal", "RackAwareGoal", "DiskCapacityGoal",
              "IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal",
              "DiskUsageDistributionGoal"]
COMPACT_CHAIN = ["OfflineReplicaGoal", "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
                 "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
                 "NetworkInboundUsageDistributionGoal"]
FIXTURES = {"small": ("small_cluster", None), "dead-broker": ("dead_broker_cluster", COMPACT_CHAIN),
            "jbod": ("jbod_cluster", JBOD_CHAIN)}


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _same_state(t_state, j_state):
    assert dataclasses.asdict(t_state.shape) == dataclasses.asdict(j_state.shape)
    for f in STATE_FIELDS:
        a, b = getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _chains(names):
    if names is None:
        return J_DEFAULT, T_DEFAULT
    return JChain.from_names(names), TChain.from_names(names)


def _proposal_keys(proposals):
    return sorted((p.partition, p.topic, p.old_leader, p.new_leader, p.old_replicas,
                   p.new_replicas, p.disk_moves) for p in proposals)


# ----------------------------------------------------------------------
# the policy
# ----------------------------------------------------------------------


def test_bucket_series_matches_jax_and_is_stable():
    tp, jp = tm.ShapeBucketPolicy(**POLICY), JPolicy(**POLICY)
    prev = 0
    for n in range(1, 4000, 7):
        b = tp.bucket(n)
        assert b == jp.bucket(n)
        assert b >= n and b >= prev and tp.bucket(b) == b
        prev = b
    assert tp.bucket(tp.bucket(100) - 1) == tp.bucket(100)
    assert tm.ShapeBucketPolicy(enabled=False).bucket(37) == 37
    # the north star at the default policy
    assert [tm.DEFAULT_BUCKET_POLICY.bucket(n) for n in (500_245, 2_600, 200_000, 200, 52)] == \
        [JPolicy().bucket(n) for n in (500_245, 2_600, 200_000, 200, 52)]


@pytest.mark.parametrize("kw", [dict(growth=1.0), dict(growth=0.5), dict(floor=0)])
def test_bucket_policy_validates(kw):
    with pytest.raises(ValueError):
        tm.ShapeBucketPolicy(**kw)


@pytest.mark.parametrize("name", ["small_cluster", "jbod_cluster"])
def test_bucket_and_next_bucket_shapes_match_jax(name):
    js = getattr(jf, name)()
    ts = _port(js)
    tp, jp = tm.ShapeBucketPolicy(**POLICY), JPolicy(**POLICY)
    for t_fn, j_fn in ((tp.bucket_shape, jp.bucket_shape), (tp.next_bucket_shape, jp.next_bucket_shape)):
        assert dataclasses.asdict(t_fn(ts.shape)) == dataclasses.asdict(j_fn(js.shape))
    cur, nxt = tp.bucket_shape(ts.shape), tp.next_bucket_shape(ts.shape)
    assert nxt.num_replicas > cur.num_replicas and nxt.num_partitions > cur.num_partitions
    assert nxt.num_brokers == cur.num_brokers
    assert tm.ShapeBucketPolicy(enabled=False).bucket_shape(ts.shape) == ts.shape


# ----------------------------------------------------------------------
# the builder, array for array
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["small_cluster", "dead_broker_cluster", "jbod_cluster",
                                  "rack_violated_cluster"])
@pytest.mark.parametrize("to", ["bucket", "next_bucket"])
def test_pad_state_matches_jax(name, to):
    js = getattr(jf, name)()
    jp = JPolicy(**POLICY)
    shape = getattr(jp, f"{to}_shape")(js.shape)
    j_pad = jb.pad_state(js, shape)
    t_pad = tm.pad_state(_port(js), tm.ClusterShape(**dataclasses.asdict(shape)))
    _same_state(t_pad, j_pad)
    assert tm.validate(t_pad) == []
    ts = _port(js)
    assert tm.pad_state(ts, ts.shape) is ts


def test_pad_state_refuses_to_shrink():
    ts = _port(jf.small_cluster())
    smaller = dataclasses.replace(ts.shape, num_brokers=ts.shape.B - 1)
    with pytest.raises(ValueError, match="cannot shrink"):
        tm.pad_state(ts, smaller)


def test_pad_state_widens_the_disk_axis():
    js = jf.small_cluster()
    shape = dataclasses.replace(JPolicy(**POLICY).bucket_shape(js.shape), max_disks_per_broker=3)
    _same_state(tm.pad_state(_port(js), tm.ClusterShape(**dataclasses.asdict(shape))),
                jb.pad_state(js, shape))


@pytest.mark.parametrize("max_rf", [1, 3, 50])
def test_prewarm_state_matches_jax(max_rf):
    shape = JPolicy(**POLICY).bucket_shape(jf.jbod_cluster().shape)
    t = tm.prewarm_state(tm.ClusterShape(**dataclasses.asdict(shape)), max_rf=max_rf, device="cpu")
    _same_state(t, jb.prewarm_state(shape, max_rf=max_rf))
    assert tm.validate(t) == []


def _specs(mod):
    """The same brokers and partitions as specs of `mod`'s builder (a JBOD
    cluster with a dead broker, a bad disk, shared hosts and two topics)."""
    brokers = [
        mod.BrokerSpec(0, rack="r0", host="hA", disk_capacities=[500.0, 700.0]),
        mod.BrokerSpec(2, rack="r1", capacity=np.array([80.0, 9e4, 9e4, 1.0], np.float32),
                       disk_capacities=[400.0, 400.0, 400.0], bad_disks=[1]),
        mod.BrokerSpec(1, rack="r0", host="hA", alive=False),
        mod.BrokerSpec(3, rack="r2", new_broker=True),
    ]
    rng = np.random.default_rng(11)
    parts = []
    for topic, n in (("zeta", 5), ("alpha", 4)):
        for p in range(n):
            reps = [int(x) for x in rng.choice(4, size=2 + p % 2, replace=False)]
            disks = [int(rng.integers(0, 2)) if b in (0, 2) else 0 for b in reps]
            ll = rng.uniform(1.0, 50.0, 4).astype(np.float32)
            parts.append(mod.PartitionSpec(topic, p, reps, ll, replica_disks=disks, leader_pos=p % 2,
                                           follower_load=ll * 0.5 if p == 3 else None))
    return brokers, parts


@pytest.mark.parametrize("policy", [None, POLICY])
@pytest.mark.parametrize("capacity", [None, 40])
def test_cluster_model_builder_matches_jax(policy, capacity):
    built = []
    for mod, pol in ((jb, JPolicy), (tm, tm.ShapeBucketPolicy)):
        b = mod.ClusterModelBuilder(replica_capacity=capacity,
                                    bucket_policy=pol(**policy) if policy else None)
        brokers, parts = _specs(mod)
        for x in brokers:
            b.add_broker(x)
        for x in parts:
            b.add_partition(x)
        built.append((b.build(**({} if mod is jb else {"device": "cpu"})), b.catalog))
    (j_state, j_cat), (t_state, t_cat) = built
    _same_state(t_state, j_state)
    assert dataclasses.asdict(t_cat) == dataclasses.asdict(j_cat)
    assert tm.validate(t_state) == []
    if policy:
        assert t_state.shape.B == tm.ShapeBucketPolicy(**POLICY).bucket(4)
        assert int(t_state.broker_valid.sum()) == 4


@pytest.mark.parametrize("policy", [None, POLICY])
@pytest.mark.parametrize("dead", [(), (4,)])
def test_build_state_columnar_matches_jax(policy, dead):
    topo = synthetic_topology(num_brokers=7, topics={"tb": 9, "ta": 6, "tc": 3}, replication=3,
                              dead_brokers=dead, seed=4)
    cols = topo.columns()
    P = len(cols.part_num)
    rng = np.random.default_rng(2)
    ll = rng.uniform(0.5, 30.0, (P, 4)).astype(np.float32)
    fl = (ll * np.float32(0.4)).astype(np.float32)
    out = []
    for mod, pol in ((jb, JPolicy), (tm, tm.ShapeBucketPolicy)):
        brokers = [mod.BrokerSpec(n.broker_id, rack=n.rack, host=n.host, alive=n.alive,
                                  disk_capacities=[600.0, 900.0] if n.broker_id % 2 else None)
                   for n in topo.brokers]
        kw = dict(bucket_policy=pol(**policy) if policy else None)
        if mod is tm:
            kw["device"] = "cpu"
        out.append(mod.build_state_columnar(brokers, cols, ll, fl, **kw))
    (j_state, j_cat), (t_state, t_cat) = out
    _same_state(t_state, j_state)
    assert dataclasses.asdict(t_cat) == dataclasses.asdict(j_cat)
    assert tm.validate(t_state) == []


def test_build_state_columnar_refuses_a_short_capacity():
    topo = synthetic_topology(num_brokers=4, topics={"t": 5}, seed=1)
    cols = topo.columns()
    brokers = [tm.BrokerSpec(n.broker_id, rack=n.rack) for n in topo.brokers]
    loads = np.ones((5, 4), np.float32)
    with pytest.raises(ValueError, match="replica_capacity"):
        tm.build_state_columnar(brokers, cols, loads, loads, replica_capacity=3, device="cpu")


def test_catalog_topic_id_is_dict_backed():
    cat = tm.ClusterCatalog(topics=("a", "b", "c"), partitions=(("a", 0),))
    assert [cat.topic_id(t) for t in ("a", "b", "c")] == [0, 1, 2]
    with pytest.raises(KeyError):
        cat.topic_id("nope")
    cat2 = dataclasses.replace(cat, topics=("x", "a"))
    assert cat2.topic_id("a") == 1
    assert cat.partition_key(0) == ("a", 0)
    assert cat.topic_names_by_id() == {0: "a", 1: "b", 2: "c"}


# ----------------------------------------------------------------------
# padding is invisible to the optimizer
# ----------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(FIXTURES), ids=list(FIXTURES))
def padded_runs(request):
    name, chain_names = FIXTURES[request.param]
    j_chain, t_chain = _chains(chain_names)
    js = getattr(jf, name)()
    jp = jb.pad_state(js, JPolicy(**POLICY).bucket_shape(js.shape))
    exact = _port(js)
    padded = tm.pad_state(exact, tm.ShapeBucketPolicy(**POLICY).bucket_shape(exact.shape))
    t_exact = TOptimizer(chain=t_chain, config=TConfig(**FAST), device="cpu").optimize(exact)
    t_pad = TOptimizer(chain=t_chain, config=TConfig(**FAST), device="cpu").optimize(padded)
    j_pad = JOptimizer(chain=j_chain, config=JConfig(**FAST)).optimize(jp)
    return t_chain, exact, padded, t_exact, t_pad, j_pad


def test_exact_vs_bucketed_parity(padded_runs):
    """Bucket padding is invisible: the same objective, per-goal
    violations, balancedness and proposal set, bit for bit."""
    chain, exact, padded, r1, r2, _ = padded_runs
    assert padded.shape != exact.shape
    assert tm.validate(padded) == []
    o1, v1, s1 = chain.evaluate(exact)
    o2, v2, s2 = chain.evaluate(padded)
    assert float(o1) == float(o2)
    assert np.array_equal(v1.numpy(), v2.numpy())
    assert np.array_equal(s1.numpy(), s2.numpy())
    assert r1.objective_after == r2.objective_after
    assert np.array_equal(r1.violations_after, r2.violations_after)
    assert r1.balancedness_after == r2.balancedness_after
    assert _proposal_keys(r1.proposals) == _proposal_keys(r2.proposals)
    n = exact.shape.R
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(getattr(r1.state_after, f).numpy(), getattr(r2.state_after, f).numpy()[:n])


def test_bucketed_run_matches_jax(padded_runs):
    """The port's padded run against the JAX package's padded run: the same
    placements, rounds and proposals."""
    _, _, _, _, t_pad, j_pad = padded_runs
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        np.testing.assert_array_equal(getattr(t_pad.state_after, f).numpy(),
                                      np.asarray(getattr(j_pad.state_after, f)), err_msg=f)
    assert _proposal_keys(t_pad.proposals) == _proposal_keys(j_pad.proposals)
    rounds = lambda res: [(h["accepted"], h.get("early_stop"), h.get("extra"))  # noqa: E731
                          for h in res.history if "round" in h]
    assert rounds(t_pad) == rounds(j_pad)
    timing = next(h for h in t_pad.history if h.get("timing"))
    assert timing["bucket"]["B"] == t_pad.state_after.shape.B


# ------------------- the config and the facade (tests/test_bucketing.py :347-430)


def test_config_shape_bucket_keys_wire_through():
    from cruise_control_tpu_torch.config import CruiseControlConfig

    cfg = CruiseControlConfig({
        "tpu.shape.bucket.growth": 1.5,
        "tpu.shape.bucket.floor": 16,
        "tpu.engine.cache.size": 3,
    })
    pol = cfg.shape_bucket_policy()
    assert pol.enabled and pol.growth == 1.5 and pol.floor == 16
    assert cfg.get("tpu.engine.cache.size") == 3
    off = CruiseControlConfig({"tpu.shape.bucket.enabled": "false"})
    assert off.shape_bucket_policy().bucket(37) == 37


def test_proposal_cache_expiry_uses_monotonic_clock(monkeypatch):
    """A backwards wall-clock step must not make cached proposals
    immortal: expiry is judged on time.monotonic()."""
    import time as time_mod

    from cruise_control_tpu_torch.service.facade import CruiseControl, _CachedResult

    gen = object()
    dummy = SimpleNamespace(
        _cache_lock=__import__("threading").Lock(),
        _cache=_CachedResult(
            result="RESULT",
            computed_ms=int(time_mod.time() * 1000) + 10**12,  # wall far future
            computed_mono=time_mod.monotonic() - 100.0,  # monotonic: 100s old
            model_generation=gen,
        ),
        _proposal_expiration_ms=50_000,
        monitor=SimpleNamespace(model_generation=lambda: gen),
    )
    # 100s old > 50s expiry -> stale, even though wall clock says "future"
    assert CruiseControl._valid_cache(dummy) is None
    dummy._cache = _CachedResult(
        "RESULT", 0, time_mod.monotonic(), gen
    )
    assert CruiseControl._valid_cache(dummy) == "RESULT"


def test_strict_destination_mask_rejects_padding_brokers():
    """add_broker aimed at a padding-row id must fail loudly, not silently
    degrade into an unconstrained rebalance."""
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.state import ShapeBucketPolicy
    from cruise_control_tpu_torch.testing.fixtures import small_cluster

    base = small_cluster("cpu")
    state = pad_state(base, ShapeBucketPolicy(**POLICY).bucket_shape(base.shape))
    assert state.shape.B > 3  # padded broker axis
    cc = SimpleNamespace(
        config=SimpleNamespace(get=lambda k: ""),
        monitor=SimpleNamespace(last_catalog=None),
    )
    from cruise_control_tpu_torch.service.facade import CruiseControl

    with pytest.raises(ValueError, match="not in the cluster model"):
        CruiseControl._build_options(cc, state, destination_broker_ids=[state.shape.B - 1])
    opts = CruiseControl._build_options(cc, state, destination_broker_ids=[1])
    assert opts.requested_destination_brokers is not None
