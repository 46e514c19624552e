"""The round prep's grouping and member table against the JAX package, on
the CPU (the kernels' plain versions; the kernels themselves are held
against these on the card in tests/test_torch_kernels.py).

- `group_placement` (the broker/valid entry the engine calls) equals
  `group_by_broker` on `placement_segments` of the same placement, and the
  engine's plan grouping equals the reference's `_plan_build` count, start
  and order: exact.
- The member table the refresh counts partition x rack cells from holds
  every valid row exactly once, in its partition's row, and the counts it
  gives equal `refresh_plain`'s part_rack_count: exact, on the fixtures and
  on random clusters with mixed replication factors and padding rows.
- `compute_aggregates` with the member table passed in equals the
  reference's aggregates and host load: exact (as tests/test_torch_model.py
  holds without it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.models.aggregates import compute_aggregates as j_aggregates
from cruise_control_tpu.models.aggregates import host_load as j_host_load
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels.group import group_by_broker, group_placement, placement_segments
from cruise_control_tpu_torch.kernels.refresh import refresh_plain
from cruise_control_tpu_torch.models import compute_aggregates, host_load
from cruise_control_tpu_torch.models.aggregates import empty_aggregates
from cruise_control_tpu_torch.models.state import STATE_FIELDS, replica_members
from cruise_control_tpu_torch.testing import fixtures as tf

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FIXTURES = ["small_cluster", "rack_violated_cluster", "dead_broker_cluster", "jbod_cluster", "random"]
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


def _jax_state(name):
    if name == "random":
        return jf.random_cluster(jf.RandomClusterSpec(num_brokers=12, num_partitions=200, skew=1.0), seed=3)
    return getattr(jf, name)()


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _equal_groupings(a, b):
    for f in ("count", "start", "order"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=f)


@pytest.mark.parametrize("name", FIXTURES)
def test_group_placement_matches_seg_entry_and_jax_plan(name):
    """On a placement a few greedy steps from the input: the broker/valid
    entry equals the seg entry, and the engine's plan grouping equals the
    reference's `_plan_build` count, start and order."""
    js = _jax_state(name)
    te = TEngine(_port(js), T_CHAIN, config=TConfig(**FAST))
    carry = te.init_carry(Key.from_seed(2))
    for _ in range(4):
        carry, _ = te.step(carry, 0.0)
    st_ = te.statics.state
    B = te.shape.B
    kernels.reset_launches()
    by_placement = group_placement(carry.replica_broker, st_.replica_valid, B)
    by_seg = group_by_broker(placement_segments(carry.replica_broker, st_.replica_valid, B), B)
    assert kernels.LAUNCHES["group_by_broker"] == 0  # the CPU takes the plain version
    _equal_groupings(by_placement, by_seg)

    je = JEngine(js, J_CHAIN, config=JConfig(**FAST))
    jc = je._jit_init(je.statics, jax.random.PRNGKey(2))
    jc = dataclasses.replace(jc, **{f: jnp.asarray(getattr(carry, f).numpy()) for f in PLACEMENT})
    want = je._plan_build(je.statics, jc, jnp.zeros(B, jnp.float32), jnp.float32(0.0))
    plan = te.plan(carry)
    for f in ("count", "start", "order"):
        np.testing.assert_array_equal(getattr(plan, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(by_placement, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_placement_segments_rule():
    broker = torch.tensor([0, 3, -1, 4, 7, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, True, False])
    np.testing.assert_array_equal(placement_segments(broker, valid, 4).numpy(), [0, 3, 4, 4, 4, 4])


def test_group_plain_counts_out_of_range_ids_as_sentinel():
    seg = torch.tensor([2, -3, 0, 9, 3, 1, 2], dtype=torch.int32)
    got = group_by_broker(seg, 3)
    want = group_by_broker(torch.tensor([2, 3, 0, 3, 3, 1, 2], dtype=torch.int32), 3)
    _equal_groupings(got, want)


def _check_member_table(ts):
    """The member table of `ts` holds every valid row once, in its
    partition's row, and its partition x rack counts are refresh_plain's."""
    s = ts.shape
    table = ts.members.numpy()
    valid = ts.replica_valid.numpy()
    part = ts.replica_partition.numpy()
    held = table[table < s.R]
    np.testing.assert_array_equal(np.sort(held), np.nonzero(valid)[0])
    rows, _ = np.nonzero(table < s.R)
    np.testing.assert_array_equal(part[table[table < s.R]], rows)
    # the kernel's count: the racks of each partition's members
    rack = ts.broker_rack.numpy()[ts.replica_broker.numpy()]
    counts = np.zeros((s.P, s.num_racks), np.int32)
    for p, m in zip(rows, held):
        counts[p, rack[m]] += 1
    out = refresh_plain(ts, ts.replica_broker, ts.replica_is_leader, ts.replica_disk,
                        empty_aggregates(ts), None)
    np.testing.assert_array_equal(counts, out["part_rack_count"].numpy())
    assert int(out["part_rack_count"].sum()) == held.size == int(valid.sum())


@pytest.mark.parametrize("name", FIXTURES)
def test_member_table_holds_every_valid_row_once(name):
    _check_member_table(_port(_jax_state(name)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), brokers=st.integers(3, 12), parts=st.integers(1, 60),
       min_rf=st.integers(1, 3), extra_rf=st.integers(0, 2), pad=st.integers(0, 17),
       disks=st.integers(1, 3))
def test_member_table_random_clusters(seed, brokers, parts, min_rf, extra_rf, pad, disks):
    spec = tf.RandomClusterSpec(num_brokers=brokers, num_racks=min(brokers, 4), num_topics=5,
                                num_partitions=parts, min_replication=min_rf,
                                max_replication=min_rf + extra_rf, disks_per_broker=disks)
    plain = tf.random_cluster(spec, seed=seed, device="cpu")
    n_valid = int(plain.replica_valid.sum())
    spec = dataclasses.replace(spec, replica_capacity=n_valid + pad)
    ts = tf.random_cluster(spec, seed=seed, device="cpu")
    assert ts.shape.R == n_valid + pad
    _check_member_table(ts)


def test_state_members_built_once():
    """`ClusterState.members` is the checked table of the state's host
    arrays, built on first use and kept for the state."""
    ts = _port(jf.jbod_cluster())
    host = [t.numpy() for t in (ts.replica_valid, ts.replica_partition, ts.replica_pos)]
    assert ts.members is ts.members
    np.testing.assert_array_equal(ts.members.numpy(), replica_members(*host, ts.shape))
    moved = ts.with_replicas_moved(torch.tensor([0]), torch.tensor([1]))
    np.testing.assert_array_equal(moved.members.numpy(), ts.members.numpy())


def test_member_table_rejects_colliding_positions():
    ts = _port(jf.small_cluster())
    pos = ts.replica_pos.numpy().copy()
    part = ts.replica_partition.numpy()
    valid = ts.replica_valid.numpy()
    p0 = part[np.nonzero(valid)[0][0]]
    rows = np.nonzero(valid & (part == p0))[0]
    assert rows.size >= 2
    pos[rows] = 0  # two replicas of one partition at one position
    with pytest.raises(ValueError, match="positions collide"):
        replica_members(valid, part, pos, ts.shape)


@pytest.mark.parametrize("name", FIXTURES)
def test_compute_aggregates_with_member_table_matches_jax(name):
    js = _jax_state(name)
    ts = _port(js)
    ja, ta = j_aggregates(js), compute_aggregates(ts, ts.members)
    for f in dataclasses.fields(ja):
        np.testing.assert_array_equal(getattr(ta, f.name).numpy(), np.asarray(getattr(ja, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(host_load(ts, ta).numpy(), np.asarray(j_host_load(js, ja)))
