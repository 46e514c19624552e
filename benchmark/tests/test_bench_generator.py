"""The generator and the traffic draws repeat for one seed."""

import numpy as np
import pytest

from conftest import small_cell
from harness import generator, traffic

SEEDS = (0, 7, 2**31 + 12345)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_repeats(seed):
    spec = small_cell("kafka_200k.rebalance").config["spec"]
    (a, da), (b, db) = generator.generate(spec, seed), generator.generate(spec, seed)
    assert da == db and _same(a, b)
    assert not _same(a, generator.generate(spec, seed + 1)[0])


def test_placement_is_valid_and_skewed():
    spec = dict(small_cell("kafka_200k.rebalance").config["spec"], num_partitions=2000)
    cols, dims = generator.generate(spec, 3)
    key = cols["replica_partition"].astype(np.int64) * dims["num_brokers"] + cols["replica_broker"]
    assert np.unique(key).size == key.size
    leaders = np.bincount(cols["replica_partition"], cols["replica_is_leader"])
    assert (leaders == 1).all()
    counts = np.bincount(cols["replica_broker"], minlength=dims["num_brokers"])
    assert counts[: dims["num_brokers"] // 4].mean() > counts[-dims["num_brokers"] // 4:].mean()


@pytest.mark.parametrize("cell", ["kafka_200k.rebalance", "kafka_200k.decommission",
                                  "kafka_200k.whatif", "kafka_200k_jbod.rebalance_ring"])
def test_traffic_repeats(cell):
    c = small_cell(cell, ring=3)
    a = traffic.build(c.config, c.traffic, 2**31 + 99)
    b = traffic.build(c.config, c.traffic, 2**31 + 99)
    assert _same(a.cols, b.cols) and len(a.ring) == 3
    for x, y in zip(a.ring, b.ring):
        assert _same(x, y) if isinstance(x, dict) else x == y


def test_generations_redraw_loads_only():
    c = small_cell("kafka_200k.rebalance", ring=2)
    t = traffic.build(c.config, c.traffic, 5)
    g0, g1 = t.ring
    assert np.array_equal(g0["replica_broker"], t.cols["replica_broker"])
    assert not np.array_equal(g0["replica_load_leader"], g1["replica_load_leader"])


def test_decommission_kills_one_percent():
    c = small_cell("kafka_200k.decommission", ring=2)
    c.config["spec"]["num_brokers"] = 200
    t = traffic.build(c.config, c.traffic, 5)
    dead = [np.nonzero(~g["broker_alive"])[0] for g in t.ring]
    assert [d.size for d in dead] == [2, 2] and not np.array_equal(dead[0], dead[1])
    g = t.ring[0]
    assert (g["replica_offline"] == ~g["broker_alive"][g["replica_broker"]]).all()


@pytest.mark.parametrize("cell", ["kafka_200k_jbod.rebalance_ring", "kafka_200k.whatif"])
def test_base_seed_gives_every_seed_the_same_requests_in_its_own_order(cell):
    c = small_cell(cell, ring=6)
    a = traffic.build(c.config, c.traffic, 2**31 + 1)
    b = traffic.build(c.config, c.traffic, 2**31 + 2)
    assert _same(a.cols, b.cols)

    def key(x):
        return x["replica_load_leader"].tobytes() if isinstance(x, dict) else repr(x)

    assert sorted(map(key, a.ring)) == sorted(map(key, b.ring))
    assert list(map(key, a.ring)) != list(map(key, b.ring))
