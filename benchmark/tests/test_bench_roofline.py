"""The rooflines' byte counts are the shape arithmetic."""

import pytest

from harness import roofline

KAFKA = dict(num_replicas=500245, num_partitions=200000, num_brokers=130,
             max_disks_per_broker=1, num_topics=200, num_hosts=130, num_racks=26)
SEARCH = dict(num_candidates=16384, leadership_candidates=4096, steps_per_round=64, num_rounds=8)


def test_split():
    assert roofline.split(SEARCH) == (11776, 512, 4096)
    assert roofline.split(dict(num_candidates=100, leadership_candidates=90)) == (5, 5, 90)


def test_distinct_draws():
    assert roofline.distinct(1, 5) == 1
    assert roofline.distinct(2, 2) == pytest.approx(1.5)    # 2 (1 - 1/4)
    assert roofline.distinct(10**6, 10) == pytest.approx(10, rel=1e-4)
    assert roofline.distinct(130, 32768) == pytest.approx(130)


def test_candidates_bytes_kafka_200k():
    # rows: 20,992 draws over 500,245; partitions: 16,896 over 200,000, each
    # with R/P members; cells: 33,792 over 200,000 x 26; brokers and hosts:
    # all 130, each with its one logdir row; then the CDF, draws and globals, and the outputs
    R, P = 500245, 200000

    def hit(n, draws):
        return n * (1 - (1 - 1 / n) ** draws)

    rows, parts = hit(R, 20992), hit(P, 16896)
    want = (59 * rows + 5 * (parts * R / P - rows) + 4 * parts * R / P
            + 4 * hit(P * 26, 33792) + (64 + 9) * 130 + 33 * 130
            + 4 * 130 + 4 * 11776 + 4 * 222 + 22 * 16384 + 53 * 12800 + 64 * 4096)
    assert roofline.candidates_bytes(KAFKA, SEARCH) == pytest.approx(want, rel=1e-9)
    assert 2.95e6 < want < 3.0e6


def test_candidates_bytes_jbod_counts_the_logdirs():
    # every one of the 130 brokers drawn, each with 2 logdir rows of 9 B
    nb = roofline.candidates_bytes(dict(KAFKA, max_disks_per_broker=2), SEARCH)
    one = roofline.candidates_bytes(KAFKA, SEARCH)
    assert nb - one == pytest.approx(130 * 9, rel=1e-9)


def test_apply_bytes():
    assert roofline.apply_moves_bytes(SEARCH, 0) == 16896
    assert roofline.apply_moves_bytes(SEARCH, 100) == 16896 + 250 * 100


def test_share():
    assert roofline.share(3.35e9, 2.0, 2) == pytest.approx(0.1)
    assert roofline.share(1.0, 0.0, 0) is None


def test_configs_fit_the_counts():
    import json

    from harness import cells

    for path in sorted((cells.BENCH_DIR / "configs").glob("*.json")):
        assert roofline.split(json.loads(path.read_text())["search"]) == (11776, 512, 4096)
