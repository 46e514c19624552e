"""Shared set-up of the benchmark's CPU tests: the harness, the reference
and the program on the path, the `cuda` marker, and cells cut to a size a
test run holds (the cell's own chain, constraint, traffic kinds and
checks; fewer brokers, partitions and candidates)."""

import dataclasses
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

SMALL_SPEC = dict(num_brokers=24, num_racks=4, num_topics=8, num_partitions=240)
SMALL_SEARCH = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3,
                    seed=1)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


def small_cell(name: str, ring: int = 2, sample: int = 2):
    from harness import cells

    config, traffic = name.split(".", 1)
    c = cells.load_cell(name, entry=dict(config=config, traffic=traffic, chips=1))
    cfg = dict(c.config, spec=dict(c.config["spec"], **SMALL_SPEC), search=SMALL_SEARCH)
    tr = dict(c.traffic, ring=ring, sample=sample)
    if "scenarios" in tr:
        tr["scenarios"] = [dict(k, count=2) for k in tr["scenarios"]]
    return dataclasses.replace(c, config=cfg, traffic=tr)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return "cuda"
