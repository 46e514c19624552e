"""Every piece BENCHMARK.json names is found by its name, and the file
keeps to the benchmark's contract."""

import json
import re

import pytest

from harness import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = cells.load_cell(cell)
    assert c.config["goals"] and c.traffic["entry"] in ("optimize", "simulate")
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m["name"]))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((cells.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200


def test_names_units_and_cross_references():
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(NAME.match(x["name"]) for x in every)
    cellnames = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cellnames)) <= cellnames
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        # a metric reported only where the metric it moves is
        assert set(m.get("workloads", cellnames)) <= set(e2e[m["moves"]].get("workloads",
                                                                             cellnames))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (cells.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
