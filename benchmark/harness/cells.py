"""Finding a cell's pieces by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration
and traffic mix, and each metric; the files are found from those names:

  benchmark/configs/<config>.json    the deployment: spec, goal chain,
                                     constraint, search config, guarantees
  benchmark/traffic/<traffic>.json   the traffic mix's parameters
  benchmark/limits/<cell>.json       the limit of each number compared
  benchmark/metrics/<metric>.py      the reader of one metric

so a later cell or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: the BENCHMARK.json metric entries this cell reports, by kind
    end_to_end: tuple
    per_layer: tuple


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT, entry: dict | None = None) -> Cell:
    """The cell `name` of the root's BENCHMARK.json with its files, or,
    for a cell the file does not list yet, `entry` ({"config", "traffic",
    "chips"}) with the files of those names."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    w = cells.get(name, entry)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    config = json.loads((BENCH_DIR / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    e2e = tuple(m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"])
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _reports(m, name, names))
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
