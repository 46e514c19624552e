"""The PyTorch port stands alone: no JAX, nothing of cruise_control_tpu.

Importing every module of the port in a fresh interpreter must load
neither `jax` nor any `cruise_control_tpu.` module, and an AST scan of the
package and of chip_smoke.py must find no import of either.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import cruise_control_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cruise_control_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cruise_control_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(cruise_control_tpu_torch.__path__, "cruise_control_tpu_torch.")
    )


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_in_subprocess():
    mods = _modules()
    assert "cruise_control_tpu_torch.analyzer.optimizer" in mods
    # the device scheduler, the supervisor and the stdlib modules they
    # need, copied in
    for m in ("fleet.scheduler", "detector.anomalies", "common.blackbox", "common.device_watchdog",
              "common.sensors", "common.trace", "common.exposition", "testing.faults",
              # the monitor and what it brings: the reporter, the native
              # serde and the synthetic workload
              "monitor.load_monitor", "monitor.task_runner", "monitor.reporter_sampler",
              "reporter.reporter", "native", "testing.synthetic",
              # the executor, the fleet's leases and the detectors
              "executor.tasks", "executor.strategy", "executor.admin", "executor.throttle",
              "executor.planner", "executor.journal", "executor.executor", "fleet.leases",
              "detector.notifier", "detector.detector", "detector.detectors",
              # the Kafka wire path, its fake cluster, the SLOs and the ledger
              "kafka", "kafka.codec", "kafka.protocol", "kafka.sasl", "kafka.client",
              "kafka.records", "kafka.transport", "kafka.admin", "kafka.sample_store",
              "testing.fake_kafka", "common.slo", "analyzer.ledger",
              # configuration, the REST service, the fleet manager and the CLI
              "config.config_def", "config.endpoints", "config.app_config", "parallel.ft",
              "service.progress", "service.purgatory", "service.tasks", "service.schemas",
              "service.security", "service.parameters", "service.facade", "fleet.manager",
              "service.server", "service.main", "client.cccli"):
        assert f"cruise_control_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            names += [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    return names


def test_ast_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): [n for n in _imports(f) if _forbidden(n)] for f in files}
    assert {k: v for k, v in bad.items() if v} == {}
