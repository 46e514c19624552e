#!/usr/bin/env python3
"""Time the port's GoalOptimizer.optimize on the north star, for one checkout, on one GPU.

    python3 scripts/time_optimize.py [DIR]

DIR is a checkout of the repository (default: this one), for example an
earlier commit unpacked with `git archive`.  The script builds DIR's CUDA
kernels, makes the north-star cluster and search of chip_smoke.py (same
spec and seed) and calls DIR's `GoalOptimizer.optimize` on it: a first call
(the engine built, its graphs captured), three repeated calls on the same
state, and a warm start from the last result.  For each call it prints the
host wall to `torch.cuda.synchronize()`, the timing record's
`host_dispatch_s`, `device_s`, `host_extract_s` and `engine_build_s`, the
graphs captured (with warm-up, capture and instantiate seconds on the first
call), the rounds and proposals, and the device dispatches and syncs that
`common/dispatch.py` counted.  It prints the card's `nvidia-smi` name and
power limit, then one JSON line.  It needs a CUDA device, nvcc and
nvidia-smi.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _smoke():
    """This checkout's chip_smoke.py, loaded as a module for its spec."""
    spec = importlib.util.spec_from_file_location("chip_smoke_spec", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(tree: str = ".") -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_optimize: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(tree).resolve()
    if not (root / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"time_optimize: {root} is not a checkout of the repository", file=sys.stderr)
        return 2
    cs = _smoke()
    sys.path.insert(0, str(root))
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter
    from cruise_control_tpu_torch.kernels import _build
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    cfg = OptimizerConfig(**cs.SEARCH)
    state = random_cluster_fast(RandomClusterSpec(**cs.NORTH_STAR_SPEC), seed=42, device="cuda")
    opt = GoalOptimizer(config=cfg, device="cuda")
    calls = []
    res = None
    for label in ("first", "repeat", "repeat", "repeat", "warm_start"):
        warm = None
        if label == "warm_start":
            warm = tuple(getattr(res.state_after, f) for f in cs.PLACEMENT)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with dispatch_meter() as m:
            res = opt.optimize(state, initial_placement=warm)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        t = next(h for h in res.history if h.get("timing"))
        engine = next(iter(opt._engines.values()))
        caps = engine.graph_stats.get("captures", []) if label == "first" else []
        calls.append(dict(
            call=label, wall_s=wall, host_dispatch_s=t.get("host_dispatch_s"),
            device_s=t.get("device_s"), host_extract_s=t.get("host_extract_s"),
            engine_build_s=t.get("engine_build_s"), captured=t.get("captured"),
            captures=[{k: c[k] for k in ("graphs", "warmup_s", "capture_s", "instantiate_s")}
                      for c in caps],
            rounds=len([h for h in res.history if "round" in h]), proposals=len(res.proposals),
            objective_after=res.objective_after, dispatches=dict(m.counts)))
    print(json.dumps({"tree": str(root), "calls": calls}), flush=True)
    for engine in opt._engines.values():
        engine.release()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
