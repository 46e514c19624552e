#!/usr/bin/env python3
"""Time the port's round-prep kernels of one checkout on one GPU.

    python3 scripts/time_round_prep.py [DIR]

DIR is a checkout of the repository (default: this one), for example an
earlier commit unpacked with `git archive`.  The script builds DIR's CUDA
kernels, makes the north-star cluster of chip_smoke.py (same spec and
seed) and times DIR's `Engine.refresh` on its initial placement: the
grouping by broker (`group_by_broker`) and every aggregate
(`refresh_aggregates`), as the engine's round prep calls them.  The
timing is this checkout's chip_smoke.py `measure` whatever DIR is, so two
commits run in one call are held to one method: device time per call
from torch.profiler (each operation's mean time per event times its
events per call), split by operation name into `group_*` kernels,
`refresh_*` kernels and the rest (PyTorch ops around them), and the
CUDA-event wall per call of back-to-back calls.

It prints the card's `nvidia-smi` name and power limit, then one JSON
line.  `digest` hashes the grouping and the aggregates the refresh wrote,
so runs of two commits that compute the same function print the same
digest.  It needs a CUDA device, nvcc and nvidia-smi.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _timing():
    """This checkout's chip_smoke.py, loaded as a module for its timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(tree: str = ".") -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_round_prep: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(tree).resolve()
    if not (root / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"time_round_prep: {root} is not a checkout of the repository", file=sys.stderr)
        return 2
    cs = _timing()
    sys.path.insert(0, str(root))
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine, OptimizerConfig
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import _build
    from cruise_control_tpu_torch.kernels.group import Grouping
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    cfg = OptimizerConfig(**cs.SEARCH)
    state = random_cluster_fast(RandomClusterSpec(**cs.NORTH_STAR_SPEC), seed=42, device="cuda")
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    s = state.shape
    group = Grouping.empty(s.R, s.B, state.device)

    def refresh():
        eng.refresh(carry, group)

    refresh()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in (group.count, group.start, group.order, *carry.aggregates().values()):
        h.update(t.contiguous().cpu().numpy().tobytes())
    rec = cs.measure(refresh)
    split = {"group": 0.0, "refresh": 0.0, "other": 0.0}
    for name, (ms_event, events) in (rec["by_kernel"] or {}).items():
        part = name.split("_")[0] if name.startswith(("group_", "refresh_")) else "other"
        split[part] += ms_event * max(1, round(events))
    print(json.dumps({
        "tree": str(root), "card": smi, "ms": rec["ms"], "call_ms": rec["call_ms"],
        "ms_source": rec["ms_source"], "group_ms": split["group"], "refresh_ms": split["refresh"],
        "other_ms": split["other"], "by_kernel": rec["by_kernel"], "digest": h.hexdigest()[:16],
        "replicas": s.R, "brokers": s.B,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
