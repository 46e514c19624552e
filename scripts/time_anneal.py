#!/usr/bin/env python3
"""Time the port's candidates and scatter kernels and its fused anneal of one checkout on one GPU.

    python3 scripts/time_anneal.py [DIR]

DIR is a checkout of the repository (default: this one), for example an
earlier commit unpacked with `git archive`.  The script builds DIR's CUDA
kernels, makes the north-star cluster and search of chip_smoke.py (same
spec and seed) and times, with this checkout's chip_smoke.py `measure`
whatever DIR is (so two commits run in one call are held to one method):

- DIR's `candidates` on the inputs of one north-star step at T=0
  (back to back), as `apply_moves` below; where DIR has the JBOD path,
  also on one step of BASELINE configuration 3 (chip_smoke.py's
  `MID_SPEC` with 4 logdirs a broker, seed 42, its four-goal chain: the
  disk terms) and of rebalance_disk on that cluster (the intra kind);
- DIR's `apply_moves` on the inputs of one north-star step at T=0 (the
  step's survivors scattered into a scratch carry, back to back): device
  time per call from torch.profiler (each operation's mean time per event
  times its events per call), the operations it ran, and the CUDA-event
  wall per call;
- a whole fused run of DIR's `Engine.run` (its graphs captured by a first
  run): host wall to `torch.cuda.synchronize()` of three runs, each run's
  timing record (`host_dispatch_s`, `device_s`, and the loop's launches,
  iterations and masked rounds where DIR records them), the rows of the
  schedule (`len(ys)`), and one run under torch.profiler: device busy, and
  the device time of the operations whose names start with `apply_`.

It prints the card's `nvidia-smi` name and power limit, then two JSON
lines (the north star's, then the JBOD cases', `"jbod": null` without
them).  `digest` hashes the carry after one apply call and the placement
after the run, and each candidates record's `digest` the step's bundle,
so two commits that compute the same function print the same digests.
It needs a CUDA device, nvcc and nvidia-smi.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _timing():
    """This checkout's chip_smoke.py, loaded as a module for its timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_candidates(cs, state, chain, cfg) -> dict:
    """DIR's candidates on the inputs of one step at T=0: device and call
    time (chip_smoke.py's `measure`) and a digest of the bundle."""
    import torch

    from cruise_control_tpu_torch.analyzer import Engine
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import candidates as cand_k

    eng = Engine(state, chain, config=cfg)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    with cs.Capture([(cand_k, "candidates")]) as cap:
        eng.step(carry, 0.0, plan)
    (args, kw), = cap.calls["candidates"]
    bundle = cand_k.candidates(*args, **kw)
    h = hashlib.sha256()
    for f in ("delta", "feas", "accept", "src", "dst"):
        h.update(bundle[f].cpu().numpy().tobytes())
    rec = cs.measure(lambda: cand_k.candidates(*args, **kw))
    eng.release()
    torch.cuda.empty_cache()
    return dict(ms=rec["ms"], own_kernel_ms=rec["own_kernel_ms"], call_ms=rec["call_ms"],
                ms_source=rec["ms_source"], by_kernel=rec["by_kernel"], digest=h.hexdigest()[:16])


def time_jbod(cs, cfg) -> dict | None:
    """time_candidates on configuration 3 and on rebalance_disk, or None
    where DIR has no JBOD path."""
    import dataclasses

    from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
    from cruise_control_tpu_torch.analyzer.objective import GoalChain
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    cfg_d = dataclasses.replace(cfg, intra_broker=True)
    # trees before the JBOD path refuse the intra mode there; later trees
    # have no such check
    check = getattr(cfg_d, "check_ported", None)
    try:
        if check is not None:
            check()
    except NotImplementedError:
        return None
    state = random_cluster_fast(RandomClusterSpec(**{**cs.MID_SPEC, "disks_per_broker": 4}), seed=42,
                                device="cuda")
    return {
        "candidates_disk_terms": time_candidates(cs, state, GoalChain.from_names(list(cs.CONFIG3_CHAIN)),
                                                 cfg),
        "candidates_intra": time_candidates(
            cs, state, GoalChain.from_names(list(DEFAULT_INTRA_BROKER_GOAL_ORDER)), cfg_d),
    }


def main(tree: str = ".") -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_anneal: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(tree).resolve()
    if not (root / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"time_anneal: {root} is not a checkout of the repository", file=sys.stderr)
        return 2
    cs = _timing()
    sys.path.insert(0, str(root))
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine, OptimizerConfig
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import _build
    from cruise_control_tpu_torch.kernels import apply as apply_k
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    cfg = OptimizerConfig(**cs.SEARCH)
    state = random_cluster_fast(RandomClusterSpec(**cs.NORTH_STAR_SPEC), seed=42, device="cuda")
    h = hashlib.sha256()
    cands = {"candidates": time_candidates(cs, state, DEFAULT_CHAIN, cfg)}

    # apply_moves on one north-star step's survivors
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    with cs.Capture([(apply_k, "apply_moves")]) as cap:
        eng.step(carry, 0.0, plan)
    ((sx, c0, sv_r, payr, sv_l, payl), _), = cap.calls["apply_moves"]
    scratch = c0.clone()
    apply_k.apply_moves(sx, scratch, sv_r, payr, sv_l, payl)
    torch.cuda.synchronize()
    for t in vars(scratch).values():
        if isinstance(t, torch.Tensor):
            h.update(t.contiguous().cpu().numpy().tobytes())
    apply_rec = cs.measure(lambda: apply_k.apply_moves(sx, scratch, sv_r, payr, sv_l, payl))
    survivors = int(sv_r.sum()) + int(sv_l.sum())
    del eng, carry, plan, cap, scratch, c0

    # whole fused runs
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    eng.run()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        final, hist = eng.run()
        torch.cuda.synchronize()
        runs.append(dict(wall_ms=(time.monotonic() - t0) * 1e3, timing=hist[-1],
                         rounds=len([r for r in hist if "round" in r])))
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        h.update(getattr(final, f).cpu().numpy().tobytes())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    busy = apply_ms = 0.0
    apply_events = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            if e.name.startswith("apply_"):
                apply_ms += ms
                apply_events += 1
    print(json.dumps({
        "tree": str(root), "card": smi,
        **cands,
        "apply": dict(ms=apply_rec["ms"], call_ms=apply_rec["call_ms"], ms_source=apply_rec["ms_source"],
                      by_kernel=apply_rec["by_kernel"], survivor_rows=survivors,
                      rows=int(sv_r.shape[0] + sv_l.shape[0])),
        "runs": runs, "schedule_rows": int(eng._ws.sched.ys.shape[0]),
        "profiled_run": dict(device_busy_ms=busy, apply_device_ms=apply_ms, apply_events=apply_events),
        "digest": h.hexdigest()[:16],
    }), flush=True)
    eng.release()
    del eng, final, state
    torch.cuda.empty_cache()
    print(json.dumps({"tree": str(root), "card": smi, "jbod": time_jbod(cs, cfg)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
