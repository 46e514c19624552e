#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase 19 on one GPU until it hangs.

    python3 scripts/loop_threads.py [--rounds N] [--profile]

Builds the kernels, runs phase 4's north-star proposal for the placements
phase 19 holds its runs to, then runs phase 19 (two threads through one
GoalOptimizer: twelve small runs, a one-engine cache alternating two
shapes, two north-star runs) N times (default 40).  With `--profile`,
phase 7's torch.profiler traces run first, as they do in the whole
script.  One JSON line a round; a round that takes over 60 s dumps every
thread's stack to standard error and ends the process.  Needs a CUDA
device and nvcc."""

import argparse
import faulthandler
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as c
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig
    from cruise_control_tpu_torch.kernels import _build
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    t_start = time.monotonic()
    _build.build()
    cfg = OptimizerConfig(**c.SEARCH)
    state = random_cluster_fast(RandomClusterSpec(**c.NORTH_STAR_SPEC), seed=42, device="cuda")
    opt = GoalOptimizer(config=cfg, device="cuda")
    res = opt.optimize(state)
    exact = {f: getattr(res.state_after, f).clone() for f in c.PLACEMENT}
    exact.update(proposals=len(res.proposals),
                 accepted=[h["accepted"] for h in res.history if "round" in h])
    for engine in opt._engines.values():
        engine.release()
    del opt, res
    with c.card_answers_only():
        if args.profile:
            c.profile_fused(state, cfg)
            c.profile_steps(state, cfg)
            torch.cuda.empty_cache()
        print(json.dumps({"setup_s": time.monotonic() - t_start, "profiled": args.profile}), flush=True)
        for i in range(args.rounds):
            faulthandler.dump_traceback_later(60, exit=True)
            t0 = time.monotonic()
            c.check_threads(state, cfg, exact)
            faulthandler.cancel_dump_traceback_later()
            print(json.dumps({"round": i, "s": time.monotonic() - t0}), flush=True)
    print(json.dumps({"rounds": args.rounds, "hung": False}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
