"""Readings of the numbers `correct` compares, over many seeds in one
process, for the program and for its controls, on the card:

    python3 benchmark/control.py --workload <cell> --seconds <s> --mode <mode> SEED...

modes:
  program        the program as the configuration states it (the lower
                 readings of each limit)
  reference-bf16 the reference computed in bfloat16 put in the program's
                 place for the reports (the control)
  program-bf16   the program with its own bfloat16 scoring path on
  program-short  the program with its anneal cut short: half the steps a
                 round (the fault a faster, worse search would plant)

One JSON line a seed: {"seed", "mode", "correct", "checks", "run"}.  Not
part of the benchmark's runs; the limits in benchmark/limits/ were set
from its readings (PERF.md gives them).
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", choices=("program", "reference-bf16", "program-bf16",
                                       "program-short"),
                    default="program")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch

    from harness import cells
    from harness.cell import run_cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    half = dict(steps_per_round=cell.config["search"]["steps_per_round"] // 2)
    kw = {"reference-bf16": dict(control_dtype=torch.bfloat16),
          "program-bf16": dict(score_dtype="bfloat16"),
          "program-short": dict(search=half)}.get(args.mode, {})
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False, "cuda", time.monotonic(), **kw)
        print(json.dumps(dict(seed=seed, mode=args.mode, correct=out["correct"],
                              checks=out["checks"], run=out["run"],
                              metrics=out["metrics"])), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
