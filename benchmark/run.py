"""Run one cell of the port's benchmark on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in BENCHMARK.json
(benchmark/harness/cells.py says where its files are).  The run needs
CUDA and as many cards as the cell asks for; without them it exits 2 and
prints no result.  Its last line on standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with `--trace 0`, its per-layer metrics with `--trace 1`), `device`
(`busy_s` and `window_s` too when traced), `breakdown` when traced, and
`checks`, each number the reference compared with its limit; the same
numbers are the last lines of standard error.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    program's own kernels build into cruise_control_tpu_torch/_build/)."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import cells

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from harness.cell import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
