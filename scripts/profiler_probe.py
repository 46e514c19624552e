#!/usr/bin/env python3
"""Run chip_smoke.py's whole script with torch.profiler probes between its phases.

    python3 scripts/profiler_probe.py [--pads 0,0.002,0.02,0.25]

Every `check_*` and `profile_*` function of chip_smoke.py is wrapped so
that, when it returns, one probe runs: for each pad (seconds) one
torch.profiler session over five small adds on the card, idle for the pad
before the first add and after the last synchronise, and whether the
session showed any device activity.  A line is printed whenever the
probe's result differs from the previous probe's: the function it
followed, the result for each pad (true: the session saw the card), the
probe's number and the live threads.  The script's own output follows as
usual; it needs what chip_smoke.py needs (CUDA, nvcc, nvidia-smi).
"""

from __future__ import annotations

import functools
import json
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py as an importable module (spawned rank processes may
    need to import it by name)."""
    sys.path.insert(0, str(HERE))
    import chip_smoke

    return chip_smoke


def session_sees(pad: float) -> bool:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 20, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(5):
            x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(pad)
    return any(e.device_type == DeviceType.CUDA for e in prof.events())


def main(pads: list[float]) -> int:
    cs = _chip_smoke()
    last = {"sees": None, "n": 0}

    def probe(after: str) -> None:
        sees = [session_sees(p) for p in pads]
        last["n"] += 1
        if sees != last["sees"]:
            print(json.dumps({"probe": f"after {after}", "pads_s": pads, "sees_card": sees, "n": last["n"],
                              "threads": sorted(t.name for t in threading.enumerate())}), flush=True)
        last["sees"] = sees

    def wrap(name, fn):
        @functools.wraps(fn)
        def probed(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            finally:
                probe(name)

        return probed

    for name in list(vars(cs)):
        if name.startswith(("check_", "profile_")) and callable(getattr(cs, name)):
            setattr(cs, name, wrap(name, getattr(cs, name)))
    sys.argv = [str(HERE / "chip_smoke.py")]
    return cs.main()


if __name__ == "__main__":
    args = sys.argv[1:]
    pads = [0.0, 0.002, 0.02, 0.25]
    if args[:1] == ["--pads"] and len(args) == 2:
        pads = [float(p) for p in args[1].split(",")]
    elif args:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(pads))
