"""kernels/apply.py (csrc/apply.cu): the least time the bytes a launch
needs take at the card's HBM peak (every slot's flag, and each survivor's
row at the traced requests' mean survivors a launch), over the profiled
device time a launch, in percent."""

from harness import roofline


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel("apply_moves_kernel")
    steps = sum(r["rounds"] for r in run.traced if "rounds" in r) \
        * run.cell.config["search"]["steps_per_round"]
    accepted = sum(r["accepted"] for r in run.traced if "accepted" in r)
    if not steps:
        return None
    nb = roofline.apply_moves_bytes(run.cell.config["search"], accepted / steps)
    return roofline.share(nb, seconds, launches)
