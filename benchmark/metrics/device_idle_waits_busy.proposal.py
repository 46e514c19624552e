"""Device, waits counted busy: the share of the traced part of the window
in which the profiler recorded no operation on the card and the host was
not blocked in a synchronisation with it, in percent, over the proposal cells.

Not the device's idle share alone: CUPTI records a conditional loop
graph's body kernels far fewer times than they run, so the recorded
device intervals leave most of an anneal out, and the host's blocking
waits stand in for the work they hide (harness/trace.py).  A wait that
returns while the card idles inside a graph counts as busy, so the share
is a lower reading of the card's idle time."""


def read(run):
    if run.trace is None or run.traced_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.traced_s)
