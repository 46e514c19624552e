"""Fused route (analyzer/engine.py `_run_fused`, kernels/schedule.py loop
graph): the timing record's `device_s`, which is the host's wait from the
graph's dispatch to its one sync (a host clock, not device time), summed
over the window and divided by its proposals, in ms."""


def read(run):
    x = [r["device_s"] for r in run.records if r.get("device_s") is not None]
    return 1e3 * sum(x) / len(x) if x else None
