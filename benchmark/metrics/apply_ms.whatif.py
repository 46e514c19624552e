"""Scenario application (planner/scenario.py, models/whatif.py HostState):
the harness's span around `evaluate` less the batch's own `wall_s`
(the upload, launch and sync of the scored batch), a batch, in ms."""


def read(run):
    x = [r["call_s"] - r["wall_s"] for r in run.records if r.get("wall_s") is not None]
    return 1e3 * sum(x) / len(x) if x else None
