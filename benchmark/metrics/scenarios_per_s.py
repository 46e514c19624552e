"""What-if scenarios scored over the whole window, per second (host clock)."""


def read(run):
    done = sum(r.get("units", 0) for r in run.records if "error" not in r)
    return done / run.window_s if run.window_s > 0 else None
