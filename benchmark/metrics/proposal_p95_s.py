"""The 95th percentile of every request latency of the window, from the
request's send to its proposals on the host (host clock)."""

import numpy as np


def read(run):
    lat = [r["t1"] - r["t0"] for r in run.records]
    return float(np.percentile(lat, 95)) if lat else None
