"""The 99th percentile, over every record due in the window, of the
time its batch was reaped less the time it was due (ms).  A record due
and never verdicted counts as infinitely late."""

import numpy as np


def read(run):
    lat = run.mode.latencies_s()
    if not len(lat):
        return None
    p99 = float(np.percentile(lat, 99)) * 1e3
    return p99 if np.isfinite(p99) else None
