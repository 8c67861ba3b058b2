"""apply_p95_ms: the 95th percentile of every call's latency in the
window (linear interpolation between order statistics), in ms."""

import numpy as np


def read(run):
    lat = run.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
