"""``frame_ms_p95``: the 95th percentile of every frame's latency in the
window, from handing the host frame to the entry point to its result being
ready (host clock); the pairs of one call share its latency."""

import numpy as np


def read(record):
    lat = record.frame_latencies()
    if lat.size == 0:
        return None
    return float(np.percentile(lat, 95)) * 1e3
