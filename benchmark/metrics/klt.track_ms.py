"""``klt.track_ms``: host-clock time of the tracker's ``track`` call, from
the wrapper (ending in a synchronise), mean over the timed calls (after
the profiled and the plain ones)."""

import numpy as np


def read(record):
    t = record.tracer
    s = t.seconds("tracker.track") if t else []
    return float(np.mean(s)) * 1e3 if s else None
