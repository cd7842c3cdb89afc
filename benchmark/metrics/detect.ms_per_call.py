"""``detect.ms_per_call``: host-clock time of a ``detect_good_features``
call, from the wrapper (ending in a synchronise), mean over the timed calls
(after the profiled and the plain ones)."""

import numpy as np


def read(record):
    t = record.tracer
    s = t.seconds("pipeline.detect_good_features") if t else []
    return float(np.mean(s)) * 1e3 if s else None
