"""``raft.update_ms_per_iter``: wall time of one ``UpdateBlock_0`` call
(forward hooks, each after a synchronise), mean over the timed calls
(after the profiled and the plain ones)."""

import numpy as np


def read(record):
    t = record.tracer
    s = t.seconds("raft.UpdateBlock_0") if t else []
    return float(np.mean(s)) * 1e3 if s else None
