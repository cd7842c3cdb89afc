"""``frontend.host_self_ms``: the port's ``frontend.frame`` span (one
``process_frame``) less its children (upload, pyramid, detection, tracker,
readback), mean over the traced run's plain phase (``program.py``): the
frame's own host work, the numpy bookkeeping and the replenishment's
readback among it."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "frontend.frame", self_time=True)
    return None if ns is None else ns / 1e6
