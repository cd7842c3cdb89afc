"""``lightglue.host_ms``: the port's ``lightglue.forward`` span (one
LightGlue call, no synchronise: the host's time to enqueue its ~1000
launches), mean over the traced run's plain phase (``program.py``)."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "lightglue.forward")
    return None if ns is None else ns / 1e6
