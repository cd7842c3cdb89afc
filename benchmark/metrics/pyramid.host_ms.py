"""``pyramid.host_ms``: the port's ``pyramid.build`` span (the upload check,
its value reads and the levels' launches), mean per call over the traced
run's plain phase (``program.py``)."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "pyramid.build")
    return None if ns is None else ns / 1e6
