"""``cotracker2.former_host_ms``: the port's ``cotracker2.former`` span (one
``EfficientUpdateFormer`` call, no synchronise: the host's time to enqueue
it), mean per iteration over the traced run's plain phase
(``program.py``)."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "cotracker2.former")
    return None if ns is None else ns / 1e6
