"""``raft.update_host_ms``: the port's ``raft.update`` span (one
``UpdateBlock_0`` call, no synchronise: the host's time to enqueue it),
mean per iteration over the traced run's plain phase (``program.py``)."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "raft.update")
    return None if ns is None else ns / 1e6
