"""``raft.input_ms``: the port's ``raft.input`` span (the host frames made
float32 on the host, copied to the card and normalised to the model's
dtype), mean per call over the traced run's plain phase (``program.py``)."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "raft.input")
    return None if ns is None else ns / 1e6
