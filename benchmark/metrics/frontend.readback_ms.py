"""``frontend.readback_ms``: the port's ``frontend.readback`` span (the
tracked status and positions copied to the host: the wait on the card and
the copies) per tracked frame, over the traced run's plain phase
(``program.py``)."""

from benchmark import program


def read(record):
    ns = program.per_call_ns(record, "frontend.readback",
                             calls_with="frontend.readback")
    return None if ns is None else ns / 1e6
