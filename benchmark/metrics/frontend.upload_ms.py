"""``frontend.upload_ms``: the port's ``frontend.upload`` spans (the
frame's and the lanes' ``torch.as_tensor`` onto the card: the host cast to
float32 and the pageable copies) per frame, over the traced run's plain
phase (``program.py``)."""

from benchmark import program


def read(record):
    ns = program.per_call_ns(record, "frontend.upload")
    return None if ns is None else ns / 1e6
