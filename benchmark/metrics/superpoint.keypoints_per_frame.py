"""``superpoint.keypoints_per_frame``: the port's ``superpoint.keypoints``
counter (the keypoints SuperPoint kept, added on the device while tracing)
over the ``superpoint.detect`` calls of the traced run's plain phase
(``program.py``); None where the port has no such counter."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, window = found
    if "superpoint.keypoints" not in snap.names:
        return None
    calls = int(snap.select("superpoint.detect", window).sum())
    if calls == 0:
        return None
    return snap.counter("superpoint.keypoints", window) / calls
