"""``frontend.host_syncs_per_frame``: the port's ``host_syncs`` counter
(every read of a device value on the frame's path: the pyramid's checks,
detection's candidate count, round tests and selection, the readbacks) per
frame, over the traced run's plain phase (``program.py``). A count."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, (lo, hi) = found
    return snap.counter("host_syncs", (lo, hi)) / (hi - lo)
