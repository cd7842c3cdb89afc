"""``superpoint_lightglue.host_syncs_per_call``: the port's ``host_syncs``
counter (every read of a device value on the path) per call, over the
traced run's plain phase (``program.py``). A count."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, (lo, hi) = found
    return snap.counter("host_syncs", (lo, hi)) / (hi - lo)
