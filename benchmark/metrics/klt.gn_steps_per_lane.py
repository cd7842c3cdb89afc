"""``klt.gn_steps_per_lane``: kernel 1's own count of its Gauss-Newton
steps (summed over the levels), ``klt.gn_steps``, over its non-skipped
lanes, ``klt.lanes`` (device counters the port's tracer copies out once),
over the traced run's plain phase (``program.py``); on the CPU, the plain
version's own count."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, window = found
    lanes = snap.counter("klt.lanes", window)
    return snap.counter("klt.gn_steps", window) / lanes if lanes else None
