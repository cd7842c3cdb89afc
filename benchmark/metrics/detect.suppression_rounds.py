"""``detect.suppression_rounds``: the port's ``detect.suppression_rounds``
counter (one per round of the greedy suppression's chaotic iteration, each
ending in a host-synced test) per ``detect.features`` call, over the traced
run's plain phase (``program.py``); None without a detection there. A
count."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, window = found
    calls = int(snap.select("detect.features", window).sum())
    if calls == 0:
        return None
    return snap.counter("detect.suppression_rounds", window) / calls
