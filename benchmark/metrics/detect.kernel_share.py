"""``detect.kernel_share``: the port's ``detect.suppression_kernel`` counter
(1 for a detection whose suppression launched the card's kernel, 0 for one
that ran the plain version) over the ``detect.features`` calls of the traced
run's plain phase (``program.py``), in %; None where the port has no such
counter, or without a detection there."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, window = found
    if "detect.suppression_kernel" not in snap.names:
        return None
    calls = int(snap.select("detect.features", window).sum())
    if calls == 0:
        return None
    return 100.0 * snap.counter("detect.suppression_kernel", window) / calls
