"""``cotracker2.frames_encoded_per_call``: the port's
``cotracker2.frames_encoded`` counter over the calls that hold a
``cotracker2.window`` span (a clip's first call encodes nothing and runs no
window), over the traced run's plain phase (``program.py``): 8 where each
call re-encodes the 4 frames its window shares with the window before, as
the release's online predictor does."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, window = found
    if "cotracker2.frames_encoded" not in snap.names:
        return None
    calls = len(set(snap.call[snap.select("cotracker2.window",
                                          window)].tolist()))
    if calls == 0:
        return None
    return snap.counter("cotracker2.frames_encoded", window) / calls
