"""``raft.input_h2d_mb``: the port's ``raft.input.h2d_bytes`` counter (the
bytes of host memory a call's frames carried to the card) per call, over
the traced run's plain phase (``program.py``), in MB (10^6 bytes); None
where the port has no such counter."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, (lo, hi) = found
    if "raft.input.h2d_bytes" not in snap.names:
        return None
    return snap.counter("raft.input.h2d_bytes", (lo, hi)) / (hi - lo) / 1e6
