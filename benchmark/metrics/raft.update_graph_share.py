"""``raft.update_graph_share``: the port's ``raft.update_graph.replays``
counter (one per ``UpdateBlock_0`` call that replayed its CUDA graph) over
its ``raft.update`` spans, over the traced run's plain phase
(``program.py``), in %; None where the port has no such counter (no graph
path) or no update span there."""

from benchmark import program


def read(record):
    found = program.plain_phase(record)
    if found is None:
        return None
    snap, window = found
    if "raft.update_graph.replays" not in snap.names:
        return None
    calls = int(snap.select("raft.update", window).sum())
    if calls == 0:
        return None
    return 100.0 * snap.counter("raft.update_graph.replays", window) / calls
