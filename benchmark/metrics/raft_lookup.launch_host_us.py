"""``raft_lookup.launch_host_us``: the port's ``raft_lookup.launch`` span
(kernel 5's launch: the output allocation, the level arrays and the ctypes
call), mean per launch over the traced run's plain phase (``program.py``);
None on the CPU, which has no kernel."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "raft_lookup.launch")
    return None if ns is None else ns / 1e3
