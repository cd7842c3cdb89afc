"""``klt.launch_host_us``: the port's ``klt.launch`` span (kernel 1's
wrapper: the checks, the output allocation and the ctypes call), mean per
launch over the traced run's plain phase (``program.py``); None on the
CPU, which has no kernel."""

from benchmark import program


def read(record):
    ns = program.mean_span_ns(record, "klt.launch")
    return None if ns is None else ns / 1e3
