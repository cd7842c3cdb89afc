"""``cotracker2.lookup_roofline``: the least time of one launch of kernel 5
(``csrc/raft_lookup.cu``) in border mode by its bound on a traced call's
own track locations (``work/cotracker2.py::lookup_work_border``), over its
mean device time per launch (torch.profiler, kernels named
``raft_lookup``), in %."""

import sys

from benchmark import work


def read(record):
    p = record.profile
    if p is None:
        return None
    launches, seconds = p.kernel("raft_lookup")
    w = record.session.traced_work(p.calls)
    if launches == 0 or seconds <= 0 or w is None:
        return None
    least_ms, which = work.bound(w["lookup_bytes"], w["lookup_flops"])
    print(f"kernel5 border: bound {least_ms:.6f} ms ({which}), device "
          f"{seconds / launches * 1e3:.6f} ms per launch over {launches}",
          file=sys.stderr)
    return 100.0 * least_ms / (seconds / launches * 1e3)
