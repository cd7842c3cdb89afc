"""``klt_fast_roofline``: the least time of one launch of kernel 1
(``csrc/klt_fast.cu``) by its bound on the traced frames' work, over its
mean device time per launch (torch.profiler, kernels named ``klt_fast``),
in %. The bound is from ``work.klt_work`` with the Gauss-Newton steps the
plain reference takes on those frames."""

import sys

from benchmark import work


def read(record):
    p = record.profile
    if p is None:
        return None
    launches, seconds = p.kernel("klt_fast")
    if launches == 0 or seconds <= 0:
        return None
    w = record.session.traced_work(p.calls)
    least_ms, which = work.bound(w["klt_bytes"], w["klt_flops"])
    print(f"kernel1: bound {least_ms:.6f} ms ({which}), device "
          f"{seconds / launches * 1e3:.6f} ms per launch over {launches}",
          file=sys.stderr)
    return 100.0 * least_ms / (seconds / launches * 1e3)
