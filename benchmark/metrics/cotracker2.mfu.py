"""``cotracker2.mfu``: FLOPs of the plain calls (``work/cotracker2.py``: the
encoder over a window's 8 frames, the former, the heads and kernel 5 on a
traced call's own locations, for each call that runs a window; a clip's
first call only keeps its frames and queries) over their untraced time
(``Profile.plain_call_s``) at the H100's 989 TFLOP/s of dense bfloat16,
in %: the configuration computes in bfloat16."""

from benchmark import work


def read(record):
    p = record.profile
    if p is None or p.calls == 0 or not p.plain_call_s:
        return None
    flops = record.session.calls_flops(p.calls, p.calls, 2 * p.calls)
    if flops is None:
        return None
    return 100.0 * flops / p.calls / (p.plain_call_s * work.BF16_FLOPS)
