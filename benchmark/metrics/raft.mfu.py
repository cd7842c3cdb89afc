"""``raft.mfu``: FLOPs of one call (the configuration's convolutions at its
shape, the lookups' dot products on a traced call's own locations, the
upsampling) over an untraced call's time (``Profile.plain_call_s``) at
the H100's 989 TFLOP/s of dense bfloat16, in %: the configuration computes
in bfloat16."""

from benchmark import work


def read(record):
    p = record.profile
    if p is None or p.calls == 0 or not p.plain_call_s:
        return None
    w = record.session.traced_work(p.calls)
    if w is None:
        return None
    return 100.0 * w["call_flops"] / (p.plain_call_s * work.BF16_FLOPS)
