"""``frontend.mfu``: the operations a front-end frame needs (the pyramid,
KLT by ``work.klt_work`` with the reference's Gauss-Newton steps, and the
Shi-Tomasi response and suppression on replenishing frames, counted over
the profiled frames) over an untraced frame's time
(``Profile.plain_call_s``) at the H100's 67 TFLOP/s of float32 outside
the tensor cores (all the front end's arithmetic is scalar float32), in
%."""

from benchmark import work


def read(record):
    p = record.profile
    if p is None or p.calls == 0 or not p.plain_call_s:
        return None
    w = record.session.traced_work(p.calls)
    return 100.0 * w["frame_flops"] / (p.plain_call_s * work.F32_FLOPS)
