"""``superpoint_lightglue.mfu``: FLOPs of a call (``work/
superpoint_lightglue.py``: SuperPoint's convolutions on the 1024x768 frame
and LightGlue's products at its 2048-point capacities, as the port computes
them) over the untraced call time (``Profile.plain_call_s``) at the H100's
67 TFLOP/s of float32 outside the tensor cores, in %: the configuration
computes in float32 with TF32 off."""

from benchmark import work


def read(record):
    p = record.profile
    if p is None or p.calls == 0 or not p.plain_call_s:
        return None
    return 100.0 * record.session.call_flops() / (p.plain_call_s
                                                  * work.F32_FLOPS)
