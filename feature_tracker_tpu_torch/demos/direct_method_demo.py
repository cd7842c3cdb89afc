"""Direct photometric SE(3) pose-tracking demo — the port of
``demos/direct_method_demo.py`` (reference:
test/test_direct_method.cpp:28-101): KITTI intrinsics, 300 random
depth-seeded points from the disparity map, 5-level pyramid; prints the
solved pose q_rc / p_rc and timing per current frame.

    python -m feature_tracker_tpu_torch.demos.direct_method_demo \
        [--device cpu]
"""

from __future__ import annotations

import numpy as np

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.direct import DirectMethod
from feature_tracker_tpu_torch.utils import TickTock, report_info
from feature_tracker_tpu_torch.utils.viz import render_tracked_features

# KITTI-style intrinsics (reference: test_direct_method.cpp:12-20).
FX, FY, CX, CY = 718.856, 718.856, 607.1928, 185.2157
BASELINE = 0.573
N_POINTS = 300
LEVELS = 5


def run(left, disparity, cur_frames, source="synthetic", *, device="cuda",
        out_dir=None) -> dict:
    """The pose of each of ``cur_frames`` against ``left`` from N_POINTS
    seeded points at the disparity's depth, each frame starting from the
    pose before. Returns ``ref_uv``, per frame ``q_rc``, ``p_rc``,
    ``tracked`` and ``ms``, the last frame's ``cur_uv`` and ``status``,
    and ``png``."""
    dev = resolve_device(device)
    report_info(f">> Test direct method ({source} imagery, "
                f"{left.shape[1]}x{left.shape[0]}).")

    h, w = left.shape
    rng = np.random.default_rng(0)
    ref_uv = np.stack([rng.integers(0, w, N_POINTS),
                       rng.integers(0, h, N_POINTS)], -1).astype(np.float32)
    disp = disparity[ref_uv[:, 1].astype(int), ref_uv[:, 0].astype(int)]
    depth = FX * BASELINE / np.maximum(disp, 1.0)

    # Back-project to the reference camera frame (identity world pose).
    p_c_ref = np.stack([(ref_uv[:, 0] - CX) / FX,
                        (ref_uv[:, 1] - CY) / FY,
                        np.ones(N_POINTS)], -1) * depth[:, None]

    ref_pyr = build_pyramid(left, LEVELS, device=dev)
    k4 = np.array([FX, FY, CX, CY], np.float32)
    solver = DirectMethod(device=dev)

    q_rc, p_rc = None, None
    last = None
    out = {"ref_uv": ref_uv, "q_rc": [], "p_rc": [], "tracked": [],
           "ms": []}
    for i, cur in enumerate(cur_frames):
        cur_pyr = build_pyramid(cur, LEVELS, device=dev)
        timer = TickTock()
        cur_uv, q_rc, p_rc, status = solver.track(
            ref_pyr, cur_pyr, k4, p_c_ref, ref_uv, q_rc, p_rc)
        q = q_rc.cpu().numpy()
        p = p_rc.cpu().numpy()
        ms = timer.tock_tick_ms()
        status = status.cpu().numpy()
        tracked = int((status == int(TrackStatus.TRACKED)).sum())
        report_info(
            f"frame {i + 1}: q_rc [{q[0]:.5f} {q[1]:.5f} {q[2]:.5f} "
            f"{q[3]:.5f}], p_rc [{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}], "
            f"tracked {tracked}/{N_POINTS}, {ms:.1f} ms"
            + (" (incl. compile)" if i == 0 else ""))
        out["q_rc"].append(q)
        out["p_rc"].append(p)
        out["tracked"].append(tracked)
        out["ms"].append(ms)
        last = (cur, cur_uv.cpu().numpy(), status)

    cur, cur_uv, status = last
    out["cur_uv"], out["status"] = cur_uv, status
    out["png"] = {"direct_method_tracking.png": render_tracked_features(
        cur, ref_uv, cur_uv, status)}
    _common.save_pngs(out["png"], out_dir)
    return out


def main():
    args = _common.parse_args(__doc__)
    left, disparity, cur_frames, source = _common.load_direct_method_set()
    run(left, disparity, cur_frames, source, device=args.device,
        out_dir=args.out)


if __name__ == "__main__":
    main()
