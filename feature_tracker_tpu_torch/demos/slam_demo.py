"""SLAM front-end capstone demo — the port of ``demos/slam_demo.py``:
persistent KLT tracking feeding the sliding-window Schur-complement bundle
adjuster, cross-validated against the direct photometric method.

The TrackingFrontEnd tracks the KITTI direct-method sequence with
persistent identities (one ``csrc/klt_fast.cu`` launch per tracked frame),
frame-0 tracks are back-projected through the disparity map into landmarks
(reference intrinsics, test_direct_method.cpp:12-20), each frame becomes a
keyframe with identity-initialized pose, and the window BA refines all
poses + landmarks jointly. The refined camera trajectory is then compared
per-frame against the DirectMethod SE(3) solve — two independent
estimators (feature-reprojection BA vs dense photometric GN) agreeing on
the same motion is the checkable signal. Writes a top-down trajectory plot
+ final-frame track overlay.

    python -m feature_tracker_tpu_torch.demos.slam_demo [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.geometry import quat_to_matrix
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.parallel.ba import BaOptions
from feature_tracker_tpu_torch.parallel.window_ba import (
    SlidingWindowBa,
    WindowConfig,
)
from feature_tracker_tpu_torch.pipeline import FrontEndConfig, TrackingFrontEnd
from feature_tracker_tpu_torch.trackers.direct import DirectMethod
from feature_tracker_tpu_torch.utils import TickTock, report_info
from feature_tracker_tpu_torch.utils.viz import (
    draw_lines,
    draw_points,
    render_tracked_features,
)

# KITTI-style intrinsics (reference: test_direct_method.cpp:12-20).
FX, FY, CX, CY = 718.856, 718.856, 607.1928, 185.2157
BASELINE = 0.573


def trajectory_plot(trajs, size=420):
    """Top-down (x, z) trajectory canvas; trajs: list of [T, 3]."""
    rgb = np.full((size, size, 3), 255, np.uint8)
    allp = np.concatenate(trajs, axis=0)
    lo = allp.min(axis=0)
    hi = allp.max(axis=0)
    span = max(float(hi[0] - lo[0]), float(hi[2] - lo[2]), 0.5)
    margin = 40

    def to_px(t):
        x = (t[:, 0] - lo[0]) / span * (size - 2 * margin) + margin
        z = (t[:, 2] - lo[2]) / span * (size - 2 * margin) + margin
        return np.stack([x, size - 1 - z], -1).astype(np.float32)

    colors = [(30, 120, 255), (230, 60, 60), (40, 180, 90)]
    for traj, color in zip(trajs, colors):
        px = to_px(traj)
        draw_lines(rgb, px[:-1], px[1:], color)
        draw_points(rgb, px, color, radius=3)
    return rgb


def landmark_window(results, disparity, device="cuda"):
    """The window of the front end's ``results``: every frame a keyframe
    at identity, a landmark for each live frame-0 lane at its disparity's
    depth, observed on every frame where the lane keeps its frame-0 id and
    is tracked. Returns (window, the lanes made landmarks, their world
    points ``[capacity, 3]``, the observation count)."""
    h, w = disparity.shape
    r0 = results[0]
    lane_ok = r0.track_ids >= 0
    uv0 = r0.uv
    disp = disparity[np.clip(uv0[:, 1].astype(int), 0, h - 1),
                     np.clip(uv0[:, 0].astype(int), 0, w - 1)]
    depth = FX * BASELINE / np.maximum(disp, 1.0)
    usable = lane_ok & (disp > 1.0) & (depth < 80.0)
    p_w = np.stack([(uv0[:, 0] - CX) / FX * depth,
                    (uv0[:, 1] - CY) / FY * depth,
                    depth], -1)

    k4 = np.array([FX, FY, CX, CY], np.float32)
    # landmark_prior anchors the disparity-seeded landmarks to their
    # metric depths (the scale gauge would otherwise be free).
    n = len(results)
    wba = SlidingWindowBa(k4, WindowConfig(max_keyframes=n,
                                           max_landmarks=512,
                                           obs_per_landmark=n),
                          BaOptions(max_iterations=20,
                                    landmark_prior=30.0, huber_px=2.0),
                          device=device)

    kf_slots = [wba.add_keyframe([1, 0, 0, 0], [0, 0, 0])
                for _ in results]
    lm_slot_of_lane = {}
    for lane in np.nonzero(usable)[0]:
        lm_slot_of_lane[lane] = wba.add_landmark(p_w[lane])

    # Observations: every frame where the lane is alive and still carries
    # the SAME identity it had on frame 0 (persistent ids are the point).
    n_obs = 0
    for r in results:
        for lane, slot in lm_slot_of_lane.items():
            if (r.track_ids[lane] == r0.track_ids[lane]
                    and r.status[lane] == int(TrackStatus.TRACKED)):
                wba.add_observation(slot, kf_slots[r.frame_id],
                                    r.uv[lane])
                n_obs += 1
    return wba, usable, p_w, n_obs


def run(left, disparity, cur_frames, source="synthetic", *, device="cuda",
        out_dir=None) -> dict:
    """The front end over ``[left] + cur_frames``, the window BA of the
    frame-0 landmarks and the direct method's poses of the same landmarks.

    Returns ``results`` (the front end's ``FrameResult`` per frame),
    ``landmarks`` (their count), ``n_obs``, ``rms`` (the BA's history),
    ``window`` (``q_cw``, ``t_cw``, ``landmarks`` after the BA),
    ``cam_ba`` and ``cam_direct`` (camera positions, ``[T, 3]``), ``err``
    (their distance per frame after the first), ``track_calls`` and
    ``png``."""
    dev = resolve_device(device)
    frames = [left] + list(cur_frames)
    h, w = left.shape
    report_info(f">> SLAM front-end demo ({source} imagery, {w}x{h}, "
                f"{len(frames)} frames).")

    # ---- 1. Persistent tracking with identities -------------------------
    fe = TrackingFrontEnd(FrontEndConfig(), device=dev)
    results = [fe.process_frame(f) for f in frames]
    for r in results:
        report_info(f"frame {r.frame_id}: live tracks {r.num_live}")

    # ---- 2. Landmarks from frame-0 disparity ---------------------------
    wba, usable, p_w, n_obs = landmark_window(results, disparity, dev)
    report_info(f"window: {int(usable.sum())} landmarks, "
                f"{len(frames)} keyframes, {n_obs} observations")

    # ---- 3. Window BA ----------------------------------------------------
    timer = TickTock()
    rms = wba.optimize()
    ms = timer.tock_tick_ms()
    report_info(f"BA rms {rms[0]:.3f} -> {rms[-1]:.3f} px over "
                f"{len(rms) - 1} iterations ({ms:.0f} ms incl. compile)")

    # Camera position in world = -R^T t  (q_cw, t_cw convention).
    rot = quat_to_matrix(torch.as_tensor(wba.q_cw)).numpy()
    cam_ba = -np.einsum("kij,kj->ki", rot.transpose(0, 2, 1), wba.t_cw)

    # ---- 4. Cross-check: direct photometric method ----------------------
    ref_pyr = build_pyramid(left, 5, device=dev)
    solver = DirectMethod(device=dev)
    k4 = np.array([FX, FY, CX, CY], np.float32)
    ref_uv = results[0].uv[usable].astype(np.float32)
    p_c_ref = p_w[usable].astype(np.float32)
    cam_direct = [np.zeros(3)]
    q_rc, p_rc = None, None
    for cur in cur_frames:
        cur_pyr = build_pyramid(cur, 5, device=dev)
        _, q_rc, p_rc, _ = solver.track(ref_pyr, cur_pyr, k4, p_c_ref,
                                        ref_uv, q_rc, p_rc)
        p = p_rc.cpu().numpy()
        # T_rc maps cur-camera to ref(world): camera center = p directly.
        cam_direct.append(p.astype(np.float64))
    cam_direct = np.stack(cam_direct)

    err = np.linalg.norm(cam_ba[1:len(frames)] - cam_direct[1:], axis=1)
    for i in range(1, len(frames)):
        report_info(
            f"frame {i}: BA cam [{cam_ba[i][0]:+.3f} {cam_ba[i][1]:+.3f} "
            f"{cam_ba[i][2]:+.3f}]  direct [{cam_direct[i][0]:+.3f} "
            f"{cam_direct[i][1]:+.3f} {cam_direct[i][2]:+.3f}]  "
            f"|Δ| {err[i - 1]:.3f} m")
    report_info(f"BA vs direct mean |Δ| {err.mean():.3f} m over "
                f"{len(err)} frames")

    # ---- 5. Render -------------------------------------------------------
    last = results[-1]
    png = {"slam_trajectory.png": trajectory_plot([cam_ba[:len(frames)],
                                                   cam_direct]),
           "slam_front_end_tracks.png": render_tracked_features(
               frames[-1], results[-2].uv, last.uv, last.status)}
    _common.save_pngs(png, out_dir, say=None)
    report_info(">> wrote slam_trajectory.png (blue: BA, red: direct) "
                "and slam_front_end_tracks.png")
    return {"results": results, "landmarks": int(usable.sum()),
            "n_obs": n_obs, "rms": np.asarray(rms),
            "window": (wba.q_cw, wba.t_cw, wba.landmarks),
            "cam_ba": cam_ba, "cam_direct": cam_direct, "err": err,
            "track_calls": len(frames) - 1, "optimize_ms": ms, "png": png}


def main():
    args = _common.parse_args(__doc__)
    left, disparity, cur_frames, source = _common.load_direct_method_set()
    run(left, disparity, cur_frames, source, device=args.device,
        out_dir=args.out)


if __name__ == "__main__":
    main()
