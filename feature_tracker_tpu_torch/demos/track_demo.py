"""Sparse pyramidal KLT demo — the port of ``demos/track_demo.py``
(reference: test/test_optical_flow.cpp:171-185): Harris detect (min
distance 25, min response 40, <=300 features), 4-level pyramid, half-patch
6, fast solver; runs Basic / Affine / LSSD variants, prints tracked counts
and timing, writes status-colored overlays. Each ``track`` call is one
kernel launch on the card (``csrc/klt_fast.cu``, ``klt_affine.cu``,
``klt_lssd.cu``).

    python -m feature_tracker_tpu_torch.demos.track_demo [--device cpu]
"""

from __future__ import annotations

from feature_tracker_tpu_torch.core.config import (
    HarrisOptions,
    KltMethod,
    KltOptions,
)
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.ops.detect import detect_good_features
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt import AffineKlt, BasicKlt, LssdKlt
from feature_tracker_tpu_torch.utils import TickTock, report_info, time_jitted
from feature_tracker_tpu_torch.utils.viz import render_tracked_features

MAX_FEATURES = 300
PYRAMID_LEVELS = 4
HALF_PATCH = 6


def run(ref, cur, source="synthetic", *, iters=10, device="cuda",
        out_dir=None) -> dict:
    """Detect on ``ref``, track into ``cur`` with the three trackers, each
    through ``time_jitted`` (one warm-up call and ``iters`` timed ones).

    Returns ``num`` and ``uv`` (the detections), per tracker ``name`` a
    dict with ``uv``, ``status``, ``tracked``, ``ms`` and ``first_ms``,
    ``track_calls`` (per tracker) and ``png`` (the overlays by file name,
    written under ``out_dir`` unless it is None)."""
    dev = resolve_device(device)
    report_info(f">> Test optical flow ({source} imagery, "
                f"{ref.shape[1]}x{ref.shape[0]}).")

    timer = TickTock()
    uv, num = detect_good_features(
        ref, MAX_FEATURES,
        HarrisOptions(min_feature_distance=25, min_valid_response=40.0),
        device=dev)
    uv, num = uv.cpu().numpy(), int(num)
    report_info(f"Detected {num} features in "
                f"{timer.tock_tick_ms():.2f} ms (incl. compile).")

    ref_pyr = build_pyramid(ref, PYRAMID_LEVELS, device=dev)
    cur_pyr = build_pyramid(cur, PYRAMID_LEVELS, device=dev)
    opts = KltOptions(max_track_points=MAX_FEATURES,
                      patch_row_half_size=HALF_PATCH,
                      patch_col_half_size=HALF_PATCH,
                      method=KltMethod.FAST)

    out = {"num": num, "uv": uv[:num], "track_calls": 1 + iters, "png": {}}
    for name, tracker in [("basic", BasicKlt(opts, device=dev)),
                          ("affine", AffineKlt(opts, device=dev)),
                          ("lssd", LssdKlt(opts, device=dev))]:
        (cur_uv, status), stats = time_jitted(
            tracker.track, ref_pyr, cur_pyr, uv[:num], iters=iters)
        cur_uv, status = cur_uv.cpu().numpy(), status.cpu().numpy()
        tracked = int((status == int(TrackStatus.TRACKED)).sum())
        report_info(
            f"{name} klt (fast) tracked {tracked} / {num} features; "
            f"{stats['mean_ms']:.3f} ms/call steady state "
            f"({stats['compile_ms']:.0f} ms first call).")
        out[name] = {"uv": cur_uv, "status": status, "tracked": tracked,
                     "ms": stats["mean_ms"], "first_ms": stats["compile_ms"]}
        png = {f"klt_{name}_tracking.png": render_tracked_features(
            cur, uv[:num], cur_uv, status)}
        _common.save_pngs(png, out_dir)
        out["png"].update(png)
    return out


def main():
    args = _common.parse_args(__doc__)
    ref, cur, source = _common.load_optical_flow_pair()
    run(ref, cur, source, device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
