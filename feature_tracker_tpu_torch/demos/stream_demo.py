"""Streaming tracking demo: native ring-buffer pipeline + KLT on the card —
the port of ``demos/stream_demo.py``.

Production restructuring of the reference's frame loop: a producer thread
feeds KITTI frames (uint8) through the C++ SPSC ring; the consumer builds
pyramids with the fused native convert+pyramid and tracks features
frame-to-frame on the card (one ``csrc/klt_fast.cu`` launch per tracked
frame). Prints per-frame latency and survival.

    python -m feature_tracker_tpu_torch.demos.stream_demo [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import HarrisOptions, KltOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.ops.detect import detect_good_features
from feature_tracker_tpu_torch.runtime import (
    FrameStream,
    build_native,
    get_runtime,
)
from feature_tracker_tpu_torch.trackers.klt import BasicKlt
from feature_tracker_tpu_torch.utils import report_info

LEVELS = 4
MAX_FEATURES = 300


def run(left, cur_frames, source="synthetic", *, device="cuda",
        out_dir=None) -> dict:
    """Stream ``[left] + cur_frames`` (as uint8) through ``FrameStream``:
    detect on the first pyramid, track through the rest at a fixed
    capacity.

    Returns ``num`` (detected), per tracked frame ``tracked``, ``ms``,
    ``uv`` and ``status`` (after the tracker, before the reset), the
    source indices of the ``frames`` that came through the ring (a full
    ring drops a frame, as a camera does), ``dropped``, ``native`` and
    ``track_calls``.
    ``out_dir`` is accepted for the demos' common signature: this demo
    writes no PNG."""
    del out_dir
    dev = resolve_device(device)
    native = build_native() and get_runtime().is_native
    report_info(f">> Streaming tracking demo ({source} imagery, "
                f"native={native}).")

    frames = [np.clip(f, 0, 255).astype(np.uint8)
              for f in [left] + list(cur_frames)]
    rt = get_runtime()

    # Fixed-capacity state (uv + status): failed lanes are skipped by the
    # tracker (reference semantics) instead of being filtered out, so
    # every frame has the same shapes.
    tracker = BasicKlt(KltOptions(max_track_points=MAX_FEATURES), device=dev)
    detect_opts = HarrisOptions(min_feature_distance=25,
                                min_valid_response=40.0)
    prev_pyr = None
    uv = None
    status = None
    out = {"tracked": [], "ms": [], "uv": [], "status": [],
           "native": native, "track_calls": 0}
    dropped = []
    stream = FrameStream(iter(frames), levels=LEVELS, capacity=4,
                         on_drop=dropped.append)
    t_all = rt.now_ns()
    for fid, pyr in stream:
        pyr_t = tuple(torch.as_tensor(level, device=dev) for level in pyr)
        if prev_pyr is None:
            uv, num = detect_good_features(pyr_t[0], MAX_FEATURES,
                                           detect_opts, device=dev)
            status = torch.where(
                torch.arange(MAX_FEATURES, device=dev) < num,
                int(TrackStatus.NOT_TRACKED),
                int(TrackStatus.OUTSIDE)).to(torch.int8)
            out["num"] = int(num)
            report_info(f"frame {fid}: detected {int(num)} features")
        else:
            t0 = rt.now_ns()
            uv, status = tracker.track(prev_pyr, pyr_t, uv, uv, status)
            out["track_calls"] += 1
            status_np = status.cpu().numpy()        # waits for the card
            ms = (rt.now_ns() - t0) / 1e6
            alive = int((status_np == int(TrackStatus.TRACKED)).sum())
            report_info(f"frame {fid}: tracked {alive}/{MAX_FEATURES} "
                        f"lanes in {ms:.1f} ms"
                        + (" (incl. compile)" if fid == 1 else ""))
            out["tracked"].append(alive)
            out["ms"].append(ms)
            out["uv"].append(uv.cpu().numpy())
            out["status"].append(status_np)
            # Survivors continue; failed lanes stay failed (reference:
            # basic_klt.cpp:15). Reset survivors to NOT_TRACKED so the
            # next frame re-tracks them.
            status = torch.where(status == int(TrackStatus.TRACKED),
                                 int(TrackStatus.NOT_TRACKED),
                                 status).to(torch.int8)
        prev_pyr = pyr_t
    total_ms = (rt.now_ns() - t_all) / 1e6
    out["dropped"] = stream.dropped
    out["frames"] = [i for i in range(len(frames)) if i not in dropped]
    report_info(f"Processed {len(frames)} frames in {total_ms:.0f} ms "
                f"(incl. compiles).")
    return out


def main():
    args = _common.parse_args(__doc__)
    left, _, cur_frames, source = _common.load_direct_method_set()
    run(left, cur_frames, source, device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
