"""BRIEF descriptor matching demo — the port of
``demos/match_brief_demo.py`` (reference:
test/test_descriptor_matcher_brief.cpp:48-105): Harris detect (min distance
20, response 40, <=300), 256-bit BRIEF with half-patch 8, nearby match with
a 50-px gate and Hamming threshold 60; prints tracked / total and writes a
side-by-side match image.

    python -m feature_tracker_tpu_torch.demos.match_brief_demo [--device cpu]
"""

from __future__ import annotations

import torch

from feature_tracker_tpu_torch.core.config import HarrisOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.match.brief import compute_brief
from feature_tracker_tpu_torch.match.matcher import (
    fill_matched_pixels,
    hamming_distance_matrix,
    nearby_match,
)
from feature_tracker_tpu_torch.ops.detect import detect_good_features
from feature_tracker_tpu_torch.utils import TickTock, report_info
from feature_tracker_tpu_torch.utils.viz import render_matches

MAX_FEATURES = 300


def run(ref, cur, source="synthetic", *, device="cuda",
        out_dir=None) -> dict:
    """Detect in both frames, describe, match. Returns ``n_ref``,
    ``n_cur``, ``ref_uv`` / ``cur_uv`` (the detections), ``ref_bits`` /
    ``cur_bits``, ``idx`` (cur index per ref feature, -1 for none),
    ``matched_uv``, ``status``, ``tracked``, ``ms`` and ``png``."""
    dev = resolve_device(device)
    report_info(f">> Test feature point matcher with BRIEF "
                f"({source} imagery).")

    ref_t = torch.as_tensor(ref, dtype=torch.float32, device=dev)
    cur_t = torch.as_tensor(cur, dtype=torch.float32, device=dev)
    opts = HarrisOptions(min_feature_distance=20, min_valid_response=40.0)
    ref_uv, n_ref = detect_good_features(ref_t, MAX_FEATURES, opts,
                                         device=dev)
    cur_uv, n_cur = detect_good_features(cur_t, MAX_FEATURES, opts,
                                         device=dev)
    n_ref, n_cur = int(n_ref), int(n_cur)
    report_info(f"Detected {n_ref} / {n_cur} features in ref / cur image.")

    timer = TickTock()
    ref_bits, ref_valid = compute_brief(ref_t, ref_uv[:n_ref])
    cur_bits, cur_valid = compute_brief(cur_t, cur_uv[:n_cur])
    dist = hamming_distance_matrix(ref_bits, cur_bits)
    # Invalid (border) descriptors behave like the reference's empty
    # descriptors: distance +inf (test_descriptor_matcher_brief.cpp:33-38).
    dist = torch.where(ref_valid[:n_ref, None] & cur_valid[None, :n_cur],
                       dist, torch.inf)
    idx = nearby_match(dist, ref_uv[:n_ref], cur_uv[:n_cur],
                       max_valid_distance=60.0,
                       max_col_distance=50.0, max_row_distance=50.0)
    matched_uv, status = fill_matched_pixels(idx, cur_uv[:n_cur])
    status = status.cpu().numpy()
    ms = timer.tock_tick_ms()
    tracked = int((status == int(TrackStatus.TRACKED)).sum())
    report_info(f"Matched {tracked} / {n_ref} features in {ms:.2f} ms "
                f"(incl. compile).")

    ref_uv = ref_uv[:n_ref].cpu().numpy()
    matched_uv = matched_uv.cpu().numpy()
    png = {"match_brief.png": render_matches(ref, cur, ref_uv, matched_uv,
                                             status)}
    _common.save_pngs(png, out_dir)
    return {"n_ref": n_ref, "n_cur": n_cur, "ref_uv": ref_uv,
            "cur_uv": cur_uv[:n_cur].cpu().numpy(),
            "ref_bits": ref_bits.cpu().numpy(),
            "cur_bits": cur_bits.cpu().numpy(), "idx": idx.cpu().numpy(),
            "matched_uv": matched_uv, "status": status, "tracked": tracked,
            "ms": ms, "png": png}


def main():
    args = _common.parse_args(__doc__)
    ref, cur, source = _common.load_optical_flow_pair()
    run(ref, cur, source, device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
