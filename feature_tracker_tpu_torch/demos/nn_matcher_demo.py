"""LightGlue neural matching demo — the port of ``demos/nn_matcher_demo.py``
(reference: test/test_nn_feature_matcher.cpp:27-77): SuperPoint detect +
LightGlue match, max 250 features, min match score log(0.03), on the
shipped ``weights/superpoint.npz`` and ``weights/lightglue_superpoint.npz``
(randomly initialised from seed 0 when a file is absent, which validates
the mechanism but not match quality); then the DISK + LightGlue variant
when both of its weight files exist.

    python -m feature_tracker_tpu_torch.demos.nn_matcher_demo [--device cpu]
"""

from __future__ import annotations

import math

import torch

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.match.nn_matcher import (
    NNFeatureMatcher,
    NNMatcherModelType,
    NNMatcherOptions,
)
from feature_tracker_tpu_torch.models.disk import DiskDetector
from feature_tracker_tpu_torch.models.superpoint import SuperPointDetector
from feature_tracker_tpu_torch.utils import TickTock, report_info
from feature_tracker_tpu_torch.utils.viz import render_matches

MAX_FEATURES = 250  # reference: test_nn_feature_matcher.cpp:22


def _detect(detector, ref, cur, dev):
    """Detections of both frames and the masks of their detected lanes."""
    ref_uv, ref_desc, n_ref = detector.detect(ref)
    cur_uv, cur_desc, n_cur = detector.detect(cur)
    lanes = torch.arange(MAX_FEATURES, device=dev)
    return ref_uv, ref_desc, n_ref, cur_uv, cur_desc, n_cur, lanes < n_ref, \
        lanes < n_cur


def _match(matcher, detected):
    """LightGlue-match ``_detect``'s detections; ref lanes past the detected
    count are NOT_TRACKED. Returns (n_ref, n_cur, ref_uv, matched_uv,
    status) on the host."""
    ref_uv, ref_desc, n_ref, cur_uv, cur_desc, n_cur, mask_ref, mask_cur = \
        detected
    matched_uv, status = matcher.match(ref_desc, cur_desc, ref_uv, cur_uv,
                                       mask_ref, mask_cur)
    status = status.cpu().numpy().copy()
    status[~mask_ref.cpu().numpy()] = int(TrackStatus.NOT_TRACKED)
    return (int(n_ref), int(n_cur), ref_uv.cpu().numpy(),
            matched_uv.cpu().numpy(), status)


def run(ref, cur, source="synthetic", *, device="cuda",
        out_dir=None) -> dict:
    """SuperPoint + LightGlue on ``ref`` / ``cur``, then DISK + LightGlue.
    Returns ``kind`` and, under ``"superpoint"`` and ``"disk"`` (absent
    when the DISK variant's weights are), ``n_ref``, ``n_cur``, ``ref_uv``,
    ``matched_uv``, ``status`` and ``tracked``; and ``png``."""
    dev = resolve_device(device)
    detector = SuperPointDetector.from_file(max_features=MAX_FEATURES,
                                            min_response=0.01, device=dev)
    opts = NNMatcherOptions(
        max_number_of_matches=MAX_FEATURES,
        min_valid_match_score=math.log(0.03),
        model_type=NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT,
        depth=9)
    matcher = (NNFeatureMatcher.from_file(opts, device=dev) if detector
               else None)
    kind = "pretrained weights"
    if detector is None or matcher is None:
        detector = detector or SuperPointDetector.init_random(
            0, max_features=MAX_FEATURES, device=dev)
        matcher = NNFeatureMatcher(NNMatcherOptions(
            max_number_of_matches=MAX_FEATURES,
            min_valid_match_score=math.log(0.03),
            model_type=NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT,
            depth=4), device=dev)
        kind = "untrained weights (run train/pretrain.py)"
    report_info(f">> Test NN feature matcher with LightGlue "
                f"({source} imagery, {kind}).")

    timer = TickTock()
    matcher.initialize()
    report_info(f"Matcher warm-up in {timer.tock_tick_ms():.0f} ms.")

    out = {"kind": kind, "png": {}}
    detected = _detect(detector, ref, cur, dev)
    report_info(f"Detected {int(detected[2])} / {int(detected[5])} features "
                f"in {timer.tock_tick_ms():.0f} ms (incl. compile).")
    n_ref, n_cur, ref_uv, matched_uv, status = _match(matcher, detected)
    tracked = int((status == int(TrackStatus.TRACKED)).sum())
    report_info(f"Matched {tracked} / {n_ref} features in "
                f"{timer.tock_tick_ms():.0f} ms (incl. compile).")
    out["superpoint"] = {"n_ref": n_ref, "n_cur": n_cur, "ref_uv": ref_uv,
                         "matched_uv": matched_uv, "status": status,
                         "tracked": tracked}
    png = {"nn_matcher_lightglue.png": render_matches(ref, cur, ref_uv,
                                                      matched_uv, status)}
    _common.save_pngs(png, out_dir)
    out["png"].update(png)

    # DISK-descriptor variant (the reference's disk_lightglue family,
    # nn_feature_matcher.h:16-21) when both weight files exist.
    disk_det = DiskDetector.from_file(max_features=MAX_FEATURES, device=dev)
    disk_opts = NNMatcherOptions(
        max_number_of_matches=MAX_FEATURES,
        min_valid_match_score=math.log(0.03),
        model_type=NNMatcherModelType.LIGHTGLUE_DISK_SCORE_MAT,
        depth=9)
    disk_matcher = (NNFeatureMatcher.from_file(disk_opts, device=dev)
                    if disk_det is not None else None)
    if disk_det is None or disk_matcher is None:
        report_info("DISK+LightGlue variant skipped (weights absent).")
        return out
    timer.tock_tick_ms()
    nr, nc, ruv, muv, st = _match(disk_matcher,
                                  _detect(disk_det, ref, cur, dev))
    tracked = int((st == int(TrackStatus.TRACKED)).sum())
    report_info(f"DISK+LightGlue matched {tracked} / {nr} features "
                f"in {timer.tock_tick_ms():.0f} ms (incl. compile).")
    out["disk"] = {"n_ref": nr, "n_cur": nc, "ref_uv": ruv,
                   "matched_uv": muv, "status": st, "tracked": tracked}
    png = {"nn_matcher_lightglue_disk.png": render_matches(ref, cur, ruv,
                                                           muv, st)}
    _common.save_pngs(png, out_dir)
    out["png"].update(png)
    return out


def main():
    args = _common.parse_args(__doc__)
    ref, cur, source = _common.load_optical_flow_pair()
    run(ref, cur, source, device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
