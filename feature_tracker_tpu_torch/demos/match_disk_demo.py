"""DISK detection + cosine matching demo — the port of
``demos/match_disk_demo.py`` (reference:
test/test_descriptor_matcher_disk.cpp:37-86). The DISK U-Net runs on the
shipped ``weights/disk.npz`` (randomly initialised from seed 0 when the
file is absent): detect -> describe (128-d) -> cosine nearby-match.

    python -m feature_tracker_tpu_torch.demos.match_disk_demo [--device cpu]
"""

from __future__ import annotations

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.demos import _common
from feature_tracker_tpu_torch.models.disk import DiskDetector
from feature_tracker_tpu_torch.utils import report_info

MAX_FEATURES = 300


def run(ref, cur, source="synthetic", *, device="cuda",
        out_dir=None) -> dict:
    """Detect and describe both frames, match by cosine distance. Returns
    ``kind`` (pretrained or untrained weights), ``n_ref``, ``n_cur``, the
    detections, ``matched_uv``, ``status``, ``tracked`` and ``png``."""
    dev = resolve_device(device)
    detector = DiskDetector.from_file(max_features=MAX_FEATURES, device=dev)
    kind = "pretrained weights"
    if detector is None:
        detector = DiskDetector.init_random(0, max_features=MAX_FEATURES,
                                            device=dev)
        kind = "untrained weights (run train/pretrain.py)"
    report_info(f">> Test feature point matcher with DISK "
                f"({source} imagery, {kind}).")
    out = _common.cosine_match(detector, ref, cur)
    out["kind"] = kind
    out["png"] = {"match_disk.png": out.pop("canvas")}
    _common.save_pngs(out["png"], out_dir)
    return out


def main():
    args = _common.parse_args(__doc__)
    ref, cur, source = _common.load_optical_flow_pair()
    run(ref, cur, source, device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
