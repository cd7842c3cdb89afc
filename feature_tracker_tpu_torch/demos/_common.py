"""Shared plumbing of the port's demos: data location with a synthetic
fallback, the output directory and the command line.

The counterpart of ``demos/_common.py``. Input imagery comes from the
reference's example images where ``FTK_DATA`` (default: where the JAX demos
read them) holds them; without them a deterministic synthetic textured pair
is generated, bit for bit the JAX demos' fallback, so every demo still runs
end to end. PNGs go to ``feature_tracker_tpu_torch/demos/output/`` (or
``--out``), never to ``demos/output/``, which holds the JAX demos' images.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

DATA_ROOT = os.environ.get(
    "FTK_DATA", os.path.join(os.sep, "root", "reference", "example"))
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")


def out_path(name: str, out_dir: str | None = None) -> str:
    """Path of the PNG ``name`` under ``out_dir`` (default ``OUT_DIR``),
    creating the directory."""
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, name)


def save_pngs(pngs: dict, out_dir: str | None, say: str | None = "Wrote"
              ) -> None:
    """Write each ``{name: image}`` of a demo's result under ``out_dir``,
    logging ``"{say} {path}"`` unless ``say`` is None; nothing is written
    when ``out_dir`` is None."""
    from feature_tracker_tpu_torch.utils import report_info
    from feature_tracker_tpu_torch.utils.viz import save_png

    if out_dir is None:
        return
    for name, image in pngs.items():
        path = out_path(name, out_dir)
        save_png(path, image)
        if say is not None:
            report_info(f"{say} {path}")


def cosine_match(detector, ref, cur) -> dict:
    """The two descriptor-matching demos' shared body: detect and describe
    both frames, cosine distances, nearby match, fill. Returns ``n_ref``,
    ``n_cur``, ``ref_uv`` / ``cur_uv``, ``matched_uv``, ``status``,
    ``tracked`` and the side-by-side ``canvas``."""
    from feature_tracker_tpu_torch.core.status import TrackStatus
    from feature_tracker_tpu_torch.match.matcher import (
        cosine_distance_matrix,
        fill_matched_pixels,
        nearby_match,
    )
    from feature_tracker_tpu_torch.utils import TickTock, report_info
    from feature_tracker_tpu_torch.utils.viz import render_matches

    timer = TickTock()
    ref_uv, ref_desc, n_ref = detector.detect(ref)
    cur_uv, cur_desc, n_cur = detector.detect(cur)
    n_ref, n_cur = int(n_ref), int(n_cur)
    report_info(f"Detected {n_ref} / {n_cur} features in "
                f"{timer.tock_tick_ms():.1f} ms (incl. compile).")

    dist = cosine_distance_matrix(ref_desc[:n_ref], cur_desc[:n_cur])
    idx = nearby_match(dist, ref_uv[:n_ref], cur_uv[:n_cur],
                       max_valid_distance=0.1,
                       max_col_distance=50.0, max_row_distance=50.0)
    matched_uv, status = fill_matched_pixels(idx, cur_uv[:n_cur])
    status = status.cpu().numpy()
    tracked = int((status == int(TrackStatus.TRACKED)).sum())
    report_info(f"Matched {tracked} / {n_ref} features "
                f"in {timer.tock_tick_ms():.1f} ms.")

    ref_uv = ref_uv[:n_ref].cpu().numpy()
    matched_uv = matched_uv.cpu().numpy()
    return {"n_ref": n_ref, "n_cur": n_cur, "ref_uv": ref_uv,
            "cur_uv": cur_uv[:n_cur].cpu().numpy(),
            "matched_uv": matched_uv, "status": status, "tracked": tracked,
            "canvas": render_matches(ref, cur, ref_uv, matched_uv, status)}


def parse_args(description: str) -> argparse.Namespace:
    """``--device`` (default ``cuda``: without a card the demo raises
    unless given ``--device cpu``) and ``--out`` (default ``OUT_DIR``)."""
    parser = argparse.ArgumentParser(description=description.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("--out", default=OUT_DIR,
                        help="directory for the PNGs (default: %(default)s)")
    return parser.parse_args()


def _synthetic_texture(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    # Smooth upsample so gradients exist everywhere.
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    k = np.ones(5, np.float32) / 5.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return img


def load_optical_flow_pair():
    """The 752x480 gray pair of the reference's optical-flow demos
    (reference: test_optical_flow.cpp:31-32); synthetic fallback: a
    texture rolled by 5 rows and -3 columns, so the true flow is
    (dx, dy) = (-3, +5) px away from the wrapped border."""
    from feature_tracker_tpu_torch.utils.viz import load_gray_image
    ref_p = os.path.join(DATA_ROOT, "optical_flow", "ref_image.png")
    cur_p = os.path.join(DATA_ROOT, "optical_flow", "cur_image.png")
    if os.path.exists(ref_p) and os.path.exists(cur_p):
        return load_gray_image(ref_p), load_gray_image(cur_p), "reference"
    ref = _synthetic_texture(480, 752, 0)
    shift_r, shift_c = 5, -3
    cur = np.roll(np.roll(ref, shift_r, axis=0), shift_c, axis=1)
    return ref, cur, "synthetic"


def load_direct_method_set():
    """KITTI-style left + disparity + 5 current frames
    (reference: test_direct_method.cpp:21-26); synthetic fallback: a
    1240x376 texture at disparity 64, frame i rolled by 2(i+1) px along u."""
    from feature_tracker_tpu_torch.utils.viz import load_gray_image
    root = os.path.join(DATA_ROOT, "direct_method")
    names = [f"{i:06d}.png" for i in range(1, 6)]
    paths = ([os.path.join(root, "left.png"),
              os.path.join(root, "disparity.png")]
             + [os.path.join(root, n) for n in names])
    if all(os.path.exists(p) for p in paths):
        imgs = [load_gray_image(p) for p in paths]
        return imgs[0], imgs[1], imgs[2:], "reference"
    left = _synthetic_texture(376, 1240, 1)
    disparity = np.full_like(left, 64.0)
    curs = [np.roll(left, 2 * (i + 1), axis=1) for i in range(5)]
    return left, disparity, curs, "synthetic"
