"""PNG rendering of detections, tracks, matches and dense flow.

File-writing equivalent of the reference's Visualizor2D windows: the
tracked-feature overlay, the side-by-side match display and the flow-vector
overlay. All drawing is numpy (disk stamping and sampled line segments);
PIL is imported only inside ``load_gray_image`` and ``save_png``, so the
rest works without it. Arrays may be numpy or tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from feature_tracker_tpu_torch.core.status import TrackStatus

# RGB colors matching the reference's RgbColor choices.
COLOR_TRACKED = (0, 255, 0)       # green
COLOR_FAILED = (255, 0, 0)        # red
COLOR_REF = (0, 255, 255)         # cyan
COLOR_LINE = (0, 180, 0)          # darker green for flow lines
COLOR_DETECT = (0, 255, 0)


def _host(x, dtype=None) -> np.ndarray:
    """``x`` as a numpy array (a tensor is copied to the host first)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def load_gray_image(path) -> np.ndarray:
    """Load an image file as float32 grayscale [H, W] in 0..255."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("L"), np.float32)


def save_png(path, img: np.ndarray) -> None:
    """Write a [H, W] gray or [H, W, 3] RGB uint8/float array as PNG."""
    from PIL import Image
    arr = _host(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def to_rgb(gray: np.ndarray) -> np.ndarray:
    """Gray float [H, W] -> RGB uint8 [H, W, 3]."""
    g = np.clip(_host(gray), 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def _valid_mask(uv, h, w):
    return ((uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h))


def draw_points(rgb: np.ndarray, uv, color, radius: int = 2) -> None:
    """Stamp filled disks at (x, y) positions, in place."""
    h, w = rgb.shape[:2]
    uv = _host(uv, np.float32).reshape(-1, 2)
    uv = uv[_valid_mask(uv, h, w)]
    if uv.size == 0:
        return
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (dx * dx + dy * dy) <= radius * radius
    offs = np.stack([dx[disk], dy[disk]], -1)  # [K, 2] (dx, dy)
    pts = np.round(uv).astype(np.int64)[:, None, :] + offs[None, :, :]
    x = np.clip(pts[..., 0], 0, w - 1).reshape(-1)
    y = np.clip(pts[..., 1], 0, h - 1).reshape(-1)
    rgb[y, x] = color


def draw_lines(rgb: np.ndarray, uv0, uv1, color) -> None:
    """Draw line segments uv0[i] -> uv1[i], in place (sampled points)."""
    h, w = rgb.shape[:2]
    uv0 = _host(uv0, np.float32).reshape(-1, 2)
    uv1 = _host(uv1, np.float32).reshape(-1, 2)
    for a, b in zip(uv0, uv1):
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        pts = np.round(a[None, :] * (1 - t) + b[None, :] * t).astype(np.int64)
        keep = ((pts[:, 0] >= 0) & (pts[:, 0] < w)
                & (pts[:, 1] >= 0) & (pts[:, 1] < h))
        pts = pts[keep]
        rgb[pts[:, 1], pts[:, 0]] = color


def render_detected_features(gray, uv, num=None, radius: int = 2):
    """Detected-feature overlay (ShowImageWithDetectedFeatures)."""
    rgb = to_rgb(gray)
    uv = _host(uv)
    if num is not None:
        uv = uv[:int(_host(num))]
    draw_points(rgb, uv, COLOR_DETECT, radius)
    return rgb


def render_tracked_features(gray, ref_uv, cur_uv, status, radius: int = 2):
    """Single-image flow overlay: ref points cyan, tracked cur points green
    with flow lines, failed cur points red (single-image overload of
    ShowImageWithTrackedFeatures)."""
    rgb = to_rgb(gray)
    status = _host(status)
    ref_uv = _host(ref_uv, np.float32)
    cur_uv = _host(cur_uv, np.float32)
    ok = status == int(TrackStatus.TRACKED)
    draw_lines(rgb, ref_uv[ok], cur_uv[ok], COLOR_LINE)
    draw_points(rgb, ref_uv, COLOR_REF, max(radius - 1, 1))
    draw_points(rgb, cur_uv[ok], COLOR_TRACKED, radius)
    draw_points(rgb, cur_uv[~ok], COLOR_FAILED, radius)
    return rgb


def render_matches(ref_gray, cur_gray, ref_uv, cur_uv, status,
                   radius: int = 2):
    """Side-by-side match display (two-image overload of
    ShowImageWithTrackedFeatures): green connecting lines for matches."""
    ref_rgb = to_rgb(ref_gray)
    cur_rgb = to_rgb(cur_gray)
    h = max(ref_rgb.shape[0], cur_rgb.shape[0])
    w0, w1 = ref_rgb.shape[1], cur_rgb.shape[1]
    canvas = np.zeros((h, w0 + w1, 3), np.uint8)
    canvas[:ref_rgb.shape[0], :w0] = ref_rgb
    canvas[:cur_rgb.shape[0], w0:] = cur_rgb

    status = _host(status)
    ref_uv = _host(ref_uv, np.float32)
    cur_uv = _host(cur_uv, np.float32) + np.array([w0, 0], np.float32)
    ok = status == int(TrackStatus.TRACKED)
    draw_lines(canvas, ref_uv[ok], cur_uv[ok], COLOR_LINE)
    draw_points(canvas, ref_uv[ok], COLOR_TRACKED, radius)
    draw_points(canvas, ref_uv[~ok], COLOR_FAILED, radius)
    draw_points(canvas, cur_uv[ok], COLOR_TRACKED, radius)
    return canvas


def render_dense_flow(gray, flow, step: int = 15, radius: int = 1):
    """Flow-vector grid overlay (test_dense_optical_flow.cpp:51-65):
    sample the [2, H, W] (row-flow, col-flow) field every ``step`` pixels
    and draw start points + displaced end points + lines."""
    flow = _host(flow)
    h, w = flow.shape[-2:]
    rr = np.arange(step, h - step, step)
    cc = np.arange(step, w - step, step)
    grid_r, grid_c = np.meshgrid(rr, cc, indexing="ij")
    start = np.stack([grid_c, grid_r], -1).reshape(-1, 2).astype(np.float32)
    dr = flow[0][grid_r, grid_c].reshape(-1)
    dc = flow[1][grid_r, grid_c].reshape(-1)
    end = start + np.stack([dc, dr], -1)

    rgb = to_rgb(gray)
    draw_lines(rgb, start, end, COLOR_LINE)
    draw_points(rgb, start, COLOR_REF, radius)
    draw_points(rgb, end, COLOR_TRACKED, radius)
    return rgb
