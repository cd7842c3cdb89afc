"""Image pyramid construction: half resolution per level via 2x2 averaging.

``quantize=True`` floors every level, level 0 included, to match the uint8
arithmetic of the reference pyramid buffers; the KLT trackers are held to
the JAX package on these integer-valued levels bit for bit."""

from __future__ import annotations

import warnings

import torch

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.utils.profiling import host_value, span


def _build(img: torch.Tensor, levels: int, quantize: bool):
    pyr = [torch.floor(img) if quantize else img]
    for _ in range(levels - 1):
        a = pyr[-1]
        h2 = (a.shape[-2] // 2) * 2
        w2 = (a.shape[-1] // 2) * 2
        down = (a[..., 0:h2:2, 0:w2:2] + a[..., 1:h2:2, 0:w2:2]
                + a[..., 0:h2:2, 1:w2:2] + a[..., 1:h2:2, 1:w2:2]) * 0.25
        if quantize:
            down = torch.floor(down)
        pyr.append(down)
    return tuple(pyr)


def build_pyramid(img, levels: int, quantize: bool = True, device="cuda"):
    """Build a half-resolution-per-level pyramid.

    Args:
      img: ``[..., H, W]`` image (numpy or tensor), expected in gray-value
        range (uint8-derived, [0, 255]) when ``quantize=True``. Leading
        dimensions are a batch of frames.
      levels: total number of levels (level 0 included).
      quantize: floor every level to integer gray values.
      device: where the pyramid is built and kept.

    Returns:
      Tuple of ``levels`` float32 tensors on ``device``, finest first.

    Normalized [0, 1] imagery is destroyed by the floor of level 0 (every
    pixel becomes 0 or 1); a warning points to ``quantize=False`` when the
    input's value range suggests it.
    """
    with span("pyramid.build"):
        dev = resolve_device(device)
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        if quantize and img.numel():
            mx = host_value(img.max())
            if 0.0 < mx <= 1.5 and host_value(img.min()) >= 0.0 \
                    and host_value(torch.any(img != torch.floor(img))):
                warnings.warn(
                    "build_pyramid(quantize=True) floor-truncates level 0 "
                    f"to integers, but the input looks like normalized "
                    f"[0, 1] imagery (max={mx:.4g}) — the finest level "
                    "would collapse to 0/1. Pass quantize=False and track "
                    "with KltOptions(integer_pyramid=False), or scale the "
                    "image to gray values first.", stacklevel=2)
        return _build(img, levels, quantize)
