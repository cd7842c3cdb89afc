"""DISK detector + descriptor, for inference and its trainer — the counterpart
of ``feature_tracker_tpu/models/disk.py``.

 - U-Net trunk: ``depth`` down blocks (two 3x3 convs + 2x2 average pool)
   and matching up blocks (2x bilinear upsample + skip concat + two 3x3
   convs), tanh-approximated gelu activations
 - head: 1x1 conv to descriptor_dim + 1 channels — channel 0 is the
   detection heatmap, channels 1..D are the dense full-resolution
   descriptor field
 - keypoints: the shared ``select_keypoints`` routine; descriptors
   bilinearly sampled at keypoints and L2-normalized.

Submodules carry the Flax model's automatic names in call order
(``Conv_0`` .. ``Conv_13`` the trunk, ``Conv_14`` the 1x1 head), so a weight
file's leaf path is its ``state_dict`` key
(``convert.py::disk_state_from_jax``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F
from torch import nn

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import (
    divide,
    gelu,
    seeded_init,
)
from feature_tracker_tpu_torch.models.raft import Conv, full_float32
from feature_tracker_tpu_torch.models.superpoint import (
    _bilinear_normalized,
    select_keypoints,
)


@dataclasses.dataclass(frozen=True)
class DiskConfig:
    descriptor_dim: int = 128
    base_channels: int = 32
    depth: int = 3
    dtype: torch.dtype = torch.float32


def _channels(cfg: DiskConfig):
    """``(in, out)`` channels of ``Conv_0`` .. ``Conv_{4 * depth + 1}`` in
    call order."""
    pairs, feats, c_in = [], cfg.base_channels, 1
    widths = []
    for _ in range(cfg.depth):
        pairs += [(c_in, feats), (feats, feats)]
        widths.append(feats)
        c_in, feats = feats, feats * 2
    pairs += [(c_in, feats), (feats, feats)]
    for skip in reversed(widths):
        pairs += [(feats + skip, skip), (skip, skip)]
        feats = skip
    return pairs


class Disk(nn.Module):
    """``forward(image)``: image ``[B, H, W, 1]`` in 0..255, H and W
    divisible by 2**cfg.depth. Returns (heatmap ``[B, H, W]``, descriptors
    ``[B, H, W, D]`` unnormalized). Runs on ``device`` (default ``"cuda"``)
    in ``eval()`` mode, under ``torch.inference_mode`` unless ``grad=True``
    (the trainer's form)."""

    def __init__(self, cfg: DiskConfig = DiskConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        pairs = _channels(cfg)
        for i, (c_in, c_out) in enumerate(pairs):
            setattr(self, f"Conv_{i}", Conv(c_in, c_out, 3, 1, cfg.dtype))
        setattr(self, f"Conv_{len(pairs)}",
                Conv(cfg.base_channels, cfg.descriptor_dim + 1, 1, 1,
                     torch.float32))
        self.to(self.device).to(memory_format=torch.channels_last)
        self.eval()

    def _double_conv(self, x, i: int):
        x = gelu(getattr(self, f"Conv_{i}")(x))
        return gelu(getattr(self, f"Conv_{i + 1}")(x))

    def forward(self, image, *, grad: bool = False):
        with torch.inference_mode(not grad), full_float32():
            c = self.cfg
            x = torch.as_tensor(image, dtype=torch.float32,
                                device=self.device)
            x = (divide(x, 255.0) - 0.5).to(c.dtype)
            skips, conv = [], 0
            for _ in range(c.depth):
                x = self._double_conv(x, conv)
                conv += 2
                skips.append(x)
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
            x = self._double_conv(x, conv)
            conv += 2
            for skip in reversed(skips):
                # jax.image.resize's bilinear 2x: half-pixel centres.
                x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                  mode="bilinear",
                                  align_corners=False).permute(0, 2, 3, 1)
                x = self._double_conv(torch.cat([x, skip], dim=-1), conv)
                conv += 2
            out = getattr(self, f"Conv_{conv}")(x)
            return out[..., 0], out[..., 1:]


def sample_descriptors_fullres(desc_map, uv):
    """Bilinear-sample L2-normalized descriptors from a full-resolution
    field ``[H, W, D]`` at (x, y) positions ``[K, 2]``."""
    return _bilinear_normalized(desc_map, uv)


class DiskDetector:
    """Detect-and-describe front end (NNFeaturePointDetector with
    kModelType=kDiskNms equivalent). ``variables`` is the ``state_dict`` of
    a ``Disk``; the model runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, variables, cfg: DiskConfig = DiskConfig(),
                 min_response: float = 0.0, min_feature_distance: int = 4,
                 max_features: int = 300, device="cuda"):
        self.model = Disk(cfg, device=device)
        self.model.load_state_dict(variables)
        self.variables = self.model.state_dict()
        self.min_response = min_response
        self.min_feature_distance = min_feature_distance
        self.max_features = max_features

    @classmethod
    def init_random(cls, rng, image_shape=(1, 120, 160, 1),
                    cfg: DiskConfig = DiskConfig(), **kw):
        """Randomly initialised weights drawn from ``rng`` (an int seed or a
        ``torch.Generator``); ``image_shape`` is accepted for the JAX
        signature."""
        del image_shape
        with seeded_init(rng):
            model = Disk(cfg, device="cpu")
        return cls(model.state_dict(), cfg, **kw)

    @classmethod
    def from_file(cls, path: str | None = None,
                  cfg: DiskConfig = DiskConfig(), **kw):
        """Pretrained weights (``weights/disk.npz``); None when absent."""
        from feature_tracker_tpu_torch.utils.weights import (
            load_disk_npz,
            weights_path,
        )
        path = path or weights_path("disk.npz")
        if not os.path.exists(path):
            return None
        return cls(load_disk_npz(path, cfg), cfg, **kw)

    def detect(self, image):
        """image: ``[H, W]`` 0..255. Returns (uv ``[K,2]``, descriptors
        ``[K,D]``, num). The image is padded at the bottom and right to a
        multiple of ``2**depth`` and the maps cropped back."""
        with torch.inference_mode(), full_float32():
            img = torch.as_tensor(image, dtype=torch.float32,
                                  device=self.model.device)
            h, w = img.shape
            step = 2 ** self.model.cfg.depth
            padded = F.pad(img, (0, (-w) % step, 0, (-h) % step))
            heat, desc = self.model(padded[None, :, :, None])
            uv, num = select_keypoints(heat[0, :h, :w], self.max_features,
                                       self.min_response,
                                       self.min_feature_distance)
            d = sample_descriptors_fullres(desc[0, :h, :w], uv)
            return uv, d, num
