"""BRIEF binary descriptor: 256 bits, half patch 8.

The sampling-pair table is a fixed, seeded pattern of offsets in
[-half, half] (the classic BRIEF construction); each bit is
I(p + o1) < I(p + o2) on integer pixels of a 3x3 box-smoothed image.

Features whose patch leaves the image get an all-zero descriptor and
``valid=False``; mask their distances with ``valid`` (to +inf).

The bits equal the JAX package's on either device: the box filter adds its
nine shifted views in the same order and then divides by 9 (a convolution
would reorder the sums, and ``<`` flips on near-ties), and the divisor is a
tensor on the image's device, so the card divides and does not multiply by
a rounded reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from feature_tracker_tpu_torch.ops.window import _anchor

def brief_pattern(length: int = 256, half: int = 8, seed: int = 7):
    """Deterministic ``[length, 2, 2]`` integer offset pairs (dx, dy)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-half, half + 1, size=(length, 2, 2)).astype(np.int32)


def _box_smooth(img: torch.Tensor) -> torch.Tensor:
    """3x3 box smoothing with a replicate border."""
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    h, w = img.shape
    acc = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            acc = acc + pad[i:i + h, j:j + w]
    return acc / torch.full((), 9.0, device=acc.device)


def compute_brief(img, uv, length: int = 256, half: int = 8, seed: int = 7):
    """BRIEF descriptors at integer-rounded feature positions.

    Args:
      img: ``[H, W]`` float image (numpy or tensor).
      uv: ``[N, 2]`` float (x, y) positions.

    Returns:
      (bits ``[N, length]`` uint8 in {0, 1}, valid ``[N]`` bool), on the
      device of ``img``.
    """
    img = torch.as_tensor(img, dtype=torch.float32)
    uv = torch.as_tensor(uv, dtype=torch.float32, device=img.device)
    h, w = img.shape
    pattern = torch.from_numpy(brief_pattern(length, half, seed)).to(
        img.device, torch.int64)                                # [L, 2, 2]
    smoothed = _box_smooth(img)
    # torch.round, like jnp.round, rounds half to even; positions far off
    # the image are clamped before the cast (and stay invalid).
    center = _anchor(torch.round(uv))                           # [N, 2] (x, y)
    # Margin: half for the offsets + 1 for the smoothing window.
    margin = half + 1
    valid = ((center[:, 0] >= margin) & (center[:, 0] < w - margin)
             & (center[:, 1] >= margin) & (center[:, 1] < h - margin))
    safe = torch.stack([center[:, 0].clamp(margin, w - margin - 1),
                        center[:, 1].clamp(margin, h - margin - 1)], -1)
    pos = safe[:, None, None, :] + pattern[None]                # [N, L, 2, 2]
    vals = smoothed[pos[..., 1], pos[..., 0]]                   # [N, L, 2]
    bits = (vals[..., 0] < vals[..., 1]).to(torch.uint8)
    return torch.where(valid[:, None], bits, 0).to(torch.uint8), valid


def pack_bits(bits):
    """Pack 0/1 bit rows ``[N, L]`` into ``[N, L/32]`` ``torch.uint32``
    words, bit k of a word being column k of its 32 (L must be a multiple
    of 32). The words are summed in int64, since torch's uint32 has few
    operations, and equal the JAX package's uint32 values."""
    bits = torch.as_tensor(bits)
    n, length = bits.shape
    words = bits.reshape(n, length // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (words << shifts).sum(-1).to(torch.uint32)
