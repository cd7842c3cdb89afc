"""Bilinear image sampling primitives, batched over features.

A position is valid when its floor anchor lies in ``[0, H-2] x [0, W-2]``
(the +1 bilinear taps must exist). Invalid taps read 0 and are masked.
Validity is decided on the floored *float*, before any cast: a position
that has run away (beyond the integer range, infinite or NaN) is invalid
by comparison, and only then is the anchor clamped and cast to an index.

Coordinates are ``(x, y) = (col, row)``.
"""

from __future__ import annotations

import torch

from feature_tracker_tpu_torch.ops.window import const_weights, tap_validity


def _gather4(img: torch.Tensor, ri: torch.Tensor, ci: torch.Tensor):
    """The 2x2 bilinear neighbourhood at integer anchors ``(ri, ci)``,
    clipped so the gather stays in range (callers mask with their own
    validity)."""
    h, w = img.shape
    rc = ri.clamp(0, h - 2)
    cc = ci.clamp(0, w - 2)
    return img[rc, cc], img[rc, cc + 1], img[rc + 1, cc], img[rc + 1, cc + 1]


def bilinear_sample(img: torch.Tensor, pos_xy: torch.Tensor):
    """Bounds-checked bilinear sample.

    Args:
      img: ``[H, W]`` float image.
      pos_xy: ``[..., 2]`` float positions (x=col, y=row).

    Returns ``(value [...], valid [...] bool)``. Invalid positions read 0.
    """
    h, w = img.shape
    x = pos_xy[..., 0]
    y = pos_xy[..., 1]
    r0 = torch.floor(y)
    c0 = torch.floor(x)
    fr = y - r0
    fc = x - c0
    valid = (r0 >= 0) & (r0 <= h - 2) & (c0 >= 0) & (c0 <= w - 2)
    # NaN compares false above; nan_to_num + clamp make the cast defined.
    ri = torch.nan_to_num(r0, nan=0.0).clamp(0, h - 2).to(torch.int64)
    ci = torch.nan_to_num(c0, nan=0.0).clamp(0, w - 2).to(torch.int64)
    tl, tr, bl, br = _gather4(img, ri, ci)
    val = ((1.0 - fr) * (1.0 - fc) * tl
           + (1.0 - fr) * fc * tr
           + fr * (1.0 - fc) * bl
           + fr * fc * br)
    return torch.where(valid, val, 0.0), valid


def extract_const_weight_patch(img: torch.Tensor, uv: torch.Tensor,
                               rows: int, cols: int):
    """Integer-grid patches around ``uv [N, 2]`` with constant bilinear
    weights.

    Each patch is anchored at ``floor(uv) - (rows//2, cols//2)`` and every
    pixel of it uses the same 4 bilinear weights, from uv's fractional
    part.

    Returns ``(patch [N, rows, cols], valid [N, rows, cols] bool)``."""
    r0, c0, wts = const_weights(uv)
    min_r = r0 - rows // 2
    min_c = c0 - cols // 2
    valid = tap_validity(tuple(img.shape), min_r, min_c, rows, cols)
    dev = img.device
    rr = min_r[:, None, None] + torch.arange(rows, device=dev)[:, None]
    cc = min_c[:, None, None] + torch.arange(cols, device=dev)[None, :]
    tl, tr, bl, br = _gather4(img, rr, cc)
    w_tl, w_tr, w_bl, w_br = (w[:, None, None] for w in wts)
    patch = w_tl * tl + w_tr * tr + w_bl * bl + w_br * br
    return torch.where(valid, patch, 0.0), valid


def inner_gradients(ex_patch: torch.Tensor, ex_valid: torch.Tensor):
    """Central-difference gradients on the inner region of extended
    patches ``[N, R+2, C+2]``: ``dx = right - left``, ``dy = bottom - top``
    (un-halved), zeroed wherever any of the 4 neighbour taps is invalid.

    Returns ``(dx [N, R, C], dy [N, R, C])``."""
    gvalid = (ex_valid[:, 1:-1, :-2] & ex_valid[:, 1:-1, 2:]
              & ex_valid[:, :-2, 1:-1] & ex_valid[:, 2:, 1:-1])
    dx = torch.where(gvalid,
                     ex_patch[:, 1:-1, 2:] - ex_patch[:, 1:-1, :-2], 0.0)
    dy = torch.where(gvalid,
                     ex_patch[:, 2:, 1:-1] - ex_patch[:, :-2, 1:-1], 0.0)
    return dx, dy
