"""Window-slice patch extraction, batched over features.

Every sample in a KLT patch shares one integer anchor and one set of
constant bilinear weights, so a feature's patch is one contiguous block of
the (zero-padded) image. The JAX package slices one block per feature under
``vmap``; here one advanced-index gather takes the ``[N, win, win]`` blocks
of all features at once, with the same clip of the anchor into the padded
image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Float coordinates are clamped to this magnitude before their floor is
# cast to an integer index: far beyond any image, so every tap of such a
# feature is invalid either way, and the index arithmetic cannot overflow.
_INDEX_LIMIT = float(1 << 30)


def pad_image(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the last two dimensions for clip-free window slicing."""
    return F.pad(img, (pad, pad, pad, pad))


def _anchor(f: torch.Tensor) -> torch.Tensor:
    return f.clamp(-_INDEX_LIMIT, _INDEX_LIMIT).to(torch.int64)


def const_weights(uv: torch.Tensor):
    """Integer anchor parts and the 4 constant bilinear weights of ``uv``.

    ``uv``: ``[..., 2]`` (x, y). Returns ``(r0, c0, (w_tl, w_tr, w_bl,
    w_br))``, each of shape ``[...]``."""
    x, y = uv[..., 0], uv[..., 1]
    r0 = torch.floor(y)
    c0 = torch.floor(x)
    fr = y - r0
    fc = x - c0
    w = ((1.0 - fr) * (1.0 - fc), (1.0 - fr) * fc, fr * (1.0 - fc), fr * fc)
    return _anchor(r0), _anchor(c0), w


def tap_validity(img_shape, min_r, min_c, rows: int, cols: int):
    """Validity of each integer tap position: anchor within [0, dim-2].

    ``min_r``, ``min_c``: integer tensors ``[...]``; returns bool
    ``[..., rows, cols]``."""
    h, w = img_shape
    dev = min_r.device
    rr = min_r[..., None, None] + torch.arange(rows, device=dev)[:, None]
    cc = min_c[..., None, None] + torch.arange(cols, device=dev)[None, :]
    return (rr >= 0) & (rr <= h - 2) & (cc >= 0) & (cc <= w - 2)


def slice_window(padded: torch.Tensor, pad: int, anchor_r, anchor_c,
                 window: int) -> torch.Tensor:
    """Gather the ``(window, window)`` block at each integer anchor (in
    unpadded coordinates). The anchor is clipped into the padded array;
    validity of out-of-image pixels is the caller's analytic mask.

    ``anchor_r``, ``anchor_c``: integer tensors ``[...]``; returns
    ``[..., window, window]``."""
    hp, wp = padded.shape[-2:]
    dev = padded.device
    r = (anchor_r + pad).clamp(0, hp - window)
    c = (anchor_c + pad).clamp(0, wp - window)
    offs = torch.arange(window, device=dev)
    rows = (r[..., None] + offs)[..., :, None]
    cols = (c[..., None] + offs)[..., None, :]
    return padded[rows, cols]


def bilinear_taps(block: torch.Tensor, rows: int, cols: int):
    """The 4 bilinear tap views ``(tl, tr, bl, br)`` of ``[..., win, win]``
    blocks with ``win >= rows + 1`` and ``win >= cols + 1``; each view is
    ``[..., rows, cols]``."""
    tl = block[..., :rows, :cols]
    tr = block[..., :rows, 1:cols + 1]
    bl = block[..., 1:rows + 1, :cols]
    br = block[..., 1:rows + 1, 1:cols + 1]
    return tl, tr, bl, br


def extract_patch_window(padded: torch.Tensor, pad: int, img_shape, uv,
                         rows: int, cols: int):
    """Constant-weight patch of each position from one window slice.

    ``padded``: the image zero-padded by ``pad`` (:func:`pad_image`);
    ``uv``: ``[..., 2]`` (x, y). Returns ``(patch [..., rows, cols],
    valid [..., rows, cols])``, the patch 0 where its tap is invalid.

    The window is square, ``rows + 1`` on a side, as in the JAX package,
    whose tap views come out too narrow when ``cols > rows`` and whose sum
    then fails on their shapes; such a patch is refused here."""
    if cols > rows:
        raise ValueError(f"extract_patch_window: cols ({cols}) > rows "
                         f"({rows}) does not fit its square window of "
                         f"rows + 1")
    r0, c0, weights = const_weights(uv)
    w_tl, w_tr, w_bl, w_br = (w[..., None, None] for w in weights)
    min_r = r0 - rows // 2
    min_c = c0 - cols // 2
    block = slice_window(padded, pad, min_r, min_c, rows + 1)
    tl, tr, bl, br = bilinear_taps(block, rows, cols)
    patch = w_tl * tl + w_tr * tr + w_bl * bl + w_br * br
    valid = tap_validity(img_shape, min_r, min_c, rows, cols)
    return torch.where(valid, patch, 0.0), valid
