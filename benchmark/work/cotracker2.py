"""Operation and byte arithmetic of the ``cotracker2_online`` cell: the FLOPs
of one window of the port's CoTracker2 (``models/cotracker2.py``) worked
out from the configuration's shapes, and kernel 5's bytes and FLOPs in
border mode on a launch's own locations.

Counted as two operations a multiply-add: the encoder's convolutions, every
linear layer of the former and of the heads, and the attention's two
products; the lookup as ``lookup_work_border`` counts it. Normalisations,
activations, the resizes and the embeddings are left out (a few per cent
of a window's elementwise work, none of its products).
"""

from __future__ import annotations

import math

from benchmark.work import conv_flops


def _half(n):
    return (n + 1) // 2


def encoder_flops(cfg, frames):
    """``BasicEncoder`` over ``frames`` frames at ``model_resolution``: the
    7x7 stride-2 stem, four stages of two residual blocks (two 3x3
    convolutions each, a 1x1 projection in the first block of the strided
    stages), the 3x3 and 1x1 convolutions of the concatenated stages at
    stride 4."""
    lat = cfg["latent_dim"]
    h, w = (_half(n) for n in cfg["model_resolution"])
    total = conv_flops(7, 7, 3, lat // 2, h, w, frames)
    widths = (lat // 2, lat // 4 * 3, lat, lat)
    c_in = lat // 2
    for i, c in enumerate(widths):
        if i:
            h, w = _half(h), _half(w)
            total += conv_flops(1, 1, c_in, c, h, w, frames)
        total += conv_flops(3, 3, c_in, c, h, w, frames)
        total += 3 * conv_flops(3, 3, c, c, h, w, frames)
        c_in = c
    h4, w4 = (n // cfg["stride"] for n in cfg["model_resolution"])
    return (total + conv_flops(3, 3, sum(widths), 2 * lat, h4, w4, frames)
            + conv_flops(1, 1, 2 * lat, lat, h4, w4, frames))


def former_flops(cfg, tracks):
    """One ``EfficientUpdateFormer`` call on ``tracks`` tracks over a window:
    ``input_transform``, the time blocks over the tracks and virtual tracks,
    the three space blocks per frame, ``flow_head``."""
    s, d = cfg["window_len"], cfg["hidden_size"]
    v = cfg["num_virtual_tracks"]
    mlp = 2 * 2 * d * int(d * cfg["mlp_ratio"])      # fc1 and fc2, a token
    n = tracks
    total = 2 * n * s * cfg["input_dim"] * d
    total += 2 * n * s * d * (cfg["latent_dim"] + 2)
    time_block = (n + v) * s * (2 * 4 * d * d + mlp + 4 * s * d)
    virtual_block = s * v * (2 * 4 * d * d + mlp + 4 * v * d)
    # Queries from the first argument, keys and values from the second.
    to_points = s * (v * (2 * 2 * d * d + mlp) + n * 2 * 2 * d * d
                     + 4 * v * n * d)
    from_points = s * (n * (2 * 2 * d * d + mlp) + v * 2 * 2 * d * d
                       + 4 * n * v * d)
    total += cfg["time_depth"] * time_block
    return total + cfg["space_depth"] * (virtual_block + to_points
                                         + from_points)


def window_flops(cfg, tracks, lookup_flops):
    """One window, ``iterations`` times the former, the track-feature
    update (``Linear(128, 128)`` a token) and the lookup
    (``lookup_flops`` a launch), then the visibility head."""
    lat, s = cfg["latent_dim"], cfg["window_len"]
    per_iter = (former_flops(cfg, tracks) + 2 * tracks * s * lat * lat
                + lookup_flops)
    return cfg["iterations"] * per_iter + 2 * tracks * s * lat


def call_flops(cfg, tracks, lookup_flops):
    """A call of ``CoTracker2Online.step`` that runs a window: the encoder
    over the window's ``window_len`` frames (the release re-encodes the
    frames it shares with the window before) and the window."""
    return (encoder_flops(cfg, cfg["window_len"])
            + window_flops(cfg, tracks, lookup_flops))


def lookup_work_border(shape, pyramid_shapes, locations, radius):
    """(bytes, FLOPs) of one launch of kernel 5 in border mode on these
    inputs: fmap0, every level and the locations read once, the output
    written once; the scaling of fmap0; a dot product over C for every
    pixel of a query's ``(2r+2)^2`` grid that lies in its map, the grid's
    corner ``floor(location / 2^l) - r`` taken after the centre is clamped
    into ``[-r, w_l - 1 + r] x [-r, h_l - 1 + r]`` (border mode's samples
    all lie in the map, so every query has work; a NaN or infinite one has
    none); the four-tap blend of every output value.

    ``shape``: fmap0's ``(B, H, W, C)``; ``pyramid_shapes``: each level's
    ``(B, h, w, C)``; ``locations``: ``[B, H, W, 2]`` tensor (x, y)."""
    import torch

    b, h, w, c = shape
    k = 2 * radius + 1
    out_n = b * h * w * len(pyramid_shapes) * k * k
    f0_n = b * h * w * c
    nbytes = 4 * (f0_n + sum(math.prod(p) for p in pyramid_shapes)
                  + locations.numel() + out_n)
    dots = 0
    for lvl, p in enumerate(pyramid_shapes):
        centre = locations.detach().cpu().double().reshape(-1, 2) / 2 ** lvl
        centre = centre[torch.isfinite(centre).all(-1)]
        hi = torch.tensor([p[2] - 1 + radius, p[1] - 1 + radius],
                          dtype=torch.float64)
        centre = torch.minimum(torch.maximum(centre, torch.full_like(
            hi, -radius)), hi)
        corner = torch.floor(centre) - radius
        nx = (torch.clamp(corner[:, 0] + k + 1, max=p[2])
              - torch.clamp(corner[:, 0], min=0)).clamp(min=0)
        ny = (torch.clamp(corner[:, 1] + k + 1, max=p[1])
              - torch.clamp(corner[:, 1], min=0)).clamp(min=0)
        dots += int((nx * ny).sum())
    return nbytes, f0_n + dots * 2 * c + out_n * 7
