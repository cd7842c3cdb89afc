"""Operation, byte and peak arithmetic of the benchmark's metrics.

The KLT, lookup and bound functions are copies of ``chip_smoke.py``'s
(``klt_work``, ``lookup_work``, ``bound``), held to its numbers by
``benchmark/tests/test_bench_work.py``; RAFT's FLOP count is worked out here
from the configuration's convolution shapes.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
BF16_FLOPS = 989e12        # bfloat16 on the tensor cores, dense


def bound(nbytes, flops):
    """(least ms the card could take, which resource bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def klt_work(opts, pyr_shapes, n, n_tracked, steps):
    """(bytes, FLOPs) the whole-pyramid basic KLT in FAST mode needs on these
    inputs: each pyramid level of both frames read once, uv/skip in and
    uv/status out once; per tracked feature and level the reference setup,
    and per Gauss-Newton step actually taken the resample, residual,
    products and solve."""
    pix = sum(h * w for h, w in pyr_shapes)
    nbytes = 2 * pix * 4 + n * (8 + 8 + 1) + n * (8 + 1)
    ex_n = opts["ex_patch_rows"] * opts["ex_patch_cols"]
    p_n = opts["patch_rows"] * opts["patch_cols"]
    setup = ex_n * 7 + p_n * 8 + 10    # bilinear taps; grads and H
    per_step = p_n * 12 + 14           # taps, dt, b; solve and update
    flops = n_tracked * len(pyr_shapes) * setup + int(steps) * per_step
    return nbytes, flops


def pyramid_flops(height, width, levels):
    """Operations of the floor-quantised 2x2-mean pyramid: per output pixel
    of each level above the first, three adds, a multiply and a floor; one
    floor per pixel of level 0."""
    ops, h, w = height * width, height, width
    for _ in range(levels - 1):
        h, w = h // 2, w // 2
        ops += 5 * h * w
    return ops


def shi_tomasi_flops(height, width, window_half_size, candidates):
    """Operations of one detection: central differences (2 per pixel and
    direction), the three products and their box filters (2k adds each way
    and a divide), the minimum eigenvalue (~9), the 3x3 local maximum (8
    compares) and threshold, and the greedy suppression's distance matrix
    over the candidates (5 per pair)."""
    k = 2 * window_half_size + 1
    per_pixel = 4 + 3 + 3 * (2 * k + 1) + 9 + 8 + 2
    return height * width * per_pixel + 5 * candidates * candidates


def lookup_work(shape, pyramid_shapes, locations, radius):
    """(bytes, FLOPs) of one correlation lookup on these inputs: fmap0,
    every level and the locations read once, the output written once; the
    scaling of fmap0; a dot product over C for every grid pixel that lies
    inside its map (a pixel outside costs nothing, a runaway location has
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
        corner = torch.floor(locations.double() / 2 ** lvl) - radius
        ok = torch.isfinite(corner).all(-1) & (corner.abs() < 2 ** 30).all(-1)
        corner = corner[ok]
        nx = (torch.clamp(corner[:, 0] + k + 1, max=p[2])
              - torch.clamp(corner[:, 0], min=0)).clamp(min=0)
        ny = (torch.clamp(corner[:, 1] + k + 1, max=p[1])
              - torch.clamp(corner[:, 1], min=0)).clamp(min=0)
        dots += int((nx * ny).sum())
    return nbytes, f0_n + dots * 2 * c + out_n * 7


def conv_flops(k_h, k_w, c_in, c_out, h_out, w_out, batch=1):
    """Multiply-adds of one convolution, counted as two operations."""
    return 2 * k_h * k_w * c_in * c_out * h_out * w_out * batch


def encoder_flops(c_in, c_out, height, width, batch):
    """FLOPs of one ``FeatureEncoder`` pass: the 7x7 stem, six residual
    blocks (widths c/4, c/4, c/2, c/2, 3c/4, 3c/4, c; stride 2 in blocks 1,
    3 and 5, with a 1x1 projection where the width or stride changes) and
    the 3x3 output convolution."""
    step = c_out // 4
    widths = (step, step, step * 2, step * 2, step * 3, step * 3, c_out)
    h, w = height, width
    total = conv_flops(7, 7, c_in, step, h, w, batch)
    for i in range(6):
        stride = 1 + i % 2
        ci, co = widths[i], widths[i + 1]
        h, w = (h + stride - 1) // stride, (w + stride - 1) // stride
        total += conv_flops(3, 3, ci, co, h, w, batch)
        total += conv_flops(3, 3, co, co, h, w, batch)
        if stride != 1 or ci != co:
            total += conv_flops(1, 1, ci, co, h, w, batch)
    return total + conv_flops(3, 3, c_out, c_out, h, w, batch)


def update_block_flops(cfg, h, w, batch):
    """FLOPs of one ``UpdateBlock`` call at the 1/8 grid ``h x w``: the
    motion encoder, the separable ConvGRU (1x5 then 5x1, gates z, r, q) and
    the flow and mask heads."""
    k = 2 * cfg["correlation_radius"] + 1
    corr_in = cfg["correlation_pyramid_levels"] * k * k
    ch = cfg["correlation_hidden_channels"]
    co = cfg["correlation_out_channels"]
    fh, fo = cfg["flow_hidden_channels"], cfg["flow_out_channels"]
    mo, hid = cfg["motion_out_channels"], cfg["hidden_channels"]
    x_in = cfg["context_channels"] + mo
    mh = cfg["mask_hidden_channels"]
    convs = [(1, 1, corr_in, ch), (3, 3, ch, co), (7, 7, 2, fh),
             (3, 3, fh, fo), (3, 3, co + fo, mo - 2)]
    convs += [(1, 5, x_in + hid, hid)] * 3 + [(5, 1, x_in + hid, hid)] * 3
    convs += [(3, 3, hid, fo), (3, 3, fo, 2), (3, 3, hid, mh),
              (1, 1, mh, 8 * 8 * 9)]
    return sum(conv_flops(kh, kw, ci, co_, h, w, batch)
               for kh, kw, ci, co_ in convs)


def upsample_flops(h, w, batch):
    """Convex 8x upsampling: a softmax over 9 neighbours (~4 operations
    each) and 9 multiply-adds for each of the two flow channels, per output
    pixel."""
    return batch * h * w * 64 * (9 * 4 + 9 * 2 * 2)


def raft_flops(cfg, batch, height, width, lookup_flops_per_iter):
    """FLOPs of one ``Raft.forward`` in inference: the feature encoder over
    both images, the context encoder over the first, ``max_iterations``
    update blocks and lookups (``lookup_flops_per_iter`` from
    :func:`lookup_work` on the call's own locations) and one upsampling
    (``upsample_last_only``) or one per iteration."""
    h8, w8 = height // 8, width // 8
    iters = cfg["max_iterations"]
    enc = (encoder_flops(cfg["in_channels"], cfg["feature_channels"],
                         height, width, 2 * batch)
           + encoder_flops(cfg["in_channels"],
                           cfg["context_channels"] + cfg["hidden_channels"],
                           height, width, batch))
    ups = 1 if cfg["upsample_last_only"] else iters
    return (enc + iters * (update_block_flops(cfg, h8, w8, batch)
                           + lookup_flops_per_iter)
            + ups * upsample_flops(h8, w8, batch))
