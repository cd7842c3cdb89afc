"""Operation arithmetic of the ``superpoint_lightglue`` configuration: the
products of one call (SuperPoint on the new frame, LightGlue on the previous
frame's features against the new frame's), counted as the port computes
them. A multiply-add is two operations; the normalisations, softmaxes,
activations, the rotary encoding's rotation, the keypoint selection and the
descriptor sampling are left out (each is a few operations per value
against the hundreds per value of the products), so the MFU they feed is a
floor.
"""

from __future__ import annotations

from benchmark.work import conv_flops

# SuperPoint's encoder: (input width, output width) of each 3x3
# convolution; a 2x2 max-pool follows the second, fourth and sixth.
ENCODER = ((1, 64), (64, 64), (64, 64), (64, 64), (64, 128), (128, 128),
           (128, 128), (128, 128))


def superpoint_flops(height, width, descriptor_dim=256):
    """FLOPs of one SuperPoint forward on a ``height x width`` frame: the
    encoder's eight 3x3 convolutions at full, half, quarter and eighth
    resolution; the detector head (3x3 128 -> 256, 1x1 256 -> 65) and the
    descriptor head (3x3 128 -> 256, 1x1 256 -> ``descriptor_dim``) at the
    eighth."""
    total, h, w = 0, height, width
    for i, (c_in, c_out) in enumerate(ENCODER):
        total += conv_flops(3, 3, c_in, c_out, h, w)
        if i in (1, 3, 5):
            h, w = h // 2, w // 2
    for c_out in (65, descriptor_dim):
        total += conv_flops(3, 3, 128, 256, h, w)
        total += conv_flops(1, 1, 256, c_out, h, w)
    return total


def _dense(tokens, c_in, c_out):
    return 2 * tokens * c_in * c_out


def self_unit_flops(n, dim):
    """One self-attention unit on ``n`` points: the qkv projection, the two
    attention products (``q k^T`` and ``a v``, over all heads), the output
    projection and the message MLP (2 dim -> 2 dim -> dim)."""
    return (_dense(n, dim, 3 * dim) + 2 * (2 * n * n * dim)
            + _dense(n, dim, dim) + _dense(n, 2 * dim, 2 * dim)
            + _dense(n, 2 * dim, dim))


def cross_unit_flops(n, m, dim):
    """One cross-attention unit between ``n`` and ``m`` points: the shared
    qk and v projections of both sides, two attention products in each
    direction (the port computes ``n -> m`` and ``m -> n`` apart), the
    output projection and the message MLP of both sides. The release
    computes the logits once and takes a softmax along each axis, so one
    logit product a unit (``2 n m dim``: 2.1 GFLOP at 2048 points, 19.3
    GFLOP of a call's 383.0, 5.0 %) is the port's duplicate, counted here
    as work."""
    side = _dense(1, dim, dim) * 3 + _dense(1, 2 * dim, 2 * dim) \
        + _dense(1, 2 * dim, dim)
    return (n + m) * side + 2 * (2 * 2 * n * m * dim)


def layer_flops(n, m, dim):
    """One LightGlue layer: a self unit on either image, then the cross
    unit."""
    return (self_unit_flops(n, dim) + self_unit_flops(m, dim)
            + cross_unit_flops(n, m, dim))


def lightglue_flops(n, m, dim=256, depth=9, descriptor_dim=256, heads=4):
    """FLOPs of one LightGlue forward at fixed capacities ``n`` and ``m``
    (the port runs every slot, masked or not): the rotary angles, the input
    projection, ``depth`` layers, the final projection, the similarity and
    the matchability head."""
    tokens = n + m
    return (_dense(tokens, 2, dim // heads // 2)
            + _dense(tokens, descriptor_dim, dim)
            + depth * layer_flops(n, m, dim)
            + _dense(tokens, dim, dim) + 2 * n * m * dim
            + _dense(tokens, dim, 1))


def call_flops(cfg):
    """FLOPs of one call of the configuration ``cfg`` (its JSON file, in
    the release's names: ``input_dim`` is SuperPoint's descriptor width,
    which LightGlue takes in, and ``descriptor_dim`` LightGlue's own
    width)."""
    height, width = cfg["image_size"]
    k = cfg["max_num_keypoints"]
    return (superpoint_flops(height, width, cfg["input_dim"])
            + lightglue_flops(k, k, cfg["descriptor_dim"], cfg["n_layers"],
                              cfg["input_dim"], cfg["num_heads"]))
