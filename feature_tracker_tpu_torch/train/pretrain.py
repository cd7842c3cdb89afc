"""Synthetic training pairs of the pretraining driver — the counterpart of
the first part of ``feature_tracker_tpu/train/pretrain.py``.

``warped_texture_pair`` makes (img_a, img_b, warp): a band-limited analytic
texture (or a crop of real imagery, when there is any) and its similarity
warp with photometric augmentation, in numpy, drawing from a
``numpy.random.Generator`` exactly as the JAX package does, so a seed gives
the same images bit for bit. ``train/raft_pretrain.py`` trains RAFT on
them. The multi-stage driver of the rest of that module (SuperPoint
adaptation and distillation, DISK, LightGlue on SuperPoint's keypoints,
the reference-pair counts, ``main``) is not ported yet: ROADMAP.md
section 1, item 8b.
"""

from __future__ import annotations

import os

import numpy as np


# ------------------------------------------------------- synthetic data

class _Texture:
    """Band-limited analytic texture (evaluable at any real coordinate),
    mirroring tests/synthetic.py's generator."""

    def __init__(self, rng, n_waves=24, min_period=6.0, max_period=60.0):
        periods = rng.uniform(min_period, max_period, size=n_waves)
        angles = rng.uniform(0, 2 * np.pi, size=n_waves)
        self.fx = np.cos(angles) / periods
        self.fy = np.sin(angles) / periods
        self.phase = rng.uniform(0, 2 * np.pi, size=n_waves)
        self.amp = rng.uniform(0.5, 1.0, size=n_waves)

    def eval(self, x, y):
        x = np.asarray(x, np.float64)[..., None]
        y = np.asarray(y, np.float64)[..., None]
        v = np.sum(self.amp * np.sin(
            2 * np.pi * (self.fx * x + self.fy * y) + self.phase), axis=-1)
        return (v / np.sum(self.amp) * 0.5 + 0.5) * 255.0


_REAL_POOL = None
# Real imagery: the KITTI-style direct-method frames of the reference
# sources, looked for beside the packages (a checkout carries none, and
# the pool is then empty, as the JAX package's is without its mount).
REFERENCE_FRAMES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "reference", "example",
    "direct_method")


def _real_image_pool():
    """Real-world training imagery: the KITTI-style direct-method frames
    under ``REFERENCE_FRAMES`` (disjoint from the optical-flow pair the
    demos and tests evaluate on). Loaded lazily; [] when absent."""
    global _REAL_POOL
    if _REAL_POOL is None:
        _REAL_POOL = []
        try:
            from PIL import Image
            for name in ("left.png", "000001.png", "000002.png",
                         "000003.png", "000004.png", "000005.png"):
                p = os.path.join(REFERENCE_FRAMES, name)
                if os.path.exists(p):
                    _REAL_POOL.append(np.asarray(
                        Image.open(p).convert("L"), np.float32))
        except ImportError:
            pass
    return _REAL_POOL


def _bilinear_np(img, x, y):
    h, w = img.shape
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0 = x.astype(np.int64)
    y0 = y.astype(np.int64)
    fx = x - x0
    fy = y - y0
    return ((1 - fy) * (1 - fx) * img[y0, x0]
            + (1 - fy) * fx * img[y0, x0 + 1]
            + fy * (1 - fx) * img[y0 + 1, x0]
            + fy * fx * img[y0 + 1, x0 + 1]).astype(np.float32)


def _photometric(rng, img):
    """Gain/bias/noise augmentation, clipped to the 0..255 range."""
    gain = rng.uniform(0.7, 1.3)
    bias = rng.uniform(-25, 25)
    noise = rng.normal(0, rng.uniform(0.5, 3.0), img.shape)
    return np.clip(gain * img + bias + noise, 0, 255).astype(np.float32)


def warped_texture_pair(rng, h, w, max_theta=0.25, max_shift=12.0,
                        use_real: bool | None = None, augment=True,
                        scale_lo=0.9, scale_hi=1.12):
    """(img_a, img_b, warp) with img_b(q) = img_a(warp^-1(q)); a point at
    p in a appears at warp(p) = R_s p + t in b. Half the samples come
    from random crops of real imagery (_real_image_pool) so descriptors
    see natural statistics, half from analytic textures; img_b gets
    photometric augmentation."""
    pool = _real_image_pool()
    if use_real is None:
        use_real = len(pool) > 0 and rng.uniform() < 0.5
    theta = rng.uniform(-max_theta, max_theta)
    scale = rng.uniform(scale_lo, scale_hi)
    c, s = np.cos(theta) * scale, np.sin(theta) * scale
    rot = np.array([[c, -s], [s, c]], np.float64)
    center = np.array([w / 2.0, h / 2.0])
    t = center + rng.uniform(-max_shift, max_shift, 2) - rot @ center
    rinv = np.linalg.inv(rot)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    src = np.stack([xx - t[0], yy - t[1]], -1) @ rinv.T

    if use_real and pool:
        img = pool[rng.integers(len(pool))]
        ih, iw = img.shape
        margin = 40
        ox = rng.uniform(margin, iw - w - margin)
        oy = rng.uniform(margin, ih - h - margin)
        img_a = _bilinear_np(img, xx + ox, yy + oy)
        img_b = _bilinear_np(img, src[..., 0] + ox, src[..., 1] + oy)
    else:
        tex = _Texture(rng)
        img_a = tex.eval(xx, yy).astype(np.float32)
        img_b = tex.eval(src[..., 0], src[..., 1]).astype(np.float32)
    if augment:
        img_b = _photometric(rng, img_b)

    def warp(p):
        return p @ rot.T + t

    return img_a, img_b, warp
