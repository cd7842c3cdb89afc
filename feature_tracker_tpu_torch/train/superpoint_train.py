"""SuperPoint detector training on synthetic corner geometry — the
counterpart of ``feature_tracker_tpu/train/superpoint_train.py``.

The MagicPoint stage of the SuperPoint recipe (DeTone et al. 2018): render
simple polygons with exactly known corner locations and supervise the
detector head with the 65-way cell classification loss (64 positions +
dustbin). As in the JAX trainer, the model runs with ``train=False`` and
the whole ``state_dict`` is optimised, running means and variances
included (a learned affine normalisation); the port's ``BatchNorm`` then
normalises in Flax's order, differentiably. The optimizer is
``train/optim.py``'s ``ClipAdamW`` (optax's clipping and AdamW).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from feature_tracker_tpu_torch.models.layers import (
    clip_like_jax,
    flax_init_,
    flax_order,
)
from feature_tracker_tpu_torch.models.raft import full_float32
from feature_tracker_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
)
from feature_tracker_tpu_torch.train.optim import (
    ClipAdamW,
    apply_updates,
    value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class SuperPointTrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    clip_norm: float = 1.0


def synthetic_corners_image(rng: np.random.Generator, h: int, w: int,
                            num_shapes: int = 4):
    """Render random filled quadrilaterals; return (image uint8-range
    float [h, w], corners [K, 2] float (x, y)) with K = 4*num_shapes."""
    img = np.full((h, w), rng.uniform(20, 60), np.float32)
    corners = []
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(num_shapes):
        cx = rng.uniform(10, w - 10)
        cy = rng.uniform(10, h - 10)
        ang = rng.uniform(0, 2 * np.pi)
        sx = rng.uniform(5, min(18, w / 4))
        sy = rng.uniform(5, min(18, h / 4))
        pts = []
        for i in range(4):
            a = ang + i * np.pi / 2 + rng.uniform(-0.3, 0.3)
            r = np.array([sx, sy]) * rng.uniform(0.7, 1.0)
            pts.append([cx + r[0] * np.cos(a), cy + r[1] * np.sin(a)])
        pts = np.asarray(pts)
        shade = rng.uniform(120, 240)
        # Rasterize the convex quad as intersection of half planes.
        inside = np.ones((h, w), bool)
        for i in range(4):
            p0, p1 = pts[i], pts[(i + 1) % 4]
            inside &= ((p1[0] - p0[0]) * (yy - p0[1])
                       - (p1[1] - p0[1]) * (xx - p0[0])) >= 0
        img[inside] = shade
        corners.extend(pts)
    corners = np.asarray(corners, np.float32)
    keep = ((corners[:, 0] >= 2) & (corners[:, 0] < w - 2)
            & (corners[:, 1] >= 2) & (corners[:, 1] < h - 2))
    return img, corners[keep]


def corner_label_map(corners, h: int, w: int):
    """The 65-way cell labels [h/8, w/8] int32: index of the corner pixel
    within its 8x8 cell, or 64 (dustbin) for empty cells."""
    hc, wc = h // 8, w // 8
    labels = np.full((hc, wc), 64, np.int32)
    for x, y in corners:
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < wc * 8 and 0 <= yi < hc * 8:
            labels[yi // 8, xi // 8] = (yi % 8) * 8 + (xi % 8)
    return labels


def detector_nll(heat, labels):
    """The 65-way cell loss of a heatmap ``[B, H, W]`` (probabilities,
    dustbin dropped) against cell labels ``[B, H/8, W/8]`` (long): the
    per-cell distributions rebuilt as the 64 cell pixels plus the implied
    dustbin mass ``1 - sum``, each clipped to [1e-8, 1] as ``jnp.clip``
    does; corner cells weighted 10, dustbin cells 1."""
    b, hh, ww = heat.shape
    hc, wc = hh // 8, ww // 8
    cells = heat.reshape(b, hc, 8, wc, 8).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(b, hc, wc, 64)
    dust = clip_like_jax(1.0 - torch.sum(cells, -1, keepdim=True), 1e-8, 1.0)
    logp = torch.log(torch.cat([clip_like_jax(cells, 1e-8, 1.0), dust],
                               dim=-1))
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    # Balance: corner cells are rare; weight them up.
    wgt = torch.where(labels < 64, 10.0, 1.0)
    return torch.sum(nll * wgt) / torch.sum(wgt)


def make_train_step(model: SuperPoint, cfg: SuperPointTrainConfig):
    """``(step, tx)``: ``step(params, opt_state, images, labels) -> (params,
    opt_state, loss)`` with images ``[B, H, W, 1]`` and labels ``[B, H/8,
    W/8]`` (tensors or numpy, moved to the params' device); ``params`` is
    the model's ``state_dict`` (``flax_order``), ``tx`` the optimizer.
    Nothing passed in is modified."""
    tx = ClipAdamW(cfg.learning_rate, weight_decay=cfg.weight_decay,
                   clip_norm=cfg.clip_norm)

    def step(params, opt_state, images, labels):
        dev = next(iter(params.values())).device
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()

        def loss_fn(p):
            # train=False: batch norm uses its stored statistics, which are
            # part of the optimised tensors here.
            heat, _ = functional_call(model, p, (images,), {"grad": True})
            return detector_nll(heat, labels), None

        with full_float32():
            loss, _, grads = value_and_grad(loss_fn, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step, tx


def train_synthetic(cfg: SuperPointConfig, train_cfg: SuperPointTrainConfig,
                    steps: int, h: int = 64, w: int = 64, batch: int = 4,
                    seed: int = 0, device="cuda"):
    """Train the detector on fresh synthetic corner images. The weights
    start from Flax's initializers drawn from ``seed`` (``flax_init_``);
    the images are the JAX trainer's for the same seed. Returns (model,
    params, losses): the model on ``device`` holds the trained params."""
    model = SuperPoint(cfg, device=device)
    rng = np.random.default_rng(seed)
    flax_init_(model, seed)
    params = {k: v.clone() for k, v in flax_order(model.state_dict()).items()}
    step, tx = make_train_step(model, train_cfg)
    opt_state = tx.init(params)

    losses = []
    for _ in range(steps):
        imgs, labs = [], []
        for _ in range(batch):
            img, corners = synthetic_corners_image(rng, h, w)
            imgs.append(img[..., None])
            labs.append(corner_label_map(corners, h, w))
        params, opt_state, loss = step(params, opt_state, np.stack(imgs),
                                       np.stack(labs))
        losses.append(float(loss))
    model.load_state_dict(params, strict=False)
    return model, params, losses
