"""DISK descriptor training on known-correspondence pairs — the counterpart
of ``feature_tracker_tpu/train/disk_train.py``.

Dense InfoNCE on translated image pairs (exact correspondences known):
descriptors at corresponding pixels are positives, all other sampled
pixels in the pair are negatives, symmetric over the two images, with an
optional hinge that pushes positive cosines above a margin. The optimizer
is ``train/optim.py``'s ``ClipAdamW`` (optax's clipping and AdamW).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from feature_tracker_tpu_torch.models.disk import (
    Disk,
    DiskConfig,
    sample_descriptors_fullres,
)
from feature_tracker_tpu_torch.models.layers import (
    divide,
    flax_init_,
    flax_order,
)
from feature_tracker_tpu_torch.models.raft import full_float32
from feature_tracker_tpu_torch.train.optim import (
    ClipAdamW,
    apply_updates,
    value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class DiskTrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    clip_norm: float = 1.0
    temperature: float = 0.1
    num_samples: int = 128  # correspondence samples per pair
    # Positive-cosine hinge at the demo decision boundary: the matcher
    # demo gates cosine DISTANCE at 0.1 (test_descriptor_matcher_disk
    # protocol), i.e. a positive pair only converts to a match when
    # cos >= 0.8. InfoNCE separates positives from negatives but does
    # not pin the absolute similarity scale; the hinge pushes positive
    # cosines above the gate with slack. 0 disables (initial training).
    pos_hinge_margin: float = 0.875
    pos_hinge_weight: float = 0.0


def translated_training_pair(rng: np.random.Generator, h: int, w: int,
                             max_shift: int = 6):
    """Textured image + integer-shifted copy with exact correspondences."""
    base = rng.uniform(0, 255, (h // 4 + 4, w // 4 + 4)).astype(np.float32)
    img = np.kron(base, np.ones((4, 4), np.float32))[:h + 16, :w + 16]
    k = np.ones(3, np.float32) / 3.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    dr = int(rng.integers(-max_shift, max_shift + 1))
    dc = int(rng.integers(-max_shift, max_shift + 1))
    a = img[8:h + 8, 8:w + 8]
    b = img[8 - dr:h + 8 - dr, 8 - dc:w + 8 - dc]
    return a.copy(), b.copy(), (dc, dr)  # flow (dx, dy) from a to b


def _softmax_cross_entropy(logits, labels):
    """optax's ``softmax_cross_entropy_with_integer_labels``: logsumexp of
    each row less its label's logit."""
    label_logits = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.logsumexp(logits, dim=1) - label_logits


def make_train_step(model: Disk, cfg: DiskTrainConfig):
    """``(step, tx)``: ``step(params, opt_state, img_a, img_b, uv_a, uv_b)
    -> (params, opt_state, loss)`` with images ``[H, W]`` and sample
    positions ``[S, 2]`` (tensors or numpy, moved to the params' device);
    ``params`` is the model's ``state_dict``. Nothing passed in is
    modified."""
    tx = ClipAdamW(cfg.learning_rate, weight_decay=cfg.weight_decay,
                   clip_norm=cfg.clip_norm)

    def step(params, opt_state, img_a, img_b, uv_a, uv_b):
        dev = next(iter(params.values())).device
        img_a, img_b, uv_a, uv_b = (
            torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (img_a, img_b, uv_a, uv_b))

        def loss_fn(p):
            _, desc_a = functional_call(model, p, (img_a[None, :, :, None],),
                                        {"grad": True})
            _, desc_b = functional_call(model, p, (img_b[None, :, :, None],),
                                        {"grad": True})
            da = sample_descriptors_fullres(desc_a[0], uv_a)   # [S, D]
            db = sample_descriptors_fullres(desc_b[0], uv_b)   # [S, D]
            sim = divide(da @ db.T, cfg.temperature)           # [S, S]
            labels = torch.arange(sim.shape[0], device=dev)
            # Symmetric InfoNCE.
            l_ab = _softmax_cross_entropy(sim, labels).mean()
            l_ba = _softmax_cross_entropy(sim.T, labels).mean()
            loss = 0.5 * (l_ab + l_ba)
            if cfg.pos_hinge_weight > 0.0:
                pos_cos = torch.sum(da * db, dim=-1)
                loss = loss + cfg.pos_hinge_weight * torch.mean(
                    F.relu(cfg.pos_hinge_margin - pos_cos) ** 2)
            return loss, None

        with full_float32():
            loss, _, grads = value_and_grad(loss_fn, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step, tx


def train_synthetic(cfg: DiskConfig, train_cfg: DiskTrainConfig,
                    steps: int, h: int = 64, w: int = 64, seed: int = 0,
                    device="cuda"):
    """Train on fresh translated pairs (the JAX trainer's for the same
    seed), from Flax's initializers drawn from ``seed``. Returns (model,
    params, losses): the model on ``device`` holds the trained params."""
    model = Disk(cfg, device=device)
    rng = np.random.default_rng(seed)
    flax_init_(model, seed)
    params = {k: v.clone() for k, v in flax_order(model.state_dict()).items()}
    step, tx = make_train_step(model, train_cfg)
    opt_state = tx.init(params)

    losses = []
    margin = 10
    for _ in range(steps):
        a, b, (dx, dy) = translated_training_pair(rng, h, w)
        uv_a = rng.uniform(margin, [w - margin, h - margin],
                           (train_cfg.num_samples, 2)).astype(np.float32)
        uv_b = uv_a + np.array([dx, dy], np.float32)
        params, opt_state, loss = step(params, opt_state, a, b, uv_a, uv_b)
        losses.append(float(loss))
    model.load_state_dict(params)
    return model, params, losses
