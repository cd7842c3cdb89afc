"""LightGlue matcher training on synthetic correspondences — the
counterpart of ``feature_tracker_tpu/train/lightglue_train.py``.

The LightGlue loss (negative log-likelihood of the ground-truth partial
assignment: -log P[i, gt(i)] for matched points, -log(1 - sigma) for
unmatchable points on both sides — Lindenberger et al. 2023, eq. 10) plus
a synthetic correspondence generator (random similarity warp of
keypoints, noised shared descriptors, distractors). The optimizer is
``train/optim.py``'s ``ClipAdamW`` (optax's clipping and AdamW).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from feature_tracker_tpu_torch.models.layers import flax_init_, flax_order
from feature_tracker_tpu_torch.models.lightglue import (
    LightGlue,
    LightGlueConfig,
    mutual_argmax_matches,
)
from feature_tracker_tpu_torch.models.raft import full_float32
from feature_tracker_tpu_torch.train.optim import (
    ClipAdamW,
    apply_updates,
    value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class LightGlueTrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    clip_norm: float = 1.0


def synthetic_matching_problem(rng: np.random.Generator, n: int, m: int,
                               dim: int, matched: int,
                               desc_noise: float = 0.1,
                               image_size: float = 640.0):
    """Build one matching problem.

    The first ``matched`` ref keypoints correspond to a random similarity
    warp of themselves placed at random slots in cur; their descriptors
    are shared up to noise. Remaining points on both sides are
    distractors. Returns (kpts0, desc0, kpts1, desc1, gt) with gt [n]
    int32 cur indices (-1 = unmatchable)."""
    kpts0 = rng.uniform(0, image_size, (n, 2)).astype(np.float32)
    desc0 = rng.normal(0, 1, (n, dim)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)

    theta = rng.uniform(-0.3, 0.3)
    scale = rng.uniform(0.8, 1.25)
    rot = scale * np.array([[np.cos(theta), -np.sin(theta)],
                            [np.sin(theta), np.cos(theta)]], np.float32)
    shift = rng.uniform(-40, 40, 2).astype(np.float32)

    kpts1 = rng.uniform(0, image_size, (m, 2)).astype(np.float32)
    desc1 = rng.normal(0, 1, (m, dim)).astype(np.float32)
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)

    slots = rng.choice(m, size=matched, replace=False).astype(np.int32)
    kpts1[slots] = kpts0[:matched] @ rot.T + shift
    d = desc0[:matched] + desc_noise * rng.normal(0, 1, (matched, dim))
    desc1[slots] = (d / np.linalg.norm(d, axis=-1, keepdims=True)
                    ).astype(np.float32)

    gt = np.full(n, -1, np.int32)
    gt[:matched] = slots
    return kpts0, desc0, kpts1, desc1, gt


def lightglue_loss(scores, logit0, logit1, gt):
    """NLL of the ground-truth partial assignment.

    scores: [N, M] log P; gt: [N] int32 (-1 = ref point unmatchable).
    Cur points not referenced by gt are treated as unmatchable.

    As the JAX loss computes it: JAX builds the cur points' hit mask by a
    scatter in which every unmatchable ref point writes False to slot 0
    (``.at[clip(gt, 0, M-1)].set(matched)``), and that write wins on the
    JAX CPU backend whatever the order; so when any ref point is
    unmatchable, cur slot 0 counts as unmatchable even when a ref point is
    matched to it. Here the mask is built without a scatter, with that
    rule, deterministically."""
    n, m = scores.shape
    matched = gt >= 0
    safe = torch.clamp(gt, 0, m - 1).long()
    pos_ll = torch.gather(scores, 1, safe[:, None])[:, 0]
    pos_loss = -torch.sum(torch.where(matched, pos_ll, 0.0))

    # log(1 - sigma) = log_sigmoid(-logit) for unmatchable points.
    neg0 = -torch.sum(torch.where(matched, 0.0, F.logsigmoid(-logit0)))
    slots = torch.arange(m, device=scores.device)
    cur_hit = ((safe[None, :] == slots[:, None]) & matched[None, :]).any(1)
    cur_hit = torch.cat([cur_hit[:1] & matched.all(), cur_hit[1:]])
    neg1 = -torch.sum(torch.where(cur_hit, 0.0, F.logsigmoid(-logit1)))

    denom = torch.clamp(torch.sum(matched), min=1)
    return (pos_loss + 0.5 * (neg0 + neg1)) / denom


def make_train_step(model: LightGlue, cfg: LightGlueTrainConfig):
    """``(step, tx)``: ``step(params, opt_state, k0, d0, k1, d1, gt) ->
    (params, opt_state, {"loss", "assignment_acc"})`` (inputs tensors or
    numpy, moved to the params' device); ``params`` is the model's
    ``state_dict``. Nothing passed in is modified."""
    tx = ClipAdamW(cfg.learning_rate, weight_decay=cfg.weight_decay,
                   clip_norm=cfg.clip_norm)

    def step(params, opt_state, k0, d0, k1, d1, gt):
        dev = next(iter(params.values())).device
        k0, d0, k1, d1 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                          for a in (k0, d0, k1, d1))
        gt = torch.as_tensor(gt, device=dev)
        mask0 = torch.ones(k0.shape[0], dtype=torch.bool, device=dev)
        mask1 = torch.ones(k1.shape[0], dtype=torch.bool, device=dev)

        def loss_fn(p):
            scores, l0, l1 = functional_call(
                model, p, (k0, d0, mask0, k1, d1, mask1), {"grad": True})
            return lightglue_loss(scores, l0, l1, gt), scores.detach()

        with full_float32():
            loss, scores, grads = value_and_grad(loss_fn, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        pred = mutual_argmax_matches(scores, -1e8)
        acc = torch.mean((pred == gt).float())
        return (apply_updates(params, updates), opt_state,
                {"loss": loss, "assignment_acc": acc})

    return step, tx


def train_synthetic(cfg: LightGlueConfig, train_cfg: LightGlueTrainConfig,
                    steps: int, n: int = 64, m: int = 64, matched: int = 40,
                    seed: int = 0, device="cuda"):
    """Train on fresh synthetic problems (the JAX trainer's for the same
    seed), from Flax's initializers drawn from ``seed``; returns (params,
    metrics list)."""
    model = LightGlue(cfg, device=device)
    rng = np.random.default_rng(seed)
    # The JAX trainer draws one problem to initialise its model with.
    synthetic_matching_problem(rng, n, m, cfg.descriptor_dim, matched)
    flax_init_(model, seed)
    params = {k: v.clone() for k, v in flax_order(model.state_dict()).items()}
    step, tx = make_train_step(model, train_cfg)
    opt_state = tx.init(params)

    history = []
    for _ in range(steps):
        k0, d0, k1, d1, gt = synthetic_matching_problem(
            rng, n, m, cfg.descriptor_dim, matched)
        params, opt_state, metrics = step(params, opt_state, k0, d0, k1, d1,
                                          gt)
        history.append({k: float(v) for k, v in metrics.items()})
    return params, history
