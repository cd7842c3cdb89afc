"""End-to-end pretraining driver for the neural matching stack — the
counterpart of ``feature_tracker_tpu/train/pretrain.py``.

The native SuperPoint, DISK and LightGlue are trained here, on synthetic
data and crops of real imagery, and judged on the reference pair:

 1. SuperPoint: joint training of the 65-way cell detector (rendered
    corners with exact labels, textures with Harris pseudo-labels) and the
    cell-level InfoNCE descriptor on similarity-warped pairs
    (``train_superpoint``); then viewpoint adaptation on multi-warp-stable
    Harris or DISK labels (``adapt_superpoint``) or distillation of the
    DISK descriptors (``distill_superpoint_from_disk``).
 2. DISK: dense descriptor InfoNCE on warped texture pairs
    (``train_disk``).
 3. LightGlue: assignment NLL on the keypoints and descriptors of the
    trained detector on fresh warped pairs (``train_lightglue``), and
    held-out precision and recall (``evaluate_matching``).

Every ``numpy.random.Generator`` is drawn from as the JAX package draws
from it, so a seed gives the same pools, labels and batch orders. The
models, their steps and the detections run on ``device`` (the card unless
the caller asks for ``"cpu"``); a function handed a model or a detector
runs on that one's device. Parameters are ``state_dict`` entries in Flax's
order (``models/layers.py::flax_order``); SuperPoint's include its running
statistics, which its steps optimise, as the JAX ones do.

``reference_pair_counts`` and ``reference_pair_lightglue_counts`` count
the demo protocol's matches on the reference 752x480 pair and verify them
with the basic KLT (the card's FAST kernel, one launch per count); they
give None where the reference images are absent. ``main`` runs the
stages, gates each weight file on those counts and writes the JAX
package's npz layout and ``metrics.json`` under ``WEIGHTS_DIR`` (the
repository's ``weights/``; point it elsewhere for a trial run).

Run: ``python -m feature_tracker_tpu_torch.train.pretrain [flag=N ...]
[device=cpu]`` (the card by default).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
from torch.func import functional_call

from feature_tracker_tpu_torch.convert import flax_variables_from_state
from feature_tracker_tpu_torch.core.device import resolve_device
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
from feature_tracker_tpu_torch.train.superpoint_train import (
    detector_nll as _detector_nll,
)
from feature_tracker_tpu_torch.utils.weights import (  # noqa: F401
    WEIGHTS_DIR,
    load_pytree,
    save_pytree,
)


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


# The reference sources' example images, where the JAX package reads them
# (its train/pretrain.py): the KITTI-style direct-method frames and the
# 752x480 optical-flow pair.
REFERENCE_EXAMPLE = os.path.join(os.sep, "root", "reference", "example")
REFERENCE_FRAMES = os.path.join(REFERENCE_EXAMPLE, "direct_method")
REFERENCE_PAIR = os.path.join(REFERENCE_EXAMPLE, "optical_flow")

_REAL_POOL = None


def _real_image_pool():
    """Real-world training imagery: the KITTI-style direct-method frames
    under ``REFERENCE_FRAMES`` (disjoint from the optical-flow pair the
    demos and tests evaluate on). Loaded lazily; [] when absent, and
    whatever loaded before a failure when one fails."""
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
        except Exception:
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


# ------------------------------------------------- SuperPoint (stage 1)

def _warp_image_np(img, rot, t):
    """img_b with img_b(q) = img(warp^-1(q)), warp(p) = rot @ p + t; also
    the in-source validity mask."""
    h, w = img.shape
    rinv = np.linalg.inv(rot)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    src = np.stack([xx - t[0], yy - t[1]], -1) @ rinv.T
    valid = ((src[..., 0] >= 0) & (src[..., 0] <= w - 1)
             & (src[..., 1] >= 0) & (src[..., 1] <= h - 1))
    return _bilinear_np(img, src[..., 0], src[..., 1]), valid


def _random_similarity(rng, h, w, max_theta=0.3, max_shift=10.0,
                       scale_lo=0.85, scale_hi=1.18):
    theta = rng.uniform(-max_theta, max_theta)
    scale = rng.uniform(scale_lo, scale_hi)
    c, s = np.cos(theta) * scale, np.sin(theta) * scale
    rot = np.array([[c, -s], [s, c]], np.float64)
    center = np.array([w / 2.0, h / 2.0])
    t = center + rng.uniform(-max_shift, max_shift, 2) - rot @ center
    return rot, t


def _warp_stable_points(img, rng, detect_uv, n_warps: int = 8,
                        cap: int = 64, min_votes: int | None = None):
    """Multi-view-stable points of an arbitrary detector: detect on
    random similarity warps of ``img``, unwarp, and keep locations where
    detections agree across warps (votes splatted with 1-px tolerance).
    ``detect_uv(img_np) -> [K, 2] np.ndarray`` of (x, y)."""
    h, w = img.shape
    votes = np.zeros((h, w), np.float32)
    warps = [(np.eye(2), np.zeros(2))]
    for _ in range(n_warps - 1):
        # Moderate scale range for LABEL generation: response ranking is
        # scale-sensitive and the goal is stability voting.
        warps.append(_random_similarity(rng, h, w, scale_lo=0.92,
                                        scale_hi=1.1))
    for rot, t in warps:
        wimg, _ = _warp_image_np(img, rot, t)
        uv = detect_uv(wimg)
        if len(uv) == 0:
            continue
        # Unwarp detections: p = warp^-1(q).
        rinv = np.linalg.inv(rot)
        back = (uv - t) @ rinv.T
        for x, y in back:
            xi, yi = int(round(x)), int(round(y))
            if 1 <= xi < w - 1 and 1 <= yi < h - 1:
                votes[yi - 1:yi + 2, xi - 1:xi + 2] += 1.0
    if min_votes is None:
        min_votes = max(2, (n_warps + 1) // 3)
    # Greedy selection of vote maxima with 4-px spacing.
    pts = []
    v = votes.copy()
    for _ in range(cap):
        yi, xi = np.unravel_index(np.argmax(v), v.shape)
        if v[yi, xi] < min_votes:
            break
        pts.append((float(xi), float(yi)))
        v[max(0, yi - 4):yi + 5, max(0, xi - 4):xi + 5] = 0.0
    return pts


def _detected(detection):
    """The first ``num`` rows of a detector's ``uv`` as numpy."""
    uv, num = detection[0], detection[-1]
    return uv.cpu().numpy()[:int(num)]


def harris_adaptation_points(img, rng, n_warps: int = 8, cap: int = 64,
                             min_votes: int | None = None, device="cuda"):
    """Multi-view-stable Harris labels, detected on ``device``.
    Model-INDEPENDENT: pseudo-labels from the model itself drift (the JAX
    package's self-labeling adaptation halved the reference-pair matches),
    while Harris anchored to multi-warp stability keeps the target
    grounded and still teaches viewpoint-covariant repeatability."""
    from feature_tracker_tpu_torch.core.config import HarrisOptions
    from feature_tracker_tpu_torch.ops.detect import detect_good_features

    harris = HarrisOptions(min_feature_distance=6,
                           min_valid_response=8.0)

    def detect_uv(im):
        return _detected(detect_good_features(im, cap, harris,
                                              device=device))

    return _warp_stable_points(img, rng, detect_uv, n_warps, cap,
                               min_votes)


def disk_adaptation_points(img, rng, disk_det, n_warps: int = 8,
                           cap: int = 64, min_votes: int | None = None):
    """Multi-view-stable DISK labels: warp-stable detections of a frozen,
    trained ``DiskDetector`` (on its device), whose repeatability on the
    reference pair exceeds both Harris and the Harris-trained SuperPoint.
    The teacher is external to the trained model, so the labels cannot
    drift."""
    return _warp_stable_points(
        img, rng, lambda im: _detected(disk_det.detect(im)), n_warps, cap,
        min_votes)


def _cell_labels_from_points(points, h, w):
    hc, wc = h // 8, w // 8
    labels = np.full((hc, wc), 64, np.int32)
    for x, y in points:
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < wc * 8 and 0 <= yi < hc * 8:
            labels[yi // 8, xi // 8] = (yi % 8) * 8 + (xi % 8)
    return labels


def _to(dev, *arrays, dtype=torch.float32):
    return [torch.as_tensor(a, device=dev).to(dtype) for a in arrays]


def _sample_batch(desc, uv):
    """``jax.vmap(sample_descriptors)``: L2-normalized descriptors of
    ``desc [B, Hc, Wc, D]`` at ``uv [B, P, 2]``, ``[B, P, D]``."""
    from feature_tracker_tpu_torch.models.superpoint import (
        sample_descriptors,
    )

    return torch.func.vmap(sample_descriptors)(desc, uv)


def _make_sp_step(model, tx, hc, wc, desc_temp: float = 0.1,
                  det_weight: float = 1.0, point_desc: bool = False,
                  pt_temp: float = 0.07, hinge_margin: float = 0.92):
    """The joint detector+descriptor train step (shared between the
    initial training and the adaptation rounds) of a ``SuperPoint`` and a
    ``ClipAdamW``: ``step(params, opt_state, imgs_a, imgs_b, labels_a,
    labels_b, cell_b_of_a, cell_valid, *points) -> (params, opt_state,
    loss, (det, desc))``, the inputs numpy or tensors, moved to the
    params' device. ``desc_temp`` is the cell InfoNCE temperature,
    ``det_weight`` scales the detector NLL against the descriptor loss.

    ``point_desc`` adds the keypoint-level descriptor loss of the demo's
    protocol: descriptors bilinear-sampled at warp-corresponding points
    (``points`` = uv_a, uv_b ``[B, P, 2]`` and pt_valid ``[B, P]``), a
    symmetric InfoNCE over the valid points plus a hinge at the demo's
    cosine decision boundary (similarity >= ``hinge_margin``)."""

    def step(params, opt_state, imgs_a, imgs_b, labels_a, labels_b,
             cell_b_of_a, cell_valid, *points):
        dev = next(iter(params.values())).device
        imgs_a, imgs_b, cell_valid, *points = _to(dev, imgs_a, imgs_b,
                                                  cell_valid, *points)
        labels_a, labels_b, cell_b_of_a = _to(dev, labels_a, labels_b,
                                              cell_b_of_a, dtype=torch.long)

        def loss_fn(p):
            heat_a, desc_a = functional_call(model, p, (imgs_a,),
                                             {"grad": True})
            heat_b, desc_b = functional_call(model, p, (imgs_b,),
                                             {"grad": True})
            det = 0.5 * (_detector_nll(heat_a, labels_a)
                         + _detector_nll(heat_b, labels_b))

            # Cell-level InfoNCE: descriptor of cell c in A vs the
            # corresponding cell in B, negatives = all B cells.
            da = desc_a.reshape(desc_a.shape[0], hc * wc, -1)
            db = desc_b.reshape(desc_b.shape[0], hc * wc, -1)
            da = da / torch.linalg.vector_norm(da, dim=-1, keepdim=True)
            db = db / torch.linalg.vector_norm(db, dim=-1, keepdim=True)
            sim = divide(torch.einsum("bnd,bmd->bnm", da, db), desc_temp)
            ll = torch.log_softmax(sim, dim=-1)
            pos = torch.gather(ll, -1, cell_b_of_a[..., None])[..., 0]
            desc_loss = -torch.sum(pos * cell_valid) / torch.clamp(
                torch.sum(cell_valid), min=1.0)
            total = det_weight * det + desc_loss

            if point_desc:
                uv_a, uv_b, pt_valid = points
                pa = _sample_batch(desc_a, uv_a)              # [B, P, D]
                pb = _sample_batch(desc_b, uv_b)
                psim = torch.einsum("bpd,bqd->bpq", pa, pb)
                nv = torch.clamp(torch.sum(pt_valid), min=1.0)
                # Mask padded slots out of the negative pools (their
                # descriptors all sample position (0, 0) and would act
                # as duplicated bogus negatives).
                neg = torch.full((), -1e9, device=dev)
                m_row = pt_valid[:, :, None] > 0
                m_col = pt_valid[:, None, :] > 0
                diag = torch.einsum("bpd,bpd->bp", pa, pb)
                lab = torch.eye(psim.shape[1], dtype=torch.bool,
                                device=dev)[None].expand(psim.shape)
                ll_ab = torch.log_softmax(
                    divide(torch.where(m_col, psim, neg), pt_temp), dim=2)
                ll_ba = torch.log_softmax(
                    divide(torch.where(m_row, psim, neg), pt_temp), dim=1)
                zero = torch.zeros((), device=dev)
                pos_ab = torch.sum(torch.where(lab, ll_ab, zero), dim=2)
                pos_ba = torch.sum(torch.where(lab, ll_ba, zero), dim=1)
                pt_info = -torch.sum(
                    0.5 * (pos_ab + pos_ba) * pt_valid) / nv
                hinge = torch.sum(
                    torch.maximum(zero, hinge_margin - diag)
                    * pt_valid) / nv
                total = total + pt_info + hinge
            return total, (det.detach(), desc_loss.detach())

        with full_float32():
            loss, aux, grads = value_and_grad(loss_fn, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, aux

    return step


def _fit_points(pts_a, warp, h, w, cap: int = 96, rng=None,
                n_random: int = 48):
    """Fixed-size point-correspondence arrays for the point-level
    descriptor loss: (uv_a [cap,2], uv_b [cap,2], valid [cap]) keeping
    pairs whose both endpoints are >=2 px inside the image. When ``rng``
    is given, up to ``n_random`` uniform coverage points are appended to
    the labeled keypoints (the DISK recipe trains on dense random
    correspondences: they diversify the InfoNCE negatives and train the
    descriptor field between keypoints)."""
    pts = np.asarray(pts_a, np.float32).reshape(-1, 2)
    if rng is not None and n_random > 0:
        extra = rng.uniform([4, 4], [w - 4, h - 4],
                            (n_random, 2)).astype(np.float32)
        pts = np.concatenate([pts, extra], 0) if len(pts) else extra
    if len(pts):
        pb = np.asarray(warp(pts), np.float32).reshape(-1, 2)
        ok = ((pts[:, 0] >= 2) & (pts[:, 0] < w - 2)
              & (pts[:, 1] >= 2) & (pts[:, 1] < h - 2)
              & (pb[:, 0] >= 2) & (pb[:, 0] < w - 2)
              & (pb[:, 1] >= 2) & (pb[:, 1] < h - 2))
        pts, pb = pts[ok], pb[ok]
    else:
        pb = np.zeros((0, 2), np.float32)
    n = min(len(pts), cap)
    ua = np.zeros((cap, 2), np.float32)
    ub = np.zeros((cap, 2), np.float32)
    ua[:n] = pts[:n]
    ub[:n] = pb[:n]
    return ua, ub, (np.arange(cap) < n).astype(np.float32)


def _cell_correspondence(warp, hc, wc):
    """Cell correspondence map A -> B through the warp."""
    cy, cx = np.mgrid[0:hc, 0:wc]
    centers = np.stack([cx * 8 + 3.5, cy * 8 + 3.5], -1).reshape(-1, 2)
    warped = warp(centers)
    bx = np.round((warped[:, 0] - 3.5) / 8).astype(np.int64)
    by = np.round((warped[:, 1] - 3.5) / 8).astype(np.int64)
    ok = (bx >= 0) & (bx < wc) & (by >= 0) & (by < hc)
    return np.where(ok, by * wc + bx, 0), ok.astype(np.float32)


def _sp_train_loop(step, params, opt_state, pool, steps, rng, batch,
                   log_every, tag):
    history = []
    order = rng.permutation(len(pool))
    for it in range(steps):
        take = [pool[order[(it * batch + j) % len(pool)]]
                for j in range(batch)]
        if (it * batch) % len(pool) + batch >= len(pool):
            order = rng.permutation(len(pool))
        stacked = [np.stack([t[i] for t in take])
                   for i in range(len(take[0]))]
        params, opt_state, loss, aux = step(params, opt_state, *stacked)
        if it % log_every == 0 or it == steps - 1:
            det, dsc = float(aux[0]), float(aux[1])
            history.append({"step": it, "loss": float(loss),
                            "det": det, "desc": dsc})
            print(f"[{tag}] step {it}: loss={float(loss):.4f} "
                  f"det={det:.4f} desc={dsc:.4f}", flush=True)
    return params, opt_state, history


def _sp_optimizer(lr):
    """optax's ``chain(clip_by_global_norm(1.0), adamw(lr,
    weight_decay=1e-5))``."""
    return ClipAdamW(lr, weight_decay=1e-5, clip_norm=1.0)


def _fresh_params(model, seed):
    """``model``'s weights from Flax's initializers drawn from ``seed``,
    in Flax's order."""
    flax_init_(model, seed)
    return {k: v.clone() for k, v in flax_order(model.state_dict()).items()}


def train_superpoint(steps: int = 1500, h: int = 96, w: int = 96,
                     batch: int = 4, seed: int = 0, log_every: int = 200,
                     device="cuda"):
    """Joint detector+descriptor training; returns (model, params,
    history). The weights start from Flax's initializers drawn from
    ``seed`` (``flax_init_``); the pool and the batch order are the JAX
    package's for the same seed."""
    from feature_tracker_tpu_torch.core.config import HarrisOptions
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
    )
    from feature_tracker_tpu_torch.ops.detect import detect_good_features
    from feature_tracker_tpu_torch.train.superpoint_train import (
        synthetic_corners_image,
    )

    model = SuperPoint(SuperPointConfig(), device=device)
    rng = np.random.default_rng(seed)
    params = _fresh_params(model, seed)
    tx = _sp_optimizer(1e-3)
    opt_state = tx.init(params)
    hc, wc = h // 8, w // 8
    step = _make_sp_step(model, tx, hc, wc)

    harris = HarrisOptions(min_feature_distance=8, min_valid_response=20.0)

    # The dataset first, then the training loop (the JAX package's order).
    n_samples = min(steps, 300) * batch
    pool = []
    for it in range(n_samples):
        if it % 3 == 0:
            # Corner-geometry batch: exact labels, identity pair.
            img, corners = synthetic_corners_image(rng, h, w)
            img_a_, img_b_ = img, img
            labels_a_ = labels_b_ = _cell_labels_from_points(corners, h, w)
            warp = lambda p: p  # noqa: E731
        else:
            img_a_, img_b_, warp = warped_texture_pair(rng, h, w)
            labels_a_, labels_b_ = (
                _cell_labels_from_points(_detected(detect_good_features(
                    im, 64, harris, device=model.device)), h, w)
                for im in (img_a_, img_b_))
        idx, ok = _cell_correspondence(warp, hc, wc)
        pool.append((img_a_[..., None], img_b_[..., None], labels_a_,
                     labels_b_, idx, ok))

    params, opt_state, history = _sp_train_loop(
        step, params, opt_state, pool, steps, rng, batch, log_every,
        "superpoint")
    return model, params, history


def adapt_superpoint(model, params, rounds: int = 1, steps: int = 1200,
                     h: int = 96, w: int = 96, batch: int = 4,
                     seed: int = 11, n_warps: int = 8,
                     pool_size: int = 360, log_every: int = 200,
                     desc_temp: float = 0.1, det_weight: float = 1.0,
                     labeler: str = "harris", point_desc: bool = False,
                     lr: float = 1e-4, wide_scale: bool = False):
    """Viewpoint-adaptation training for SuperPoint (``model``, on its
    device, from ``params``): detector labels from multi-warp-stable
    Harris points (``labeler="harris"``), warp-stable DISK points
    (``"disk"``), DISK's dense per-image detections (``"disk_dense"``) or
    its sparse top-K per-image detections (``"disk_topk"``), mixed with
    the exact-label corner-geometry batches that anchor the cornerness
    semantics; the descriptors keep training jointly on the warp
    correspondences. ``wide_scale`` draws the warps' scale from 0.7-1.4.
    Returns (params, history)."""
    from feature_tracker_tpu_torch.models.disk import DiskDetector
    from feature_tracker_tpu_torch.train.superpoint_train import (
        synthetic_corners_image,
    )

    dev = model.device
    tx = _sp_optimizer(lr)
    hc, wc = h // 8, w // 8
    step = _make_sp_step(model, tx, hc, wc, desc_temp=desc_temp,
                         det_weight=det_weight, point_desc=point_desc)
    rng = np.random.default_rng(seed)
    history = []

    if labeler == "disk":
        disk_det = DiskDetector.from_file(max_features=64,
                                          min_feature_distance=6, device=dev)
        if disk_det is None:
            raise FileNotFoundError(
                "labeler='disk' needs weights/disk.npz (train DISK first)")

        def label_points(im, r):
            return disk_adaptation_points(im, r, disk_det, n_warps,
                                          cap=48)
    elif labeler in ("disk_dense", "disk_topk"):
        # disk_dense: DISK's detections on each training image directly,
        # 64 at 4-px spacing; disk_topk: the teacher's 24 strongest at
        # 8-px spacing, which keeps most cells dustbin and carries the
        # teacher's response ranking.
        cap, spacing = (64, 4) if labeler == "disk_dense" else (24, 8)
        disk_det = DiskDetector.from_file(max_features=cap,
                                          min_feature_distance=spacing,
                                          device=dev)
        if disk_det is None:
            raise FileNotFoundError(
                f"labeler={labeler!r} needs weights/disk.npz")

        def label_points(im, r):
            return [tuple(p) for p in _detected(disk_det.detect(im))]
    elif labeler == "harris":
        def label_points(im, r):
            return harris_adaptation_points(im, r, n_warps, cap=48,
                                            device=dev)
    else:
        raise ValueError(f"unknown labeler {labeler!r}")

    for rnd in range(rounds):
        opt_state = tx.init(params)
        # Phase 1: the label pool.
        pool = []
        for it in range(pool_size):
            if it % 4 == 0:
                # Corner-geometry anchor batch: exact labels.
                img, corners = synthetic_corners_image(rng, h, w)
                labels = _cell_labels_from_points(corners, h, w)
                idx, ok = _cell_correspondence(lambda p: p, hc, wc)
                entry = [img[..., None], img[..., None], labels,
                         labels, idx, ok]
                if point_desc:
                    entry.extend(_fit_points(corners, lambda p: p, h, w,
                                             rng=rng))
                pool.append(tuple(entry))
                continue
            # Real crops preferred: the analytic textures are
            # band-limited and carry few strong Harris corners.
            use_real = None if rng.uniform() < 0.2 else True
            s_lo, s_hi = (0.7, 1.4) if wide_scale else (0.9, 1.12)
            img_a_, img_b_, warp = warped_texture_pair(
                rng, h, w, max_theta=0.3, max_shift=14.0,
                use_real=use_real, scale_lo=s_lo, scale_hi=s_hi)
            labels = []
            pts_a = None
            for im in (img_a_, img_b_):
                pts = label_points(im, rng)
                if pts_a is None:
                    pts_a = pts
                labels.append(_cell_labels_from_points(pts, h, w))
            idx, ok = _cell_correspondence(warp, hc, wc)
            entry = [img_a_[..., None], img_b_[..., None], labels[0],
                     labels[1], idx, ok]
            if point_desc:
                entry.extend(_fit_points(pts_a, warp, h, w, rng=rng))
            pool.append(tuple(entry))
        # Phase 2: continue joint training on the adapted labels.
        params, opt_state, hist = _sp_train_loop(
            step, params, opt_state, pool, steps, rng, batch, log_every,
            f"sp-adapt{rnd}")
        history.extend([dict(h, round=rnd) for h in hist])
    return params, history


def _disk_teacher(det):
    """Frozen DISK teacher for descriptor distillation: returns
    targets_fn where ``targets_fn(img_np, uv [P,2]) -> [P,256]`` (numpy)
    are the teacher's L2-normalized descriptors embedded into the
    SuperPoint descriptor space through a FIXED semi-orthogonal 128->256
    isometry (QR of a seeded Gaussian): cosine geometry is preserved
    exactly, so a student matching the targets inherits the teacher's
    match/non-match separation. ``det`` is a loaded ``DiskDetector``
    (only its model is used; the image is padded at the bottom and right
    to a multiple of 8, as the JAX teacher pads it)."""
    import torch.nn.functional as F

    from feature_tracker_tpu_torch.models.disk import (
        sample_descriptors_fullres,
    )

    q, _ = np.linalg.qr(
        np.random.default_rng(77).normal(size=(256, 128)))
    dev = det.model.device
    emb = torch.from_numpy(q.astype(np.float32)).to(dev)     # [256, 128]

    def targets_fn(img_np, uv_np):
        with torch.inference_mode(), full_float32():
            img, uv = _to(dev, img_np, uv_np)
            h, w = img.shape
            padded = F.pad(img, (0, (-w) % 8, 0, (-h) % 8))
            _, desc = det.model(padded[None, :, :, None])
            d = sample_descriptors_fullres(desc[0, :h, :w], uv)  # [P,128]
            return (d @ emb.T).cpu().numpy()                      # [P,256]

    return targets_fn


def _make_sp_distill_step(model, tx, det_weight: float = 1.0,
                          rel_weight: float = 4.0):
    """Distillation step: detector NLL on (DISK-stable) cell labels +
    pointwise cosine alignment of the student's sampled descriptors to the
    embedded teacher targets in BOTH images of the warp pair, and a
    relational term that penalises the student's pairwise cosines where
    they exceed the teacher's by more than 0.05 (a one-sided hinge against
    a collapsed descriptor space). ``step(params, opt_state, imgs_a,
    imgs_b, labels_a, labels_b, uv_a, uv_b, pt_valid, tgt_a, tgt_b)``, as
    ``_make_sp_step``'s."""

    def step(params, opt_state, imgs_a, imgs_b, labels_a, labels_b,
             uv_a, uv_b, pt_valid, tgt_a, tgt_b):
        dev = next(iter(params.values())).device
        imgs_a, imgs_b, uv_a, uv_b, pt_valid, tgt_a, tgt_b = _to(
            dev, imgs_a, imgs_b, uv_a, uv_b, pt_valid, tgt_a, tgt_b)
        labels_a, labels_b = _to(dev, labels_a, labels_b, dtype=torch.long)

        def loss_fn(p):
            heat_a, desc_a = functional_call(model, p, (imgs_a,),
                                             {"grad": True})
            heat_b, desc_b = functional_call(model, p, (imgs_b,),
                                             {"grad": True})
            det = 0.5 * (_detector_nll(heat_a, labels_a)
                         + _detector_nll(heat_b, labels_b))
            pa = _sample_batch(desc_a, uv_a)
            pb = _sample_batch(desc_b, uv_b)
            nv = torch.clamp(torch.sum(pt_valid), min=1.0)
            cos_a = torch.sum(pa * tgt_a, -1)
            cos_b = torch.sum(pb * tgt_b, -1)
            dist = torch.sum((2.0 - cos_a - cos_b) * pt_valid) / nv
            pmask = pt_valid[:, :, None] * pt_valid[:, None, :]
            nvv = torch.clamp(torch.sum(pmask), min=1.0)
            g_sa = torch.einsum("bpd,bqd->bpq", pa, pa)
            g_sb = torch.einsum("bpd,bqd->bpq", pb, pb)
            g_ta = torch.einsum("bpd,bqd->bpq", tgt_a, tgt_a)
            g_tb = torch.einsum("bpd,bqd->bpq", tgt_b, tgt_b)
            rel = torch.sum((torch.relu(g_sa - g_ta - 0.05) ** 2
                             + torch.relu(g_sb - g_tb - 0.05) ** 2)
                            * pmask) / (2.0 * nvv)
            loss_desc = dist + rel_weight * rel
            return (det_weight * det + loss_desc,
                    (det.detach(), loss_desc.detach()))

        with full_float32():
            loss, aux, grads = value_and_grad(loss_fn, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, aux

    return step


def distill_superpoint_from_disk(model, params, steps: int = 1600,
                                 h: int = 96, w: int = 96, batch: int = 4,
                                 seed: int = 21, n_warps: int = 8,
                                 pool_size: int = 360,
                                 log_every: int = 200, lr: float = 2e-4,
                                 n_extra_pts: int = 24):
    """Teacher-student distillation of DISK into the SuperPoint
    architecture (``model``, on its device, from ``params``): detector
    labels = multi-warp-stable DISK points; descriptor targets = embedded
    DISK descriptors at those points plus random coverage points, in both
    images of each warp pair. Returns (params, history); the caller gates
    on the reference-pair count."""
    from feature_tracker_tpu_torch.models.disk import DiskDetector

    disk_det = DiskDetector.from_file(max_features=64,
                                      min_feature_distance=6,
                                      device=model.device)
    if disk_det is None:
        raise FileNotFoundError("descriptor distillation needs "
                                "weights/disk.npz")
    targets_fn = _disk_teacher(disk_det)
    tx = _sp_optimizer(lr)
    step = _make_sp_distill_step(model, tx)
    rng = np.random.default_rng(seed)
    cap = 48 + n_extra_pts

    pool = []
    for _ in range(pool_size):
        img_a_, img_b_, warp = warped_texture_pair(
            rng, h, w, max_theta=0.3, max_shift=14.0,
            use_real=None if rng.uniform() < 0.2 else True)
        pts = disk_adaptation_points(img_a_, rng, disk_det, n_warps,
                                     cap=48)
        labels_a = _cell_labels_from_points(pts, h, w)
        labels_b = _cell_labels_from_points(
            [tuple(q) for q in np.asarray(warp(np.asarray(
                pts, np.float32).reshape(-1, 2)))] if pts else [],
            h, w)
        extra = np.stack([rng.uniform(4, w - 4, n_extra_pts),
                          rng.uniform(4, h - 4, n_extra_pts)],
                         -1).astype(np.float32)
        allpts = (np.concatenate(
            [np.asarray(pts, np.float32).reshape(-1, 2), extra])
            if pts else extra)
        ua, ub, pv = _fit_points(allpts, warp, h, w, cap=cap)
        tgt_a = np.array(targets_fn(img_a_, ua))
        tgt_b = np.array(targets_fn(img_b_, ub))
        z = (pv == 0)
        tgt_a[z] = 0.0
        tgt_b[z] = 0.0
        pool.append((img_a_[..., None], img_b_[..., None], labels_a,
                     labels_b, ua, ub, pv, tgt_a, tgt_b))

    opt_state = tx.init(params)
    params, _, history = _sp_train_loop(step, params, opt_state, pool,
                                        steps, rng, batch, log_every,
                                        "sp-distill")
    return params, history


# ------------------------------------------------------- DISK (stage 2)

def train_disk(steps: int = 1200, h: int = 96, w: int = 96, seed: int = 0,
               log_every: int = 200, init_params=None,
               hinge_weight: float = 0.0, lr: float = 1e-3, device="cuda"):
    """DISK training / finetuning on warped texture pairs with 192 random
    correspondences each. ``init_params`` (a ``Disk`` ``state_dict``)
    continues from existing weights, else Flax's initializers drawn from
    ``seed``; ``hinge_weight`` > 0 adds the positive-cosine hinge at the
    demo's 0.1-distance gate (``DiskTrainConfig``). Returns (model,
    params, history)."""
    from feature_tracker_tpu_torch.models.disk import Disk, DiskConfig
    from feature_tracker_tpu_torch.train.disk_train import (
        DiskTrainConfig,
        make_train_step,
    )

    tcfg = DiskTrainConfig(num_samples=192, pos_hinge_weight=hinge_weight,
                           learning_rate=lr)
    model = Disk(DiskConfig(), device=device)
    rng = np.random.default_rng(seed)
    if init_params is not None:
        params = {k: v.to(model.device)
                  for k, v in flax_order(init_params).items()}
    else:
        params = _fresh_params(model, seed)
    step, tx = make_train_step(model, tcfg)
    opt_state = tx.init(params)

    history = []
    margin = 14
    for it in range(steps):
        a, b, warp = warped_texture_pair(rng, h, w, max_theta=0.12,
                                         max_shift=8.0)
        uv_a = rng.uniform(margin, [w - margin, h - margin],
                           (tcfg.num_samples, 2)).astype(np.float32)
        uv_b = warp(uv_a).astype(np.float32)
        keep = ((uv_b[:, 0] > 2) & (uv_b[:, 0] < w - 3)
                & (uv_b[:, 1] > 2) & (uv_b[:, 1] < h - 3))
        uv_a[~keep] = margin  # degenerate but valid positives
        uv_b[~keep] = margin
        params, opt_state, loss = step(params, opt_state, a, b, uv_a, uv_b)
        if it % log_every == 0 or it == steps - 1:
            history.append({"step": it, "loss": float(loss)})
            print(f"[disk] step {it}: loss={float(loss):.4f}", flush=True)
    return model, params, history


# -------------------------------------------- LightGlue on SP (stage 3)

def _gt_assignment(uv_ref, uv_cur, warp, tol=3.0):
    """Greedy unique nearest-neighbour ground truth through the warp."""
    n = len(uv_ref)
    gt = np.full(n, -1, np.int32)
    if len(uv_cur) == 0 or n == 0:
        return gt
    proj = warp(uv_ref)
    d = np.linalg.norm(proj[:, None, :] - uv_cur[None, :, :], axis=-1)
    used = np.zeros(len(uv_cur), bool)
    for i in np.argsort(d.min(axis=1)):
        j = int(np.argmin(np.where(used, np.inf, d[i])))
        if d[i, j] < tol and not used[j]:
            gt[i] = j
            used[j] = True
    return gt


def _make_lightglue_step(model, tx):
    """``train_lightglue``'s step: ``step(params, opt_state, k0, d0, m0, k1,
    d1, m1, gt) -> (params, opt_state, loss, (correct, predicted,
    matched))`` on ``make_lightglue_sample``'s tensors, the statistics of
    the mutual-argmax matches (score >= log 0.2) of the scores before the
    update."""
    from feature_tracker_tpu_torch.models.lightglue import (
        mutual_argmax_matches,
    )
    from feature_tracker_tpu_torch.train.lightglue_train import (
        lightglue_loss,
    )

    min_score = float(np.log(0.2))

    def step(params, opt_state, k0, d0, m0, k1, d1, m1, gt):
        gt = gt.long()

        def loss_fn(p):
            scores, l0, l1 = functional_call(
                model, p, (k0, d0, m0, k1, d1, m1), {"grad": True})
            return lightglue_loss(scores, l0, l1, gt), scores.detach()

        with full_float32():
            loss, scores, grads = value_and_grad(loss_fn, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        pred = mutual_argmax_matches(scores, min_score)
        correct = torch.sum((pred == gt) & (gt >= 0))
        predicted = torch.sum(pred >= 0)
        matched = torch.sum(gt >= 0)
        return params, opt_state, loss, (correct, predicted, matched)

    return step


def train_lightglue(sp_detector, steps: int = 2000, h: int = 160,
                    w: int = 160, n_kpts: int = 192, seed: int = 0,
                    log_every: int = 200, depth: int = 9,
                    descriptor_dim: int = 256, tag: str = "lightglue",
                    init_params=None):
    """Train LightGlue on a trained detector's outputs (SuperPoint with
    descriptor_dim=256, DISK with 128), on that detector's device. The
    weights start from ``init_params`` (a ``LightGlue`` ``state_dict``)
    or Flax's initializers drawn from ``seed``. Returns (model, params,
    history)."""
    from feature_tracker_tpu_torch.models.lightglue import (
        LightGlue,
        LightGlueConfig,
    )

    cfg = LightGlueConfig(depth=depth, descriptor_dim=descriptor_dim)
    model = LightGlue(cfg, device=sp_detector.model.device)
    rng = np.random.default_rng(seed)
    if init_params is not None:
        params = {k: v.to(model.device)
                  for k, v in flax_order(init_params).items()}
    else:
        params = _fresh_params(model, seed)
    tx = _sp_optimizer(1e-4)
    opt_state = tx.init(params)
    step = _make_lightglue_step(model, tx)

    # Every detection first, then the training loop.
    n_samples = min(steps, 400)
    pool = [make_lightglue_sample(sp_detector, rng, h, w, n_kpts)
            for _ in range(n_samples)]
    history = []
    for it in range(steps):
        sample = pool[it % n_samples]
        params, opt_state, loss, (c, p, m) = step(params, opt_state,
                                                  *sample)
        if it % log_every == 0 or it == steps - 1:
            prec = float(c) / max(float(p), 1.0)
            rec = float(c) / max(float(m), 1.0)
            history.append({"step": it, "loss": float(loss),
                            "precision": prec, "recall": rec})
            print(f"[{tag}] step {it}: loss={float(loss):.4f} "
                  f"precision={prec:.3f} recall={rec:.3f} "
                  f"(gt matched {int(m)})", flush=True)
    return model, params, history


def make_lightglue_sample(sp_detector, rng, h, w, n_kpts,
                          widen: bool = True):
    """One training/eval sample: detections of ``sp_detector`` on a
    warped pair + ground truth, as tensors on its device: (k0, d0, m0,
    k1, d1, m1, gt).

    ``widen`` draws the warp magnitude per sample across the range real
    frame-to-frame motion spans (near-identity shifts through large
    displacements and rotations), so the matcher does not overfit one
    motion scale."""
    if widen:
        max_shift = float(rng.uniform(2.0, 28.0))
        max_theta = float(rng.uniform(0.0, 0.4))
    else:
        max_shift, max_theta = 12.0, 0.25
    img_a, img_b, warp = warped_texture_pair(rng, h, w,
                                             max_theta=max_theta,
                                             max_shift=max_shift)
    uv_a, da, na = sp_detector.detect(img_a)
    uv_b, db, nb = sp_detector.detect(img_b)
    na, nb = int(na), int(nb)
    uv_a, da = uv_a.cpu().numpy(), da.cpu().numpy()
    uv_b, db = uv_b.cpu().numpy(), db.cpu().numpy()
    na_c, nb_c = min(na, n_kpts), min(nb, n_kpts)
    gt = np.full(n_kpts, -1, np.int32)
    gt[:na_c] = _gt_assignment(uv_a[:na_c], uv_b[:nb_c], warp)

    def fit(a):
        return np.pad(a[:n_kpts], [(0, max(0, n_kpts - len(a)))]
                      + [(0, 0)] * (a.ndim - 1))[:n_kpts]

    m0 = np.arange(n_kpts) < na_c
    m1 = np.arange(n_kpts) < nb_c
    dev = sp_detector.model.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (fit(uv_a), fit(da), m0, fit(uv_b), fit(db), m1,
                           gt))


# ------------------------------------------------------------------ eval

def evaluate_matching(sp_detector, lg_model, lg_params, n_pairs=20,
                      h=160, w=160, n_kpts=192, seed=123):
    """Held-out precision/recall of detector + LightGlue mutual-argmax
    matches (``lg_params`` a ``state_dict`` of ``lg_model``)."""
    from feature_tracker_tpu_torch.models.lightglue import (
        mutual_argmax_matches,
    )

    rng = np.random.default_rng(seed)
    tot_c = tot_p = tot_m = 0
    for _ in range(n_pairs):
        k0, d0, m0, k1, d1, m1, gt = make_lightglue_sample(
            sp_detector, rng, h, w, n_kpts)
        scores, _, _ = functional_call(lg_model, dict(lg_params),
                                       (k0, d0, m0, k1, d1, m1))
        pred = mutual_argmax_matches(scores,
                                     float(np.log(0.2))).cpu().numpy()
        gt = gt.cpu().numpy()
        tot_c += int(((pred == gt) & (gt >= 0)).sum())
        tot_p += int((pred >= 0).sum())
        tot_m += int((gt >= 0).sum())
    return {"precision": tot_c / max(tot_p, 1),
            "recall": tot_c / max(tot_m, 1),
            "gt_matches": tot_m, "predicted": tot_p, "correct": tot_c}


# ------------------------------------------------------------------ main

def _load_reference_pair():
    base = REFERENCE_PAIR + os.sep
    try:
        from PIL import Image
        ref = np.asarray(Image.open(base + "ref_image.png").convert("L"),
                         np.float32)
        cur = np.asarray(Image.open(base + "cur_image.png").convert("L"),
                         np.float32)
        return ref, cur
    except Exception:
        return None, None


def _klt_verified(ref, cur, ruv, muv, matched, tol=3.0, device="cuda"):
    """Correctness axis for reference-pair matching: a match counts as
    VERIFIED when its endpoint lies within ``tol`` px of the per-point
    basic-KLT endpoint (FAST, 4-level pyramids, on ``device``: one launch
    of the card's FAST kernel). Points KLT cannot track are unverifiable
    and do not count. The raw nearby-match count alone is gameable: a
    partially collapsed descriptor space pushes every candidate under the
    distance gate and the argmin returns plausible-count garbage."""
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.trackers.klt import BasicKlt

    rp = build_pyramid(ref, 4, device=device)
    cp = build_pyramid(cur, 4, device=device)
    tuv, st = BasicKlt(device=device).track(rp, cp, ruv)
    tuv, st = tuv.cpu().numpy(), st.cpu().numpy()
    both = matched & (st == 1)
    err = np.linalg.norm(muv[both] - tuv[both], axis=1)
    med = round(float(np.median(err)), 2) if err.size else -1.0
    return int((err < tol).sum()), med


def _detect_capped(detector, cap, *images):
    """The detector's detections of ``images`` with ``max_features`` set
    to ``cap`` meanwhile."""
    old_cap = detector.max_features
    detector.max_features = cap
    try:
        return [detector.detect(im) for im in images]
    finally:
        detector.max_features = old_cap


def reference_pair_counts(detector, cap=300, max_valid=0.1):
    """Cosine nearby-match quality on the reference 752x480 pair (the
    demo protocol: gate 50 px, distance <= 0.1), on the detector's device.
    Returns a dict with the raw demo-protocol count, the KLT-verified
    correct count, and the median verified-match error; None when the
    reference images are absent."""
    from feature_tracker_tpu_torch.match.matcher import (
        cosine_distance_matrix,
        fill_matched_pixels,
        nearby_match,
    )
    ref, cur = _load_reference_pair()
    if ref is None:
        return None
    (ruv, rd, nr), (cuv, cd, nc) = _detect_capped(detector, cap, ref, cur)
    nr, nc = int(nr), int(nc)
    dist = cosine_distance_matrix(rd[:nr], cd[:nc])
    idx = nearby_match(dist, ruv[:nr], cuv[:nc],
                       max_valid_distance=max_valid,
                       max_col_distance=50.0, max_row_distance=50.0)
    muv, st = fill_matched_pixels(idx, cuv[:nc])
    matched = st.cpu().numpy() == 1
    verified, med = _klt_verified(ref, cur, ruv[:nr].cpu().numpy(),
                                  muv.cpu().numpy(), matched,
                                  device=detector.model.device)
    return {"raw": int(matched.sum()), "verified": verified,
            "median_err_px": med}


# BRIEF Hamming nearby-match raw count on the reference pair (300-cap
# demo protocol, deterministic): the classical anchor the learned
# detectors are judged against.
BRIEF_ANCHOR_RAW = 171


def _count_key(counts, anchor_raw=None):
    """Gate ordering: correctness first, raw demo count as tiebreak.

    With ``anchor_raw`` (detector gates at the 300-cap protocol), staying
    at-or-above the classical anchor's raw count is the FIRST axis: a
    finetune may not trade raw matches below the anchor for a small
    verified gain once the incumbent clears it."""
    key = (counts["verified"], counts["raw"])
    if anchor_raw is not None:
        key = (counts["raw"] >= anchor_raw,) + key
    return key


def reference_pair_match_count(detector, cap=300, max_valid=0.1):
    """Raw demo-protocol count (see reference_pair_counts)."""
    c = reference_pair_counts(detector, cap=cap, max_valid=max_valid)
    return -1 if c is None else c["raw"]


def reference_pair_lightglue_counts(detector, model, params, cap=250):
    """LightGlue mutual-argmax match quality on the reference pair (the
    nn_matcher demo protocol: 250 keypoints, score >= log(0.03)), with
    ``params`` a ``state_dict`` of ``model``. Returns {raw, verified,
    median_err_px} like reference_pair_counts."""
    from feature_tracker_tpu_torch.models.lightglue import (
        mutual_argmax_matches,
    )
    ref, cur = _load_reference_pair()
    if ref is None:
        return None
    (ruv, rd, nr), (cuv, cd, nc) = _detect_capped(detector, cap, ref, cur)
    dev = ruv.device
    m0 = torch.arange(cap, device=dev) < nr
    m1 = torch.arange(cap, device=dev) < nc
    with torch.inference_mode():
        scores, _, _ = functional_call(model, dict(params),
                                       (ruv[:cap], rd[:cap], m0, cuv[:cap],
                                        cd[:cap], m1))
    pred = mutual_argmax_matches(scores,
                                 float(np.log(0.03))).cpu().numpy()
    pred = pred[: int(nr)]
    matched = pred >= 0
    muv = cuv.cpu().numpy()[np.where(matched, pred, 0)]
    verified, med = _klt_verified(ref, cur, ruv[: int(nr)].cpu().numpy(),
                                  muv, matched, device=dev)
    return {"raw": int(matched.sum()), "verified": verified,
            "median_err_px": med}


def reference_pair_lightglue_count(detector, model, params, cap=250):
    """Raw demo-protocol count (see reference_pair_lightglue_counts)."""
    c = reference_pair_lightglue_counts(detector, model, params, cap=cap)
    return -1 if c is None else c["raw"]


def _save_weights(path, params):
    """``params`` (a ``state_dict``) in the JAX package's npz layout."""
    save_pytree(path, flax_variables_from_state(params))


def main(sp_steps=1500, disk_steps=1200, lg_steps=2000, adapt_rounds=2,
         adapt_steps=800, reuse=0, lg_only=0, adapt_seed=11,
         desc_temp_milli=100, det_weight_pct=100, disk_adapt=0,
         pt_desc=0, adapt_lr_micro=100, distill=0, distill_batch=4,
         distill_pool=360, lg_disk_steps=-1, disk_reuse=0,
         disk_hinge_milli=0, disk_lr_micro=1000, wide_scale=-1,
         adapt_pool=360, device="cuda"):
    from feature_tracker_tpu_torch.models.disk import DiskDetector
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
        SuperPointDetector,
    )
    from feature_tracker_tpu_torch.utils.weights import (
        load_lightglue_npz,
        load_superpoint_npz,
    )

    dev = resolve_device(device)
    os.makedirs(WEIGHTS_DIR, exist_ok=True)
    t0 = time.time()
    metrics = {}
    mpath = os.path.join(WEIGHTS_DIR, "metrics.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            metrics = json.load(f)
    # Snapshot for the merge-at-save diff (see the bottom of main).
    metrics_at_start = {k: json.loads(json.dumps(v))
                        for k, v in metrics.items()}

    sp_path = os.path.join(WEIGHTS_DIR, "superpoint.npz")

    def _sp_load(path):
        return {k: v.to(dev)
                for k, v in flax_order(load_superpoint_npz(path)).items()}

    def _sp_counts(params):
        return reference_pair_counts(
            SuperPointDetector(params, max_features=300,
                               min_response=0.01, device=dev))

    def _key(counts):
        # None = reference images absent: everything compares equal and
        # all gates pass (there is no judged pair to measure against).
        if not counts:
            return (False, -1, -1)
        return _count_key(counts, anchor_raw=BRIEF_ANCHOR_RAW)

    reused = (reuse or lg_only) and os.path.exists(sp_path)
    if reused:
        # lg_only implies reuse: retraining LightGlue only makes sense on
        # the descriptor space of the SHIPPED SuperPoint weights.
        sp_model = SuperPoint(SuperPointConfig(), device=dev)
        sp_params = _sp_load(sp_path)
        print("[superpoint] reusing existing weights", flush=True)
    else:
        sp_model, sp_params, sp_hist = train_superpoint(sp_steps,
                                                        device=dev)
        metrics["superpoint"] = sp_hist[-1]

    # Counts of the weights currently on disk, for the shipping gate.
    # Computed lazily; when this run reused the on-disk weights, the
    # pre-adapt evaluation doubles as the on-disk evaluation.
    on_disk_counts = None
    params_modified = not reused

    cand_counts = None
    if adapt_rounds > 0 and not lg_only:
        # Gate baseline: the counts of the CURRENT sp_params (when
        # freshly trained, that is NOT the on-disk weights' entry).
        pre_counts = _sp_counts(sp_params)
        print(f"[superpoint] pre-adapt reference-pair counts: "
              f"{pre_counts}", flush=True)
        if reused:
            on_disk_counts = pre_counts
        if distill:
            new_params, ahist = distill_superpoint_from_disk(
                sp_model, sp_params, steps=adapt_steps, seed=adapt_seed,
                lr=adapt_lr_micro / 1e6, batch=distill_batch,
                pool_size=distill_pool)
        else:
            # disk_adapt: 0 = harris voting labels, 1 = warp-stable DISK
            # labels, 2 = dense per-image DISK labels + wide-scale warps,
            # 3 = sparse per-image top-K DISK labels.
            labeler = {0: "harris", 1: "disk", 2: "disk_dense",
                       3: "disk_topk"}[int(disk_adapt)]
            ws = (disk_adapt in (2, 3)) if wide_scale < 0 \
                else bool(wide_scale)
            new_params, ahist = adapt_superpoint(
                sp_model, sp_params, rounds=adapt_rounds,
                steps=adapt_steps, seed=adapt_seed,
                desc_temp=desc_temp_milli / 1000.0,
                det_weight=det_weight_pct / 100.0,
                labeler=labeler, pool_size=adapt_pool,
                point_desc=bool(pt_desc), lr=adapt_lr_micro / 1e6,
                wide_scale=ws)
        new_counts = _sp_counts(new_params)
        print(f"[superpoint] adapted reference-pair counts: {new_counts} "
              f"(previous {pre_counts})", flush=True)
        # Regression guard, verified-correct count first (the raw count
        # alone is gameable by descriptor collapse — see _klt_verified).
        if _key(new_counts) >= _key(pre_counts):
            sp_params = new_params
            metrics["superpoint_adapt"] = ahist[-1]
            cand_counts = new_counts
            params_modified = True
        else:
            metrics["superpoint_adapt_rejected"] = {
                "counts": new_counts, "kept": pre_counts}
            cand_counts = pre_counts

    if cand_counts is None:
        cand_counts = _sp_counts(sp_params)
    # Shipping gate: never overwrite on-disk weights that match better on
    # the judged pair than what this run produced.
    if os.path.exists(sp_path) and params_modified:
        if on_disk_counts is None:
            on_disk_counts = _sp_counts(_sp_load(sp_path))
        if _key(cand_counts) < _key(on_disk_counts):
            print(f"[superpoint] ship REJECTED: fresh {cand_counts} < "
                  f"on-disk {on_disk_counts}; keeping existing weights",
                  flush=True)
            metrics["superpoint_ship_rejected"] = {
                "counts": cand_counts, "kept": on_disk_counts}
            sp_params = _sp_load(sp_path)
            cand_counts = on_disk_counts
            params_modified = False
    if params_modified or not os.path.exists(sp_path):
        _save_weights(sp_path, sp_params)

    sp_det = SuperPointDetector(sp_params, max_features=192,
                                min_response=0.01, device=dev)
    if cand_counts:
        metrics["superpoint_reference_pair"] = cand_counts["raw"]
        metrics["superpoint_reference_pair_verified"] = (
            cand_counts["verified"])
        metrics["superpoint_reference_pair_median_err"] = (
            cand_counts["median_err_px"])
    print(f"[superpoint] reference-pair nearby-match: "
          f"{cand_counts}", flush=True)

    if not lg_only:
        if disk_steps > 0:
            disk_path = os.path.join(WEIGHTS_DIR, "disk.npz")
            init_dp = None
            if disk_reuse and os.path.exists(disk_path):
                init_dp = DiskDetector.from_file(disk_path,
                                                 device=dev).variables
                print("[disk] finetuning from existing weights",
                      flush=True)
            disk_model, disk_params, disk_hist = train_disk(
                disk_steps, init_params=init_dp,
                hinge_weight=disk_hinge_milli / 1000.0,
                lr=disk_lr_micro / 1e6, device=dev)
            metrics["disk"] = disk_hist[-1]
            dc = reference_pair_counts(
                DiskDetector(disk_params, max_features=300, device=dev))
            # Ship gate, same (verified, raw) ordering as SuperPoint:
            # never overwrite on-disk DISK weights that match better.
            if dc and os.path.exists(disk_path):
                old_c = reference_pair_counts(
                    DiskDetector.from_file(disk_path, max_features=300,
                                           device=dev))
                if old_c and (_count_key(dc, BRIEF_ANCHOR_RAW)
                              < _count_key(old_c, BRIEF_ANCHOR_RAW)):
                    print(f"[disk] ship REJECTED: fresh {dc} < on-disk "
                          f"{old_c}; keeping existing weights",
                          flush=True)
                    metrics["disk_ship_rejected"] = {
                        "counts": dc, "kept": old_c}
                    disk_params = DiskDetector.from_file(
                        disk_path, device=dev).variables
                    dc = old_c
                else:
                    _save_weights(disk_path, disk_params)
            else:
                _save_weights(disk_path, disk_params)
            if dc:
                metrics["disk_reference_pair"] = dc["raw"]
                metrics["disk_reference_pair_verified"] = dc["verified"]
            print(f"[disk] reference-pair nearby-match: {dc}",
                  flush=True)

    def _ship_lightglue(fname, det, model, params, prefix, dim):
        """Save LightGlue weights gated on reference-pair (verified, raw)
        vs the file currently on disk — both evaluated with the SAME
        (current) detector, so a stale matcher trained on an older
        descriptor space loses to a fresh one fairly. Returns the params
        that ended up shipped and records their counts in metrics."""
        path = os.path.join(WEIGHTS_DIR, fname)
        new_c = reference_pair_lightglue_counts(det, model, params)
        if new_c and os.path.exists(path):
            try:
                old_params = {k: v.to(dev) for k, v in flax_order(
                    load_lightglue_npz(path, model.cfg)).items()}
                old_c = reference_pair_lightglue_counts(det, model,
                                                        old_params)
            except Exception:
                old_c = None
            if old_c and _count_key(new_c) < _count_key(old_c):
                print(f"[{prefix}] ship REJECTED: fresh {new_c} < "
                      f"on-disk {old_c}; keeping existing weights",
                      flush=True)
                metrics[prefix + "_ship_rejected"] = {
                    "counts": new_c, "kept": old_c}
                params, new_c = old_params, old_c
            else:
                _save_weights(path, params)
        else:
            _save_weights(path, params)
        if new_c:
            metrics[prefix + "_reference_pair"] = new_c["raw"]
            metrics[prefix + "_reference_pair_verified"] = new_c["verified"]
        print(f"[{prefix}] reference-pair matches: {new_c}", flush=True)
        return params

    if lg_steps > 0:
        lg_model, lg_params, lg_hist = train_lightglue(sp_det, lg_steps)
        metrics["lightglue"] = lg_hist[-1]
        lg_params = _ship_lightglue("lightglue_superpoint.npz", sp_det,
                                    lg_model, lg_params, "lightglue", 256)
        metrics["heldout"] = evaluate_matching(sp_det, lg_model,
                                               lg_params)

        # The DISK-descriptor LightGlue variant, on the stronger detector.
        lgd_steps = lg_steps if lg_disk_steps < 0 else lg_disk_steps
        disk_det = (DiskDetector.from_file(max_features=192, device=dev)
                    if lgd_steps > 0 else None)
        if disk_det is not None:
            lgd_model, lgd_params, lgd_hist = train_lightglue(
                disk_det, lgd_steps, descriptor_dim=128,
                tag="lightglue-disk")
            metrics["lightglue_disk"] = lgd_hist[-1]
            lgd_params = _ship_lightglue("lightglue_disk.npz", disk_det,
                                         lgd_model, lgd_params,
                                         "lightglue_disk", 128)
            metrics["heldout_disk"] = evaluate_matching(
                disk_det, lgd_model, lgd_params)
    metrics["wall_s"] = round(time.time() - t0, 1)
    # Merge-at-save: another training driver (raft/cotracker pretrain)
    # may have updated metrics.json while this run was going. Re-read the
    # file and overlay only the keys THIS run changed, so concurrent
    # updates to untouched keys survive (per-key last-writer-wins).
    changed = {k: v for k, v in metrics.items()
               if k not in metrics_at_start or metrics_at_start[k] != v}
    if os.path.exists(mpath):
        with open(mpath) as f:
            merged = json.load(f)
    else:
        merged = {}
    merged.update(changed)
    metrics = merged
    with open(mpath, "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    import sys
    kw = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = v if k == "device" else int(v)
    main(**kw)
