"""Brief RAFT training on synthetic flow + held-out EPE — the counterpart of
``feature_tracker_tpu/train/raft_pretrain.py``.

Short supervised training on dense synthetic similarity-warp flow (exactly
known per-pixel ground truth, ``train/pretrain.py::warped_texture_pair``),
then EPE and outlier fractions on held-out pairs. When the held-out EPE
beats the one recorded in ``WEIGHTS_DIR/metrics.json`` (or none is
recorded), the weights are written to ``WEIGHTS_DIR`` in the JAX package's
npz layout (``raft.npz``, or ``raft_small.npz`` for the compact model) and
the metrics beside them. ``WEIGHTS_DIR`` is the repository's ``weights/``:
point it elsewhere (``raft_pretrain.WEIGHTS_DIR = ...``) for a trial run.

Run: ``python -m feature_tracker_tpu_torch.train.raft_pretrain
[steps=N] [device=cpu]`` (the card by default).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from feature_tracker_tpu_torch.convert import flax_variables_from_state
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.raft import Raft, RaftConfig
from feature_tracker_tpu_torch.train.pretrain import warped_texture_pair
from feature_tracker_tpu_torch.train.raft_eval import flow_metrics
from feature_tracker_tpu_torch.train.raft_train import (
    RaftTrainConfig,
    create_train_state,
    make_train_step,
)
from feature_tracker_tpu_torch.utils.weights import WEIGHTS_DIR, save_pytree


def synthetic_flow_sample(rng, h, w, max_theta=0.1, max_shift=6.0,
                          augment=True):
    """(ref, cur, flow): dense ground-truth flow of a similarity warp —
    a point at p in ref appears at warp(p) in cur, so
    flow(p) = warp(p) - p, known exactly at every pixel."""
    ref, cur, warp = warped_texture_pair(rng, h, w, max_theta=max_theta,
                                         max_shift=max_shift,
                                         augment=augment)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xx.reshape(-1), yy.reshape(-1)], -1)
    proj = warp(pts)
    flow = (proj - pts).reshape(h, w, 2).astype(np.float32)
    return ref.astype(np.float32), cur.astype(np.float32), flow


def make_pool(rng, n, h, w, batch, augment=True, device="cuda"):
    """``n`` batches (ref ``[B, H, W, 1]``, cur, flow ``[B, H, W, 2]``) as
    tensors on ``device``."""
    dev = resolve_device(device)
    pool = []
    for _ in range(n):
        refs, curs, flows = [], [], []
        for _ in range(batch):
            r, c, f = synthetic_flow_sample(rng, h, w, augment=augment)
            refs.append(r[..., None])
            curs.append(c[..., None])
            flows.append(f)
        pool.append(tuple(torch.from_numpy(np.stack(a)).to(dev)
                          for a in (refs, curs, flows)))
    return pool


def make_real_pool(rng, n, h, w, batch, device="cuda"):
    """Batches of REAL consecutive-frame crop pairs (the reference KITTI
    sequence, ``train/pretrain.py::_real_image_pool``) for the
    photometric-warp step — real motion has no dense flow ground truth, so
    these train unsupervised. Returns [] when the imagery is unavailable."""
    from feature_tracker_tpu_torch.train.pretrain import _real_image_pool

    frames = _real_image_pool()
    if len(frames) < 2:
        return []
    dev = resolve_device(device)
    pool = []
    for _ in range(n):
        refs, curs = [], []
        for _ in range(batch):
            i = int(rng.integers(len(frames) - 1))
            a, b = frames[i], frames[i + 1]
            ih, iw = a.shape
            oy = int(rng.integers(0, ih - h))
            ox = int(rng.integers(0, iw - w))
            refs.append(a[oy:oy + h, ox:ox + w, None])
            curs.append(b[oy:oy + h, ox:ox + w, None])
        pool.append(tuple(torch.from_numpy(np.stack(a)).to(dev)
                          for a in (refs, curs)))
    return pool


def jax_variables(params: dict, batch_stats: dict) -> dict:
    """A RAFT state (``state_dict`` keys) as the Flax variables tree the
    JAX package's weight files hold: ``{"params": ..., "batch_stats":
    ...}`` of numpy arrays, convolution kernels HWIO, ``scale`` / ``mean``
    / ``var`` leaves (``convert.py::flax_variables_from_state``)."""
    return flax_variables_from_state({**params, **batch_stats})


def main(steps: int = 600, h: int = 128, w: int = 128, batch: int = 4,
         iters: int = 8, seed: int = 0, log_every: int = 50,
         eval_pairs: int = 16, augment: int = 0, small: int = 0,
         real_pct: int = 0, lr_micro: int = 0, gate: int = 1,
         pool_size: int = 150, device="cuda"):
    """``real_pct`` interleaves UNSUPERVISED photometric-warp steps on
    real consecutive frame crops (make_unsup_train_step) with the
    supervised synthetic steps. ``gate`` keeps the on-disk weights when
    the held-out EPE regressed."""
    from feature_tracker_tpu_torch.train.raft_train import (
        make_unsup_train_step,
    )

    dev = resolve_device(device)
    os.makedirs(WEIGHTS_DIR, exist_ok=True)
    t0 = time.time()
    if small:
        # Compact config: the full-size model needs RAFT-paper-scale step
        # counts to escape the predict-the-mean basin; the compact model
        # demonstrates correlation-driven learning within a short budget.
        cfg = RaftConfig(max_iterations=iters, feature_channels=64,
                         context_channels=64, hidden_channels=32,
                         correlation_pyramid_levels=2,
                         correlation_radius=3,
                         correlation_hidden_channels=32,
                         correlation_out_channels=16,
                         flow_hidden_channels=16, flow_out_channels=8,
                         motion_out_channels=16, mask_hidden_channels=32)
    else:
        cfg = RaftConfig(max_iterations=iters)
    lr = (lr_micro * 1e-6) if lr_micro > 0 else (4e-4 if small else 3e-4)
    tcfg = RaftTrainConfig(learning_rate=lr, schedule_steps=steps)
    rng = np.random.default_rng(seed)

    state = create_train_state(seed, cfg, tcfg, (batch, h, w, 1), device=dev)
    step = make_train_step(cfg, tcfg)

    # Photometric augmentation off by default: with batch-4 BatchNorm and
    # a small model the gain/bias jitter dominated the loss.
    pool = make_pool(rng, min(steps, pool_size), h, w, batch,
                     augment=bool(augment), device=dev)
    real_pool = (make_real_pool(rng, min(steps, pool_size), h, w, batch,
                                device=dev)
                 if real_pct > 0 else [])
    ustep = make_unsup_train_step(cfg, tcfg) if real_pool else None
    ri = 0
    for it in range(steps):
        if real_pool and rng.uniform() < real_pct / 100.0:
            ref, cur = real_pool[ri % len(real_pool)]
            ri += 1
            state, metrics = ustep(state, ref, cur)
            if it % log_every == 0 or it == steps - 1:
                print(f"[raft] step {it} (real/photo): "
                      f"loss={float(metrics['loss']):.3f} "
                      f"mean_flow={float(metrics['mean_flow']):.2f}",
                      flush=True)
            continue
        ref, cur, gt = pool[it % len(pool)]
        state, metrics = step(state, ref, cur, gt)
        if it % log_every == 0 or it == steps - 1:
            print(f"[raft] step {it}: loss={float(metrics['loss']):.3f} "
                  f"epe={float(metrics['epe']):.3f}", flush=True)

    # Held-out evaluation at the FINAL refinement iteration.
    model = Raft(cfg, device=dev)
    model.load_state_dict({**state.params, **state.batch_stats},
                          strict=False)
    eval_rng = np.random.default_rng(seed + 1000)
    n_eval_batches = max(1, -(-eval_pairs // batch))  # ceil, never 0
    epool = make_pool(eval_rng, n_eval_batches, h, w, batch,
                      augment=bool(augment), device=dev)
    agg = None
    zero_epe = 0.0
    for ref, cur, gt in epool:
        preds = model(ref, cur)
        m = {k: float(v) for k, v in flow_metrics(preds[-1], gt).items()}
        agg = m if agg is None else {k: agg[k] + m[k] for k in m}
        zero_epe += float(torch.mean(torch.linalg.vector_norm(gt, dim=-1)))
    agg = {k: round(v / len(epool), 4) for k, v in agg.items()}
    # The do-nothing baseline: EPE of predicting zero flow.
    agg["zero_flow_epe"] = round(zero_epe / len(epool), 4)
    agg["pairs"] = n_eval_batches * batch
    agg["resolution"] = f"{w}x{h}"
    agg["config"] = "compact" if small else "full"
    agg["iterations"] = iters
    agg["train_steps"] = steps
    agg["real_photometric_pct"] = real_pct
    agg["lr_peak"] = lr
    agg["wall_s"] = round(time.time() - t0, 1)
    print("[raft] held-out:", json.dumps(agg), flush=True)

    key = "raft_small" if small else "raft"
    mpath = os.path.join(WEIGHTS_DIR, "metrics.json")
    metrics_all = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            metrics_all = json.load(f)
    prev_entry = metrics_all.get(key, {})
    prev = prev_entry.get("epe")
    # Gated ship: never overwrite weights with a run that regressed the
    # held-out EPE. EPEs only compare at the same eval resolution; a
    # mismatched resolution keeps the on-disk weights (gate=0 forces).
    if gate and prev is not None \
            and prev_entry.get("resolution") != agg["resolution"]:
        print(f"[raft] gate-rejected (eval resolution "
              f"{agg['resolution']} != shipped "
              f"{prev_entry.get('resolution')}); weights unchanged",
              flush=True)
        return agg
    if gate and prev is not None and agg["epe"] >= prev:
        print(f"[raft] gate-rejected (epe {agg['epe']} >= prev {prev}); "
              f"weights unchanged", flush=True)
        return agg
    save_pytree(os.path.join(WEIGHTS_DIR,
                             "raft_small.npz" if small else "raft.npz"),
                jax_variables(state.params, state.batch_stats))
    metrics_all[key] = agg
    with open(mpath, "w") as f:
        json.dump(metrics_all, f, indent=2)
    if prev is not None:
        print(f"[raft] shipped (epe {agg['epe']} < prev {prev})",
              flush=True)
    return agg


if __name__ == "__main__":
    import sys
    kw = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = v if k == "device" else int(v)
    main(**kw)
