"""Brief CoTracker training on synthetic videos + held-out track EPE — the
counterpart of ``feature_tracker_tpu/train/cotracker_pretrain.py``.

Short supervised training on synthetic videos whose per-frame point tracks
are exactly known (a smooth chain of similarity warps applied to textured
or real imagery), optionally mixed with crops of the real KITTI-style
sequence carrying KLT-verified pseudo-label tracks, then endpoint error on
held-out videos against the zero-motion baseline. Every
``numpy.random.Generator`` is drawn from as the JAX package draws from it,
so a seed gives the same videos. The step (``make_train_step``) supervises
every refinement iteration with a Huber loss, trains the visibility
logits, applies optax's clipped AdamW on a warm-up and cosine schedule and
keeps an exponential moving average of the parameters, which is what is
evaluated and shipped: ``main`` writes ``cotracker.npz`` in the JAX
package's npz layout and ``metrics.json["cotracker"]`` under
``WEIGHTS_DIR`` (the repository's ``weights/``; point it elsewhere for a
trial run) when the held-out EPE beats the recorded one.

Run: ``python -m feature_tracker_tpu_torch.train.cotracker_pretrain
[steps=N ...] [device=cpu]`` (the card by default).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from feature_tracker_tpu_torch.convert import flax_variables_from_state
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.cotracker import (
    CoTracker,
    CoTrackerConfig,
)
from feature_tracker_tpu_torch.models.layers import flax_init_, flax_order
from feature_tracker_tpu_torch.models.raft import full_float32
from feature_tracker_tpu_torch.train.optim import (
    ClipAdamW,
    _flat,
    _unflat,
    apply_updates,
    value_and_grad,
    warmup_cosine_schedule,
)
from feature_tracker_tpu_torch.train.pretrain import (
    _bilinear_np,
    _photometric,
    _real_image_pool,
    _Texture,
)
from feature_tracker_tpu_torch.utils.weights import WEIGHTS_DIR, save_pytree


def synthetic_video(rng, t, h, w, n_points, max_theta_step=0.04,
                    max_shift_step=2.5, augment=True):
    """(video [T,H,W,1], queries [N,2], tracks [T,N,2], vis [T,N]).

    Frame k renders the base image under the CUMULATIVE similarity warp
    W_k = S_k ∘ ... ∘ S_1 (W_0 = identity), each step S_i a small random
    rotation/scale/shift about the image center — a smooth trajectory. A
    point at p in frame 0 appears at W_k(p) in frame k, known exactly;
    visibility is the in-frame indicator."""
    pool = _real_image_pool()
    use_real = len(pool) > 0 and rng.uniform() < 0.5
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    center = np.array([w / 2.0, h / 2.0])

    if use_real:
        img = pool[rng.integers(len(pool))]
        ih, iw = img.shape
        margin = 40
        ox = rng.uniform(margin, iw - w - margin)
        oy = rng.uniform(margin, ih - h - margin)
        base = _bilinear_np(img, xx + ox, yy + oy).astype(np.float32)
    else:
        tex = _Texture(rng)
        base = tex.eval(xx, yy).astype(np.float32)

    rot = np.eye(2)
    trans = np.zeros(2)
    frames = [base]
    rots, transs = [rot], [trans]
    for _ in range(t - 1):
        th = rng.uniform(-max_theta_step, max_theta_step)
        sc = rng.uniform(0.98, 1.02)
        c, s = np.cos(th) * sc, np.sin(th) * sc
        step_rot = np.array([[c, -s], [s, c]])
        step_t = (center + rng.uniform(-max_shift_step, max_shift_step, 2)
                  - step_rot @ center)
        rot = step_rot @ rot
        trans = step_rot @ trans + step_t
        rinv = np.linalg.inv(rot)
        src = np.stack([xx - trans[0], yy - trans[1]], -1) @ rinv.T
        frame = _bilinear_np(base, src[..., 0], src[..., 1])
        if augment:
            frame = _photometric(rng, frame)
        frames.append(frame.astype(np.float32))
        rots.append(rot)
        transs.append(trans)

    margin = 6
    queries = np.stack([rng.uniform(margin, w - margin, n_points),
                        rng.uniform(margin, h - margin, n_points)],
                       -1)                                      # [N, 2]
    tracks = np.stack([queries @ np.asarray(r).T + tt
                       for r, tt in zip(rots, transs)], 0)      # [T, N, 2]
    vis = ((tracks[..., 0] >= 0) & (tracks[..., 0] <= w - 1)
           & (tracks[..., 1] >= 0) & (tracks[..., 1] <= h - 1))
    video = np.stack(frames)[..., None]
    return (video.astype(np.float32), queries.astype(np.float32),
            tracks.astype(np.float32), vis.astype(np.float32))


_REAL_TRACKS = None


def _np_pyramid(img, levels=4):
    """Numpy twin of ops.pyramid.build_pyramid(quantize=True): label
    generation runs on the host (the native CPU KLT does the tracking)."""
    pyr = [np.floor(img).astype(np.float32)]
    for _ in range(levels - 1):
        a = pyr[-1]
        h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
        pyr.append(np.floor((a[0:h2:2, 0:w2:2] + a[1:h2:2, 0:w2:2]
                             + a[0:h2:2, 1:w2:2] + a[1:h2:2, 1:w2:2])
                            * 0.25))
    return pyr


def _real_video_tracks(grid_step=6, margin=20, fb_tol=0.5):
    """REAL video with KLT-verified pseudo-label tracks: the real
    sequence (``train/pretrain.py::_real_image_pool``), dense grid seeds
    tracked 0->5 by the native CPU fast KLT (``runtime/cpu_baseline.py``,
    chained pairs), then 5->0 from the endpoints; a track survives only
    if every status is TRACKED both ways and the round trip returns within
    ``fb_tol`` px.

    Returns (frames [6, H, W] f32, tracks [6, M, 2] f32), cached; (None,
    None) when the imagery or the native library is unavailable."""
    global _REAL_TRACKS
    if _REAL_TRACKS is not None:
        return _REAL_TRACKS
    _REAL_TRACKS = (None, None)
    try:
        from feature_tracker_tpu_torch.core.config import KltOptions
        from feature_tracker_tpu_torch.runtime.cpu_baseline import (
            klt_fast_cpu,
        )

        frames = _real_image_pool()
        if len(frames) < 3:
            return _REAL_TRACKS
        frames = np.stack(frames[:6])
        t, (ih, iw) = frames.shape[0], frames.shape[1:]
        xs = np.arange(margin, iw - margin, grid_step, dtype=np.float32)
        ys = np.arange(margin, ih - margin, grid_step, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        uv0 = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        opts = KltOptions(max_track_points=uv0.shape[0])
        pyrs = [_np_pyramid(f) for f in frames]

        fwd = [uv0]
        alive = np.ones(uv0.shape[0], bool)
        uv, st = uv0, None
        for i in range(t - 1):
            uv, st = klt_fast_cpu(pyrs[i], pyrs[i + 1], uv, cur_uv=uv,
                                  status=st, opts=opts)
            alive &= (st == 1)
            fwd.append(uv)
        buv, bst = fwd[-1], None
        for i in range(t - 1, 0, -1):
            buv, bst = klt_fast_cpu(pyrs[i], pyrs[i - 1], buv, cur_uv=buv,
                                    status=bst, opts=opts)
            alive &= (bst == 1)
        alive &= (np.linalg.norm(buv - uv0, axis=-1) < fb_tol)
        tracks = np.stack(fwd)[:, alive]          # [T, M, 2]
        if tracks.shape[1] >= 64:
            _REAL_TRACKS = (frames, tracks.astype(np.float32))
    except Exception:
        pass
    return _REAL_TRACKS


def real_video_sample(rng, t, h, w, n_points, augment=True,
                      max_drift_step=3.0):
    """One training sample from the REAL sequence: a crop window (with a
    smooth random per-frame drift — known camera shake on top of the
    real scene motion) around a randomly chosen verified track, frame
    indices ping-ponged to length ``t``. Same contract as
    synthetic_video; returns None when real data is unavailable."""
    frames, tracks = _real_video_tracks()
    if frames is None:
        return None
    tf, (ih, iw) = frames.shape[0], frames.shape[1:]
    idx = list(range(tf))
    while len(idx) < t:  # ping-pong: 0,1,..,5,4,3,.. (real motion both ways)
        nxt = idx[-2] if len(idx) >= 2 else 0
        step = -1 if idx[-1] > nxt else 1
        idx.append(idx[-1] + step if 0 <= idx[-1] + step < tf else 1)
    idx = np.asarray(idx[:t])

    margin = 6
    for _ in range(20):
        anchor = tracks[0, rng.integers(tracks.shape[1])]
        ox = np.clip(anchor[0] - rng.uniform(margin, w - margin),
                     0, iw - w - 1 - max_drift_step * t)
        oy = np.clip(anchor[1] - rng.uniform(margin, h - margin),
                     0, ih - h - 1 - max_drift_step * t)
        ox = max(ox, max_drift_step * t)
        oy = max(oy, max_drift_step * t)
        in0 = ((tracks[0, :, 0] >= ox + margin)
               & (tracks[0, :, 0] <= ox + w - margin)
               & (tracks[0, :, 1] >= oy + margin)
               & (tracks[0, :, 1] <= oy + h - margin))
        if in0.sum() >= n_points:
            break
    else:
        return None
    sel = rng.choice(np.nonzero(in0)[0], n_points, replace=False)

    # Smooth window drift: origin_k = origin + cumsum of small steps.
    drift = np.zeros((t, 2))
    drift[1:] = np.cumsum(
        rng.uniform(-max_drift_step, max_drift_step, (t - 1, 2)), axis=0)
    origins = np.stack([ox, oy]) + drift                    # [t, 2]

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    vid = []
    for k in range(t):
        f = _bilinear_np(frames[idx[k]], xx + origins[k, 0],
                         yy + origins[k, 1])
        if augment and k > 0:
            f = _photometric(rng, f)
        vid.append(f.astype(np.float32))
    video = np.stack(vid)[..., None]

    tr = tracks[idx][:, sel] - origins[:, None, :]          # [t, N, 2]
    queries = tr[0]
    vis = ((tr[..., 0] >= 0) & (tr[..., 0] <= w - 1)
           & (tr[..., 1] >= 0) & (tr[..., 1] <= h - 1))
    return (video.astype(np.float32), queries.astype(np.float32),
            tr.astype(np.float32), vis.astype(np.float32))


def make_pool(rng, n, batch, t, h, w, n_points, augment=True,
              wide_motion=False, real_frac=0.0, device="cuda"):
    """``n`` batches (videos ``[B, T, H, W, 1]``, queries ``[B, N, 2]``,
    tracks ``[B, T, N, 2]``, visibility ``[B, T, N]``) as tensors on
    ``device``. ``wide_motion`` samples per-video step magnitudes up to
    ~6 px shift / 0.08 rad (with the default gentle motion the zero-motion
    baseline is already ~3 px and hard to beat early; larger displacements
    make standing still a bad predictor); ``real_frac`` is the share of
    real-video samples."""
    dev = resolve_device(device)
    pool = []
    for _ in range(n):
        vids, qs, trs, vs = [], [], [], []
        for _ in range(batch):
            sample = None
            if real_frac > 0 and rng.uniform() < real_frac:
                sample = real_video_sample(rng, t, h, w, n_points,
                                           augment=augment)
            if sample is None:
                if wide_motion:
                    kw = {"max_theta_step": rng.uniform(0.01, 0.08),
                          "max_shift_step": rng.uniform(1.0, 6.0)}
                else:
                    kw = {}
                sample = synthetic_video(rng, t, h, w, n_points,
                                         augment=augment, **kw)
            v, q, tr, vi = sample
            vids.append(v)
            qs.append(q)
            trs.append(tr)
            vs.append(vi)
        pool.append(tuple(torch.from_numpy(np.stack(a)).to(dev)
                          for a in (vids, qs, trs, vs)))
    return pool


def _sigmoid_binary_cross_entropy(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``: ``-z log sigmoid(x) -
    (1 - z) log sigmoid(-x)``, elementwise (torch's
    ``binary_cross_entropy_with_logits`` rounds otherwise)."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def make_train_step(model, tx, gamma: float = 0.8):
    """``step(params, ema, opt_state, video, queries, tracks, vis) ->
    (params, ema, opt_state, loss, epe)`` for a ``CoTracker`` and a
    ``ClipAdamW``, on batches of ``make_pool``; ``params`` and ``ema`` are
    the model's ``state_dict`` entries in Flax's order. Nothing passed in
    is modified."""

    def loss_fn(params, video, queries, tracks, vis):
        outs = [functional_call(model, params, (v, q),
                                {"return_all_iterations": True,
                                 "grad": True})
                for v, q in zip(video, queries)]
        vis_logits = torch.stack([o[1] for o in outs])    # [B, T, N]
        pred_iters = torch.stack([o[2] for o in outs])    # [B, K, T, N, 2]
        # Supervision of EVERY refinement iteration with exponentially
        # increasing weights gamma^(K-1-k) (supervising only the final
        # positions starves the early iterations of gradient signal).
        d = pred_iters - tracks[:, None]                 # [B, K, T, N, 2]
        # Epsilon-smoothed norm: with zero-init heads the frame-0
        # prediction EQUALS the target exactly, where the norm's gradient
        # is undefined.
        err = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-8)  # [B, K, T, N]
        huber = torch.where(err < 4.0, 0.5 * err * err, 4.0 * err - 8.0)
        k = err.shape[1]
        wts = torch.pow(torch.full((), gamma, device=err.device),
                        torch.arange(k - 1, -1, -1, dtype=torch.float32,
                                     device=err.device))
        n_vis = torch.clamp(torch.sum(vis), min=1.0)
        per_iter = torch.sum(huber * vis[:, None], dim=(0, 2, 3)) / n_vis
        pos_loss = torch.sum(wts * per_iter) / torch.sum(wts)
        vis_loss = torch.mean(_sigmoid_binary_cross_entropy(vis_logits,
                                                            vis))
        epe = torch.sum(err[:, -1] * vis) / n_vis
        return pos_loss + vis_loss, epe.detach()

    def step(params, ema, opt_state, video, queries, tracks, vis):
        dev = next(iter(params.values())).device
        video, queries, tracks, vis = (
            torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (video, queries, tracks, vis))
        with full_float32():
            loss, epe, grads = value_and_grad(
                lambda p: loss_fn(p, video, queries, tracks, vis), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        # Parameter EMA for evaluation and shipping: the EMA smooths over
        # the late-schedule spikes of small-batch training.
        ema = _unflat(0.999 * _flat(ema) + 0.001 * _flat(params), ema)
        return params, ema, opt_state, loss, epe

    return step


def init_params(model, seed):
    """``model``'s weights from Flax's initializers drawn from ``seed``
    (``flax_init_``), the refinement heads zero as the Flax model
    initialises them; in Flax's order."""
    flax_init_(model, seed)
    with torch.no_grad():
        for head in (model.update.delta_head, model.update.vis_head):
            head.weight.zero_()
            head.bias.zero_()
    return {k: v.clone() for k, v in flax_order(model.state_dict()).items()}


def _epe_sums(apply, video, queries, tracks, vis):
    """(error, zero-motion error, visible count) sums of one clip, and the
    visibility logits, as numpy."""
    pred, vis_logits = apply(video, queries)
    pred, tracks = pred.cpu().numpy(), tracks.cpu().numpy()
    q, v = queries.cpu().numpy(), vis.cpu().numpy()
    err = np.linalg.norm(pred - tracks, axis=-1)
    zero = np.linalg.norm(tracks - q[None], axis=-1)
    return (float((err * v).sum()), float((zero * v).sum()),
            float(v.sum()), vis_logits.cpu().numpy(), v)


def main(steps: int = 500, t: int = 8, h: int = 96, w: int = 96,
         n_points: int = 24, batch: int = 2, seed: int = 0,
         log_every: int = 25, eval_videos: int = 8, augment: int = 1,
         lr_micro: int = 50, wide_motion: int = 1, save: int = 1,
         real_pct: int = 0, pool_size: int = 120, feature_dim: int = 64,
         model_dim: int = 128, depth: int = 2, iterations: int = 4,
         time_enc: int = 0, device="cuda"):
    """``real_pct`` mixes REAL video samples with KLT-verified
    pseudo-label tracks into the pool; capacity knobs (feature_dim /
    model_dim / depth / iterations) expose the model's scale.
    ``time_enc`` defaults OFF: with the sinusoidal time tokens the JAX
    package's training diverged at its best recipe (BASELINE.md)."""
    dev = resolve_device(device)
    os.makedirs(WEIGHTS_DIR, exist_ok=True)
    t0 = time.time()
    cfg = CoTrackerConfig(feature_dim=feature_dim, model_dim=model_dim,
                          depth=depth, iterations=iterations,
                          time_encoding=bool(time_enc))
    model = CoTracker(cfg, device=dev)
    rng = np.random.default_rng(seed)

    params = init_params(model, seed)
    # Warm-up to the peak (lr_micro, in 1e-6 units), then cosine decay to
    # 1e-6: without warm-up the first Adam steps threw the zero-init delta
    # heads into a basin they never left.
    warmup = min(max(steps // 6, 50), max(steps // 2, 1))
    tx = ClipAdamW(warmup_cosine_schedule(lr_micro * 1e-6, warmup, steps,
                                          init_value=0.0, end_value=1e-6),
                   weight_decay=1e-4, clip_norm=1.0)
    opt_state = tx.init(params)
    step = make_train_step(model, tx)

    pool = make_pool(rng, min(steps, pool_size), batch, t, h, w, n_points,
                     augment=bool(augment), wide_motion=bool(wide_motion),
                     real_frac=real_pct / 100.0, device=dev)
    ema = params
    for it in range(steps):
        video, queries, tracks, vis = pool[it % len(pool)]
        params, ema, opt_state, loss, epe = step(params, ema, opt_state,
                                                 video, queries, tracks,
                                                 vis)
        if it % log_every == 0 or it == steps - 1:
            print(f"[cotracker] step {it}: loss={float(loss):.3f} "
                  f"epe={float(epe):.3f}", flush=True)
    # Evaluate/ship the EMA parameters.
    params = ema

    def apply(video, queries):
        return functional_call(model, params, (video, queries))

    # Held-out evaluation (fresh rng stream, no photometric augmentation
    # so the metric reflects geometry, not appearance jitter).
    eval_rng = np.random.default_rng(seed + 1000)
    epool = make_pool(eval_rng, eval_videos, 1, t, h, w, n_points,
                      augment=False, device=dev)
    tot_err = tot_zero = tot_vis = 0.0
    vis_correct = vis_count = 0.0
    for video, queries, tracks, vis in epool:
        e, z, n, logits, v = _epe_sums(apply, video[0], queries[0],
                                       tracks[0], vis[0])
        tot_err += e
        tot_zero += z
        tot_vis += n
        vis_correct += float(((logits > 0) == (v > 0.5)).sum())
        vis_count += v.size
    agg = {
        "epe": round(tot_err / max(tot_vis, 1.0), 4),
        "zero_motion_epe": round(tot_zero / max(tot_vis, 1.0), 4),
        "vis_accuracy": round(vis_correct / max(vis_count, 1.0), 4),
        "videos": eval_videos,
        "frames": t,
        "points": n_points,
        "resolution": f"{w}x{h}",
        "iterations": cfg.iterations,
        "train_steps": steps,
        "lr_peak": lr_micro * 1e-6,
        "batch": batch,
        "wide_motion_train": bool(wide_motion),
        "all_iteration_loss": True,
        "real_video_pct": real_pct,
        "pool_size": pool_size,
        "config": {"feature_dim": cfg.feature_dim,
                   "model_dim": cfg.model_dim, "depth": cfg.depth,
                   "iterations": cfg.iterations,
                   "time_encoding": cfg.time_encoding},
        "wall_s": round(time.time() - t0, 1),
    }
    # Real-video held-out probe (fresh rng; crops of the SAME sequence —
    # report-only, the synthetic held-out EPE is the gate).
    real_rng = np.random.default_rng(seed + 2000)
    r_err = r_zero = r_vis = 0.0
    for _ in range(eval_videos):
        s = real_video_sample(real_rng, t, h, w, n_points, augment=False)
        if s is None:
            break
        e, z, n, _, _ = _epe_sums(apply, *(torch.from_numpy(a).to(dev)
                                           for a in s))
        r_err += e
        r_zero += z
        r_vis += n
    if r_vis > 0:
        agg["real_epe"] = round(r_err / r_vis, 4)
        agg["real_zero_motion_epe"] = round(r_zero / r_vis, 4)
    print("[cotracker] real-video probe:",
          json.dumps({k: agg.get(k) for k in
                      ("real_epe", "real_zero_motion_epe")}), flush=True)
    print("[cotracker] held-out:", json.dumps(agg), flush=True)

    # Gated ship: never overwrite weights with a run that regressed the
    # held-out EPE.
    mpath = os.path.join(WEIGHTS_DIR, "metrics.json")
    metrics_all = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            metrics_all = json.load(f)
    prev = metrics_all.get("cotracker", {}).get("epe")
    if save and (prev is None or agg["epe"] < prev):
        save_pytree(os.path.join(WEIGHTS_DIR, "cotracker.npz"),
                    flax_variables_from_state(params, cfg.num_heads))
        metrics_all["cotracker"] = agg
        with open(mpath, "w") as f:
            json.dump(metrics_all, f, indent=2)
        print(f"[cotracker] shipped (epe {agg['epe']} < prev {prev})",
              flush=True)
    elif save:
        print(f"[cotracker] gate-rejected (epe {agg['epe']} >= prev "
              f"{prev}); weights unchanged", flush=True)
    return agg


if __name__ == "__main__":
    import sys
    kw = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = v if k == "device" else int(v)
    main(**kw)
