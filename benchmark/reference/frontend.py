"""Plain reference of the persistent KLT front end, in plain torch and numpy.

A frozen copy of the semantics of the port's front end
(``pipeline.py::TrackingFrontEnd.process_frame``): Shi-Tomasi detection with
exact greedy minimum-distance suppression, the floor-quantised 2x2-mean
pyramid, pyramidal translation-only KLT in FAST mode (the JAX package's
``_fast_one``: one constant-weight reference patch, up to ``max_iterations``
Gauss-Newton steps per level with the divergence counter), the final outside
check and the front end's bookkeeping (dead lanes, persistent ids,
replenishment below ``min_live_tracks``, suppression around surviving
tracks). It imports nothing of the port.

``dtype`` is the precision of the patch arithmetic and of the corner
response; positions and the 2x2 solves stay float32. ``float32`` is the
reference; ``bfloat16`` is the control that the comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NOT_TRACKED, TRACKED, LARGE_RESIDUAL, OUTSIDE, NUMERIC_ERROR = 0, 1, 2, 3, 4


# -- detection ---------------------------------------------------------------

def _box(a, half):
    k = 2 * half + 1
    h, w = a.shape
    p = F.pad(a, (half, half, half, half))
    rows = p[:, 0:w]
    for d in range(1, k):
        rows = rows + p[:, d:d + w]
    win = rows[0:h]
    for d in range(1, k):
        win = win + rows[d:d + h]
    return win / float(k * k)


def corner_response(img, half, dtype=torch.float32):
    """Minimum eigenvalue of the box-filtered structure tensor of central
    differences (zero at the image's outer rows and columns)."""
    img = img.to(dtype)
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    ixx, iyy, ixy = (_box(a, half) for a in (dx * dx, dy * dy, dx * dy))
    d = torch.sqrt((ixx - iyy) * (ixx - iyy) + 4.0 * ixy * ixy)
    return (0.5 * (ixx + iyy - d)).float()


def _ranked(img, harris, dtype):
    """Candidates ``(cx, cy)`` float32 numpy: 3x3 local maxima of the
    response above the threshold and off the border, in descending response
    order (ties to the lower flat index), at most ``max_candidates``."""
    half = harris["window_half_size"]
    h, w = img.shape
    resp = corner_response(img, half, dtype)
    border = half + 2
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    inside = ((rows >= border) & (rows < h - border)
              & (cols >= border) & (cols < w - border))
    local_max = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
    cand = (resp >= local_max) & (resp > harris["min_valid_response"]) \
        & inside
    scores = torch.where(cand, resp, torch.full_like(resp, -torch.inf))
    flat = scores.reshape(-1).cpu().numpy()
    order = np.argsort(-flat, kind="stable")[:min(harris["max_candidates"],
                                                   h * w)]
    order = order[np.isfinite(flat[order])]
    return (order % w).astype(np.float32), (order // w).astype(np.float32)


def candidates(img, harris):
    """How many candidates the greedy suppression ranks in ``img``."""
    return len(_ranked(img.float(), harris, torch.float32)[0])


def detect(img, max_num, harris, dtype=torch.float32):
    """Up to ``max_num`` corners ``[n, 2]`` (x, y) float32 numpy, in
    descending response order after exact greedy suppression."""
    cx, cy = _ranked(img, harris, dtype)
    min_d2 = float(harris["min_feature_distance"]) ** 2
    kept_x, kept_y = [], []
    for x, y in zip(cx, cy):             # exact greedy, in score order
        if kept_x:
            kx = np.asarray(kept_x, np.float32)
            ky = np.asarray(kept_y, np.float32)
            if np.any((kx - x) ** 2 + (ky - y) ** 2 < min_d2):
                continue
        kept_x.append(x)
        kept_y.append(y)
    return np.stack([np.asarray(kept_x, np.float32),
                     np.asarray(kept_y, np.float32)], -1)[:max_num].reshape(
                         -1, 2)


# -- pyramid -----------------------------------------------------------------

def pyramid(img, levels):
    """Floor-quantised 2x2-mean pyramid, finest first (float32)."""
    pyr = [torch.floor(img)]
    for _ in range(levels - 1):
        a = pyr[-1]
        h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
        pyr.append(torch.floor((a[0:h2:2, 0:w2:2] + a[1:h2:2, 0:w2:2]
                                + a[0:h2:2, 1:w2:2] + a[1:h2:2, 1:w2:2])
                               * 0.25))
    return pyr


# -- KLT, FAST mode ----------------------------------------------------------

def _anchor_and_weights(uv):
    x, y = uv[:, 0], uv[:, 1]
    r0, c0 = torch.floor(y), torch.floor(x)
    fr, fc = y - r0, x - c0
    lim = float(1 << 30)
    return (r0.clamp(-lim, lim).long(), c0.clamp(-lim, lim).long(),
            ((1 - fr) * (1 - fc), (1 - fr) * fc, fr * (1 - fc), fr * fc))


def _patch(padded, pad, shape, r_min, c_min, rows, cols, weights, dtype):
    """Constant-weight bilinear patch ``[N, rows, cols]`` at integer corners
    ``(r_min, c_min)`` and its tap validity (anchor inside [0, dim-2])."""
    h, w = shape
    hp, wp = padded.shape
    dev = padded.device
    win = max(rows, cols) + 1
    r = (r_min + pad).clamp(0, hp - win)
    c = (c_min + pad).clamp(0, wp - win)
    offs = torch.arange(win, device=dev)
    block = padded[(r[:, None] + offs)[:, :, None],
                   (c[:, None] + offs)[:, None, :]].to(dtype)
    wt = [v.to(dtype)[:, None, None] for v in weights]
    patch = (wt[0] * block[:, :rows, :cols]
             + wt[1] * block[:, :rows, 1:cols + 1]
             + wt[2] * block[:, 1:rows + 1, :cols]
             + wt[3] * block[:, 1:rows + 1, 1:cols + 1])
    rr = r_min[:, None, None] + torch.arange(rows, device=dev)[:, None]
    cc = c_min[:, None, None] + torch.arange(cols, device=dev)[None, :]
    valid = (rr >= 0) & (rr <= h - 2) & (cc >= 0) & (cc <= w - 2)
    return patch, valid


def _track_level(klt, ref_img, cur_img, ref_uv, cur_uv, dtype):
    """FAST mode at one level for all features: ``(uv, status, steps)``."""
    pr = 2 * klt["patch_row_half_size"] + 1
    pc = 2 * klt["patch_col_half_size"] + 1
    epr, epc = pr + 2, pc + 2
    pad = max(epr, epc) + 3
    shape = tuple(ref_img.shape)
    ref_pad = F.pad(ref_img, (pad, pad, pad, pad))
    cur_pad = F.pad(cur_img, (pad, pad, pad, pad))
    n = ref_uv.shape[0]
    dev = ref_uv.device
    zero = torch.zeros((), dtype=dtype, device=dev)

    r0, c0, wts = _anchor_and_weights(ref_uv)
    ex, ex_valid = _patch(ref_pad, pad, shape, r0 - epr // 2, c0 - epc // 2,
                          epr, epc, wts, dtype)
    ex = torch.where(ex_valid, ex, zero)
    gvalid = (ex_valid[:, 1:-1, :-2] & ex_valid[:, 1:-1, 2:]
              & ex_valid[:, :-2, 1:-1] & ex_valid[:, 2:, 1:-1])
    gx = torch.where(gvalid, ex[:, 1:-1, 2:] - ex[:, 1:-1, :-2], zero)
    gy = torch.where(gvalid, ex[:, 2:, 1:-1] - ex[:, :-2, 1:-1], zero)
    h00 = (gx * gx).sum(dim=(1, 2)).float()
    h01 = (gx * gy).sum(dim=(1, 2)).float()
    h11 = (gy * gy).sum(dim=(1, 2)).float()
    inner, inner_valid = ex[:, 1:-1, 1:-1], ex_valid[:, 1:-1, 1:-1]

    no_pixels = ex_valid.sum(dim=(1, 2)) == 0
    status = torch.where(no_pixels, OUTSIDE, LARGE_RESIDUAL).to(torch.int8)
    done = no_pixels.clone()
    uv = cur_uv
    last_sq = torch.full((n,), torch.inf, device=dev)
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    for _ in range(klt["max_iterations"]):
        if bool(done.all()):
            break
        steps += (~done).int()
        cr0, cc0, cw = _anchor_and_weights(uv)
        cur, cvalid = _patch(cur_pad, pad, shape, cr0 - pr // 2,
                             cc0 - pc // 2, pr, pc, cw, dtype)
        valid = cvalid & inner_valid
        dt = torch.where(valid, cur - inner, zero)
        b0 = -(gx * dt).sum(dim=(1, 2)).float()
        b1 = -(gy * dt).sum(dim=(1, 2)).float()
        det = h00 * h11 - h01 * h01
        v = torch.stack([(h11 * b0 - h01 * b1) / det,
                         (h00 * b1 - h01 * b0) / det], -1)
        no_valid = valid.sum(dim=(1, 2)) == 0
        isnan = torch.isnan(v).any(-1)
        sq = (v * v).sum(-1)
        update = ~(done | no_valid | isnan)
        uv = torch.where(update[:, None], uv + v, uv)
        shrink = sq < last_sq
        last_sq = torch.where(update, torch.where(shrink, sq, last_sq),
                              last_sq)
        count = torch.where(update, torch.where(shrink, 0, count + 1), count)
        diverged = update & (count >= klt["max_tolerance_large_step"])
        converged = update & (sq < klt["max_converge_step"]) & ~diverged
        new = torch.where(isnan & ~(done | no_valid), NUMERIC_ERROR,
                          torch.where(converged, TRACKED, status))
        status = torch.where(done, status, new.to(torch.int8))
        done = done | no_valid | isnan | diverged | converged
    return uv, status, steps


def track(klt, ref_pyr, cur_pyr, uv, skip, dtype=torch.float32):
    """Coarse-to-fine FAST tracking of ``uv [N, 2]`` from the previous
    pyramid into the current one; ``skip`` lanes pass through with their
    input. Returns ``(uv, status, steps)``; status after the final outside
    check (statuses of skipped lanes are the caller's)."""
    levels = len(ref_pyr)
    scale = float(1 << (levels - 1))
    s_ref, s_cur = uv / scale, uv / scale
    steps = torch.zeros(uv.shape[0], dtype=torch.int32, device=uv.device)
    for lvl in range(levels - 1, -1, -1):
        s_cur, status, lvl_steps = _track_level(
            klt, ref_pyr[lvl], cur_pyr[lvl], s_ref, s_cur, dtype)
        steps += lvl_steps
        if lvl > 0:
            s_ref, s_cur = s_ref * 2.0, s_cur * 2.0
    h, w = cur_pyr[0].shape
    out = ((s_cur[:, 0] < 0) | (s_cur[:, 0] > w - 1) | (s_cur[:, 1] < 0)
           | (s_cur[:, 1] > h - 1))
    status = torch.where(out, OUTSIDE, status).to(torch.int8)
    s_cur = torch.where(skip[:, None], uv, s_cur)
    return s_cur, status, torch.where(skip, 0, steps)


# -- the front end's bookkeeping -------------------------------------------

class FrontEndState:
    """The front end's host state between frames: positions, ids, dead
    lanes and the next id to hand out."""

    def __init__(self, capacity, uv=None, ids=None, next_id=0):
        self.uv = (np.zeros((capacity, 2), np.float32) if uv is None
                   else np.array(uv, np.float32))
        self.ids = (np.full((capacity,), -1, np.int64) if ids is None
                    else np.array(ids, np.int64))
        self.dead = self.ids < 0
        self.next_id = int(next_id)


def replenish(cfg, state, img, dtype=torch.float32):
    cand = detect(img, cfg["capacity"], cfg["harris"], dtype)
    if cand.size == 0:
        return
    live = state.uv[~state.dead]
    if live.size:
        d2 = ((cand[:, None, :] - live[None, :, :]) ** 2).sum(-1)
        cand = cand[d2.min(axis=1) > cfg["replenish_suppression"] ** 2]
    free = np.nonzero(state.dead)[0]
    take = min(len(free), len(cand))
    slots = free[:take]
    state.uv[slots] = cand[:take]
    state.ids[slots] = np.arange(state.next_id, state.next_id + take)
    state.next_id += take
    state.dead[slots] = False


def frame(cfg, state, prev_img, img, dtype=torch.float32):
    """One frame of the front end: ``state`` (updated in place) after
    ``img`` given the previous frame ``prev_img`` (None for the first).
    Returns ``(uv, status, ids, num_live, steps)``; ``steps`` is the
    Gauss-Newton steps of the tracking (0 on a first frame)."""
    img = img.float()
    steps = 0
    if prev_img is None:
        replenish(cfg, state, img, dtype)
        status = np.where(state.dead, np.int8(NOT_TRACKED), np.int8(TRACKED))
    else:
        levels = cfg["pyramid_levels"]
        ref_pyr, cur_pyr = pyramid(prev_img.float(), levels), pyramid(
            img, levels)
        dev = img.device
        dead = torch.as_tensor(state.dead, device=dev)
        lanes = torch.arange(len(state.dead), device=dev)
        skip = dead | (lanes >= cfg["klt"]["max_track_points"])
        uv_in = torch.as_tensor(state.uv, device=dev)
        uv, st, st_steps = track(cfg["klt"], ref_pyr, cur_pyr, uv_in, skip,
                                 dtype)
        status_in = torch.where(dead, OUTSIDE, NOT_TRACKED).to(torch.int8)
        st = torch.where(skip, status_in, st)
        status = st.cpu().numpy()
        steps = int(st_steps.sum())
        state.uv = uv.cpu().numpy().copy()
        state.dead |= status != TRACKED
        state.ids[state.dead] = -1
        if (~state.dead).sum() < cfg["min_live_tracks"]:
            was_dead = state.dead.copy()
            replenish(cfg, state, img, dtype)
            status = np.where(was_dead & ~state.dead, np.int8(TRACKED),
                              status)
    return (state.uv.copy(), status, state.ids.copy(),
            int((~state.dead).sum()), steps)
