"""Shi-Tomasi / Harris corner detection.

Pipeline (the JAX package's, step for step):
  1. central-difference gradients, structure tensor box-filtered over a
     (2w+1)^2 window (SAME zero padding, mean over k^2),
  2. Shi-Tomasi response = min eigenvalue of the structure tensor,
  3. 3x3 local-max NMS + response threshold,
  4. top-K candidates by response, ties broken by the lower flat index
     (``jax.lax.top_k``'s order; a stable descending sort gives it),
  5. exact greedy radius suppression in score order: on the card one
     launch of ``csrc/detect_suppress.cu`` (``ops/cuda_detect.py``), with
     no read of the device; on the CPU :func:`suppress_candidates`.

The output has a fixed size: ``max_num`` slots padded with (-1, -1), plus
a count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from feature_tracker_tpu_torch.core.config import HarrisOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.utils.profiling import count, host_value, span


def _box_filter(a: torch.Tensor, half: int) -> torch.Tensor:
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


def shi_tomasi_response(img: torch.Tensor, window_half_size: int = 1):
    """Min-eigenvalue corner response map ``[H, W]``."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    ixx = _box_filter(dx * dx, window_half_size)
    iyy = _box_filter(dy * dy, window_half_size)
    ixy = _box_filter(dx * dy, window_half_size)
    tr = ixx + iyy
    d = torch.sqrt((ixx - iyy) * (ixx - iyy) + 4.0 * ixy * ixy)
    return 0.5 * (tr - d)


def _chaotic_greedy(valid: torch.Tensor, higher_f: torch.Tensor):
    """Chaotic iteration of the greedy recurrence: a candidate is decided
    once every higher-ranked conflicting candidate is decided, so whole
    independent groups resolve per round. Invalid candidates start
    decided (never kept), so rounds = depth of the chains among valid
    ones. The counts come from a float32 matmul of 0/1 values: exact
    integers, TF32 or not. Each round's test waits for the device."""
    decided = ~valid
    keep = torch.zeros_like(valid)
    while not host_value(decided.all()):
        count("detect.suppression_rounds")
        rhs = torch.stack([keep.to(higher_f.dtype),
                           (~decided).to(higher_f.dtype)], dim=-1)
        counts = higher_f @ rhs
        blocked = counts[:, 0] > 0.0
        ready = counts[:, 1] == 0.0
        keep = torch.where(decided, keep, valid & ~blocked & ready)
        decided = decided | ready
    return keep


def greedy_suppression(valid: torch.Tensor, conflict: torch.Tensor,
                       chunk: int = 512) -> torch.Tensor:
    """Exact greedy radius suppression in rank order.

    Equivalent to the sequential scan ``keep[i] = valid[i] and no kept
    j < i conflicts with i``. Candidates go in score-ordered chunks:
    suppression from decided chunks is one masked matvec, and each chunk
    resolves internally by chaotic iteration.

    Args:
      valid: ``[K]`` bool, candidates in descending score order.
      conflict: ``[K, K]`` bool symmetric conflict matrix (self included).
    """
    k = valid.shape[0]
    chunk = max(1, min(chunk, k))
    keep = torch.zeros_like(valid)
    for c0 in range(0, k, chunk):
        c1 = min(c0 + chunk, k)
        block = conflict[c0:c1]
        sub_valid = valid[c0:c1]
        if c0 > 0:
            prev = block[:, :c0].to(torch.float32)
            sub_valid = sub_valid & (prev @ keep[:c0].to(torch.float32) == 0.0)
        n = c1 - c0
        tri = torch.ones(n, n, dtype=torch.bool,
                         device=valid.device).tril(diagonal=-1)
        higher = (block[:, c0:c1] & tri).to(torch.float32)
        keep[c0:c1] = _chaotic_greedy(sub_valid, higher)
    return keep


def detect_good_features(img, max_num: int,
                         opts: HarrisOptions = HarrisOptions(),
                         device="cuda"):
    """Detect up to ``max_num`` corners with min-distance suppression.

    Args:
      img: ``[H, W]`` image (0..255 gray values), numpy or tensor.
      max_num: maximum number of returned features.
      opts: detection options.
      device: where detection runs.

    Returns:
      (uv ``[max_num, 2]`` float32 (x, y), padded entries (-1, -1);
       num: int32 0-dim tensor, the count of valid features).
    """
    with span("detect.features"):
        return _detect(img, max_num, opts, device)


def _detect(img, max_num: int, opts: HarrisOptions, device):
    dev = resolve_device(device)
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    top_scores, flat_idx = ranked_candidates(img, opts)
    # Imported here: ops/cuda_detect.py imports this module.
    from feature_tracker_tpu_torch.ops.cuda_detect import (
        suppress_candidates_cuda,
    )

    return suppress_candidates_cuda(top_scores, flat_idx, tuple(img.shape),
                                    max_num, opts.min_feature_distance)


def ranked_candidates(img: torch.Tensor, opts: HarrisOptions):
    """Steps 1-4 on a float32 ``[H, W]`` image: the Shi-Tomasi response
    ranked by :func:`ranked_scores`, with a border that gives every
    detected feature full bilinear support."""
    resp = shi_tomasi_response(img, opts.window_half_size)
    return ranked_scores(resp, opts.min_valid_response,
                         opts.window_half_size + 2, opts.max_candidates)


def ranked_scores(score: torch.Tensor, min_response, border: int,
                  max_candidates: int):
    """Steps 3-4 on a float32 score map ``[H, W]`` (a corner response, a
    keypoint heatmap): the scores of the top ``k = min(max_candidates,
    H*W)`` pixels in descending order, ties to the lower flat index, -inf
    where a pixel is no candidate (not a 3x3 maximum, not above
    ``min_response``, or within ``border`` pixels of an edge; so the valid
    ones are a prefix), and their flat indices (int64)."""
    dev = score.device
    h, w = score.shape
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    in_border = ((rows >= border) & (rows < h - border)
                 & (cols >= border) & (cols < w - border))

    # 3x3 local maxima (max_pool2d pads with -inf, as reduce_window does).
    local_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    cand = (score >= local_max) & (score > min_response) & in_border
    scores = torch.where(cand, score, torch.full_like(score, -torch.inf))

    k = min(max_candidates, h * w)
    top_scores, flat_idx = torch.sort(scores.reshape(-1), descending=True,
                                      stable=True)
    return top_scores[:k], flat_idx[:k]


def suppress_candidates(top_scores: torch.Tensor, flat_idx: torch.Tensor,
                        shape, max_num: int, min_feature_distance):
    """Step 5, the plain version: exact greedy radius suppression of the
    ranked candidates of :func:`ranked_candidates` on an image of
    ``shape`` ``(H, W)``, through :func:`greedy_suppression`. Returns
    ``(uv, num)`` as :func:`detect_good_features` does. Its round tests and
    selection read the device."""
    dev = top_scores.device
    w = shape[1]
    # Valid candidates form a prefix (invalid ones score -inf); the greedy
    # pass only needs that prefix.
    n_valid = host_value((top_scores > -torch.inf).sum())
    cy = (flat_idx[:n_valid] // w).to(torch.float32)
    cx = (flat_idx[:n_valid] % w).to(torch.float32)

    # Greedy min-distance suppression in descending score order.
    d2 = ((cx[:, None] - cx[None, :]) ** 2 + (cy[:, None] - cy[None, :]) ** 2)
    min_d2 = float(min_feature_distance) ** 2
    conflict = d2 < min_d2  # includes self
    keep = greedy_suppression(
        torch.ones(n_valid, dtype=torch.bool, device=dev), conflict)

    sel = torch.nonzero(keep).reshape(-1)[:max_num]     # waits for its size
    count("host_syncs")
    uv = torch.full((max_num, 2), -1.0, dtype=torch.float32, device=dev)
    uv[:sel.shape[0], 0] = cx[sel]
    uv[:sel.shape[0], 1] = cy[sel]
    num = torch.tensor(sel.shape[0], dtype=torch.int32, device=dev)
    return uv, num
