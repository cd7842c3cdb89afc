"""Descriptor matching: all-pairs and spatially gated nearest neighbour.

The JAX package's semantics, case for case:
 - ``force_match``: per ref descriptor, the argmin over all cur descriptors
   with a distance strictly below the threshold; ties go to the lowest
   index.
 - ``nearby_match``: candidates gated to |dx| <= max_col_distance and
   |dy| <= max_row_distance around the predicted position. An exact
   0-distance candidate wins as soon as it is the first minimum, which is
   what the reference's early exit on a 0 distance gives.
 - ``fill_matched_pixels``: index pairs to matched pixels and TRACKED /
   LARGE_RESIDUAL statuses, skipping entries that already failed.
 - The default distance threshold is 0, so callers must set one.

The distance matrices are one float32 matrix product each (Hamming by
|a| + |b| - 2 a.b on 0/1 vectors, exact in float32, TF32 or not; cosine on
normalised rows, with TF32 off) plus a masked argmin. Functions run on the
device of their first tensor argument; numpy inputs are accepted.
"""

from __future__ import annotations

import dataclasses

import torch

from feature_tracker_tpu_torch.core.status import TrackStatus, is_failed
from feature_tracker_tpu_torch.models.raft import full_float32


@dataclasses.dataclass(frozen=True)
class MatcherOptions:
    """Defaults of the reference's DescriptorMatcher::Options."""

    max_valid_predict_row_distance: int = 40
    max_valid_predict_col_distance: int = 40
    max_valid_descriptor_distance: float = 0.0


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def hamming_distance_matrix(bits_ref, bits_cur):
    """Hamming distances ``[N, M]`` float32 between 0/1 bit matrices
    ``[N, L]`` and ``[M, L]``: |a| + |b| - 2 a.b, exact for L <= 2^23."""
    a = _f32(bits_ref)
    b = _f32(bits_cur, a.device)
    cross = a @ b.T
    na = a.sum(-1, keepdim=True)
    nb = b.sum(-1, keepdim=True)
    return na + nb.T - 2.0 * cross


def cosine_distance_matrix(desc_ref, desc_cur, eps: float = 1e-12):
    """0.5 - 0.5 cos distance ``[N, M]`` of descriptor rows (the
    SuperPoint / DISK demos' distance)."""
    desc_ref = _f32(desc_ref)
    desc_cur = _f32(desc_cur, desc_ref.device)
    a = desc_ref / desc_ref.norm(dim=-1, keepdim=True).clamp_min(eps)
    b = desc_cur / desc_cur.norm(dim=-1, keepdim=True).clamp_min(eps)
    with full_float32():
        return 0.5 - 0.5 * (a @ b.T)


def _masked_argmin(dist, accept):
    """Per row, the first index of the least accepted distance; -1 where a
    row accepts nothing."""
    masked = torch.where(accept, dist, torch.inf)
    if masked.shape[1] == 0:
        return torch.full(masked.shape[:1], -1, dtype=torch.int32,
                          device=masked.device)
    j = torch.argmin(masked, dim=1)        # the first minimum, as jnp.argmin
    ok = masked.gather(1, j[:, None])[:, 0] < torch.inf
    return torch.where(ok, j, -1).to(torch.int32)


def force_match(dist, max_valid_distance):
    """All-pairs nearest-neighbour match. Returns ``[N]`` int32 cur
    indices (-1 = none)."""
    dist = _f32(dist)
    return _masked_argmin(dist, dist < max_valid_distance)


def nearby_match(dist, pred_uv_in_cur, cur_uv, max_valid_distance,
                 max_col_distance, max_row_distance):
    """Spatially gated nearest-neighbour match.

    Args:
      dist: ``[N, M]`` descriptor distances.
      pred_uv_in_cur: ``[N, 2]`` predicted positions of the ref features.
      cur_uv: ``[M, 2]`` candidate positions.

    Returns ``[N]`` int32 cur indices (-1 = none)."""
    dist = _f32(dist)
    pred = _f32(pred_uv_in_cur, dist.device)
    cur = _f32(cur_uv, dist.device)
    dxy = (pred[:, None, :] - cur[None, :, :]).abs()
    gate = (dxy[..., 0] <= max_col_distance) & (dxy[..., 1] <= max_row_distance)
    return _masked_argmin(dist, gate & (dist < max_valid_distance))


def fill_matched_pixels(index_pairs, cur_uv, status=None):
    """Index pairs -> (matched_uv ``[N, 2]`` float32, status ``[N]``
    int8).

    Entries that already failed (> TRACKED) keep their status and get a
    zero pixel."""
    index_pairs = torch.as_tensor(index_pairs)
    dev = index_pairs.device
    cur_uv = _f32(cur_uv, dev)
    n = index_pairs.shape[0]
    if status is None:
        status = torch.full((n,), int(TrackStatus.NOT_TRACKED),
                            dtype=torch.int8, device=dev)
    else:
        status = torch.as_tensor(status, device=dev).to(torch.int8)
    skip = is_failed(status)
    found = index_pairs >= 0
    safe_idx = index_pairs.clamp(0, cur_uv.shape[0] - 1).to(torch.int64)
    matched = torch.where(found[:, None], cur_uv[safe_idx], 0.0)
    new_status = torch.where(found, int(TrackStatus.TRACKED),
                             int(TrackStatus.LARGE_RESIDUAL)).to(torch.int8)
    return (torch.where(skip[:, None], 0.0, matched),
            torch.where(skip, status, new_status))
