"""Sharded front ends for the sparse trackers and the direct method.

The sparse KLT trackers are embarrassingly parallel per feature: the
feature axis is split over the mesh's ranks and the images replicated;
every rank tracks its slice (one kernel launch on the card) and one
all-gather rebuilds the whole. The direct method is a reduction of
per-feature 6x6 systems into one pose: features are split, and the H / b
sums are all-reduced each Gauss-Newton iteration, so every rank solves the
same system.

Both wrappers pad the feature count to a multiple of the mesh size; padded
lanes carry a failed status / zero depth so they are inert, and outputs
are cut back to the original length.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.parallel.mesh import (
    _all_gather,
    _all_reduce,
    _shard_index,
    pad_to_multiple,
)


def shard_features(mesh, *arrays, pad_value=0.0):
    """Pad leading dims to a multiple of the mesh size and keep this rank's
    contiguous slice, on the mesh's device (slices are rank-major in the
    mesh's flattened order; dtypes are kept). Returns (padded_n,
    local_slices...)."""
    n = arrays[0].shape[0]
    m = mesh.size()
    n_pad = pad_to_multiple(n, m)
    local = n_pad // m
    start = _shard_index(mesh) * local
    dev = torch.device(mesh.device_type)
    out = []
    for a in arrays:
        a = torch.as_tensor(a, device=dev)
        pad = a.new_full((n_pad - n, *a.shape[1:]), pad_value)
        out.append(torch.cat([a, pad])[start:start + local].contiguous())
    return (n_pad, *out)


def _gather_features(mesh, tensor, n):
    """The whole feature axis from every rank's slice, cut to ``n``."""
    return _all_gather(mesh, tensor)[:n]


def track_klt_sharded(tracker, mesh, ref_pyramid, cur_pyramid, ref_uv,
                      cur_uv=None, status=None):
    """Track features sharded over the mesh; returns (cur_uv, status) of
    the original length, on every rank.

    Each rank runs the WHOLE tracker (on the card, one kernel launch) on
    its slice with the full pyramids. The global ``max_track_points`` cap
    is applied after the gather: inside, every local lane is tracked
    (local index order is not global order), and capped lanes are restored
    to their inputs afterwards, as the single-process tracker leaves
    them."""
    if torch.device(mesh.device_type).type != tracker.device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run a tracker "
                         f"on {tracker.device}")
    ref_uv, cur_uv, status = tracker._prep(ref_uv, cur_uv, status)
    n = ref_uv.shape[0]
    # Padded lanes are marked failed so the tracker skips them.
    n_pad, s_ref, s_cur = shard_features(mesh, ref_uv, cur_uv)
    _, s_status = shard_features(mesh, status,
                                 pad_value=int(TrackStatus.OUTSIDE))
    local = copy.copy(tracker)
    local.options = dataclasses.replace(tracker.options,
                                        max_track_points=s_ref.shape[0])
    out_uv, out_status = local.track(ref_pyramid, cur_pyramid, s_ref, s_cur,
                                     s_status)
    # One gather for both: statuses are small integers, exact in float32.
    both = _gather_features(
        mesh, torch.cat([out_uv, out_status[:, None].float()], 1), n)
    capped = torch.arange(n, device=ref_uv.device) >= \
        tracker.options.max_track_points
    out_uv = torch.where(capped[:, None], cur_uv, both[:, :2])
    out_status = torch.where(capped, status, both[:, 2].to(torch.int8))
    return out_uv, out_status


def track_direct_sharded(solver, mesh, ref_pyramid, cur_pyramid, k4,
                         p_c_in_ref, ref_uv, q_rc=None, p_rc=None):
    """Direct-method pose tracking with features sharded over the mesh.

    The per-feature H_i/b_i terms live on the feature slices; their float64
    sums are all-reduced every Gauss-Newton iteration (FAST's frozen H once
    per level), so every rank takes the same steps. Returns (cur_uv, q_rc,
    p_rc, status) of the original length, on every rank."""
    f32 = solver._f32
    ref_uv = f32(ref_uv)
    n = ref_uv.shape[0]
    # Zero depth marks padded lanes invalid (the solver skips features
    # with non-positive depth).
    _, s_p, s_uv = shard_features(mesh, f32(p_c_in_ref), ref_uv)

    def reduce(*sums):
        packed = _all_reduce(mesh, torch.cat([s.reshape(-1) for s in sums]))
        return tuple(part.reshape(s.shape) for part, s in zip(
            packed.split([s.numel() for s in sums]), sums))

    cur_uv, q, p, status = solver._track(
        ref_pyramid, cur_pyramid, k4, s_p, s_uv, q_rc, p_rc, None, None,
        reduce, _shard_index(mesh) * s_uv.shape[0])
    both = _gather_features(
        mesh, torch.cat([cur_uv, status[:, None].float()], 1), n)
    return both[:, :2].contiguous(), q, p, both[:, 2].to(torch.int8)
