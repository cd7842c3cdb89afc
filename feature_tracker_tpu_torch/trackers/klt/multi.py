"""Multi-pair tracking: K independent frame pairs in one tracker call.

The multi-camera / multi-sequence front-end shape: the K pairs' pyramids
are stacked vertically into one composite pyramid per side, with a zero
gap band after each pair (halved per level, so per-pair row offsets stay
exact integers at every level); each pair's features are offset into its
band, and the whole composite tracks as one call (one kernel launch for
the basic tracker on a CUDA device), amortising per-call overhead across
the pairs.

Semantics caveat (a documented deviation, shared with the JAX package): a
feature whose patch reaches its band edge at any pyramid level samples the
zero gap instead of getting the per-pair border masking; exact parity with
per-pair calls holds for features at least
``(patch_half + 2) * 2^(levels-1)`` px inside their image. ``track_pairs``
checks that the gap at the coarsest level still covers one extended patch,
so a neighbour pair's pixels can never leak into a patch (only gap zeros
can): ``gap >= (ex_patch + 1) * 2^(levels-1)``, i.e. 64 at 3 levels and
128 at 4 levels for the default patch.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_composite_pyramids", "track_pairs"]


def build_composite_pyramids(pyramids, gap: int = 64):
    """Stack K same-shape pyramids vertically with a zero gap band after
    each pair. Returns ``(composite levels tuple, band height at level
    0)``.

    ``gap`` must be divisible by 2^(levels-1) so per-pair offsets stay
    integral at every level."""
    levels = len(pyramids[0])
    h0, w0 = pyramids[0][0].shape
    for p in pyramids:
        if len(p) != levels or tuple(p[0].shape) != (h0, w0):
            raise ValueError("all pairs need identical pyramid shapes")
    if gap % (1 << (levels - 1)) or h0 % (1 << (levels - 1)):
        raise ValueError(f"gap ({gap}) and height ({h0}) must be "
                         f"divisible by 2^(levels-1)")
    comp = []
    for lvl in range(levels):
        first = pyramids[0][lvl]
        z = first.new_zeros((gap >> lvl, first.shape[1]))
        comp.append(torch.cat([x for p in pyramids for x in (p[lvl], z)], 0))
    return tuple(comp), h0 + gap


def track_pairs(tracker, ref_pyramids, cur_pyramids, ref_uv, cur_uv=None,
                status=None, gap: int = 64):
    """Track K pairs in one tracker call.

    Args:
      tracker: a ``BasicKlt`` (the warp trackers work too, through the same
        dispatch, sharing the composite's skip/status semantics).
      ref_pyramids / cur_pyramids: K same-shape pyramids (finest first).
      ref_uv: ``[K, N, 2]`` per-pair feature positions; ``cur_uv`` and
        ``status`` optional with the same leading shape.

    Returns ``(cur_uv [K, N, 2], status [K, N] int8)`` in per-pair
    coordinates, on the tracker's device."""
    k = len(ref_pyramids)
    if np.ndim(ref_uv) != 3 or np.shape(ref_uv)[0] != k:
        raise ValueError(f"ref_uv must be [K={k}, N, 2]")
    dev = tracker.device
    ref_uv = torch.as_tensor(ref_uv, dtype=torch.float32, device=dev)
    levels = len(ref_pyramids[0])
    ex = max(tracker.options.ex_patch_rows, tracker.options.ex_patch_cols)
    min_gap = (ex + 1) * (1 << (levels - 1))
    if gap < min_gap:
        raise ValueError(
            f"gap ({gap}) must be >= (ex_patch + 1) * 2^(levels-1) = "
            f"{min_gap} so the coarsest-level gap still covers one "
            f"extended patch (otherwise the neighbor pair's pixels leak "
            f"into border features' patches)")
    n = ref_uv.shape[1]
    # max_track_points must cover the whole composite batch (tracker
    # constructors differ across warp models, so no silent rebuild).
    if tracker.options.max_track_points < k * n:
        raise ValueError(
            f"tracker.options.max_track_points "
            f"({tracker.options.max_track_points}) must cover all "
            f"K*N = {k * n} composite features")

    def on_device(pyramids):
        return [[torch.as_tensor(l, dtype=torch.float32, device=dev)
                 for l in p] for p in pyramids]

    comp_ref, band = build_composite_pyramids(on_device(ref_pyramids), gap)
    comp_cur, _ = build_composite_pyramids(on_device(cur_pyramids), gap)
    off = torch.zeros((k, 1, 2), dtype=torch.float32, device=dev)
    off[:, 0, 1] = band * torch.arange(k, dtype=torch.float32, device=dev)
    flat = (ref_uv + off).reshape(k * n, 2)
    cur_flat = (None if cur_uv is None else
                (torch.as_tensor(cur_uv, dtype=torch.float32, device=dev)
                 + off).reshape(k * n, 2))
    st_flat = (None if status is None else
               torch.as_tensor(status, device=dev).to(torch.int8).reshape(
                   k * n))
    out_uv, out_st = tracker.track(comp_ref, comp_cur, flat, cur_flat,
                                   st_flat)
    return out_uv.reshape(k, n, 2) - off, out_st.reshape(k, n)
