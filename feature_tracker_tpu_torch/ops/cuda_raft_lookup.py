"""CUDA kernel for RAFT's windowed correlation lookup — the counterpart of
``feature_tracker_tpu/ops/pallas_raft_lookup.py``.

``csrc/raft_lookup.cu`` runs one block per tile of 8x8 neighbouring queries
and level, all in one launch: the block copies the bounding box of its
queries' windows into shared memory once and forms the dot products there;
its header states what it computes, its bound on an H100 and its design. It
is built by ``nvcc`` at first use (``ops/_build.py``) and launched through
``ops/_launch.py``. :func:`staged_share` mirrors the kernel's staging rule
on the host.

:func:`lookup_correlation_cuda` dispatches by the tensors' device: CPU
tensors take the plain PyTorch version
(``models/raft.py::lookup_correlation_otf``), CUDA tensors the kernel. A
CUDA input the kernel cannot take raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from feature_tracker_tpu_torch.ops._launch import (
    STREAM,
    Kernel,
    check,
    need_card,
    raise_on_error,
)
from feature_tracker_tpu_torch.ops.cuda_klt import MAX_LEVELS
from feature_tracker_tpu_torch.utils.profiling import counts_launches

# The one library built with fused multiply-adds (see the source's header).
LOOKUP_LIBRARY = ("ftk_raft_lookup", ("raft_lookup.cu",), True)

# The staging rule's constants, as in csrc/raft_lookup.cu.
TILE = 8                      # queries per tile side
STAGE_FLOATS = 13312          # shared memory of one stage, in floats
STAGED_RADII = (3, 4)         # radii the staged path is compiled for
MAX_CORNER = 2.0 ** 30        # |floor(location / 2^l)| beyond: no valid tap

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The kernel's padding modes, by the int it takes.
PADDINGS = {"zeros": 0, "border": 1}
# The phases csrc/raft_lookup.cu marks (clocks of each block's first
# thread), in its order.
LOOKUP_PHASES = ("queries and box", "waiting for copies and the block",
                 "starting copies", "multiply-adds", "dots and blend",
                 "per-query path")
LOOKUP = Kernel(LOOKUP_LIBRARY, "ftk_raft_lookup",
                [_VP] * 3 + [_INT] + [_VP] * 3 + [_INT] * 6
                + [_FLOAT, _VP, _VP], "raft_lookup.launch", LOOKUP_PHASES)


def correlation_scale(channels: int) -> float:
    """``1 / sqrt(C)`` as rounded in float32, the factor on fmap0."""
    return float(np.float32(1.0) / np.sqrt(np.float32(channels)))


def lookup_blocks_per_sm(radius: int = 3) -> int:
    """How many blocks of the kernel (its 16-byte path at ``radius``) one SM
    of the current card holds at once: the entry's query, given a place for
    the count; nothing is launched."""
    need_card("lookup_blocks_per_sm")
    lib = LOOKUP.load()
    one = (ctypes.c_int * 1)(1)
    ptr = (ctypes.c_void_p * 1)(0)
    blocks = ctypes.c_int(0)
    rc = lib.ftk_raft_lookup(
        ctypes.cast(ptr, _VP), ctypes.cast(one, _VP), ctypes.cast(one, _VP),
        1, 0, 0, 0, 1, 1, 1, 4, radius, 0, 1.0, 0,
        ctypes.cast(ctypes.pointer(blocks), _VP))
    raise_on_error(lib, "ftk_raft_lookup", rc)
    return blocks.value


def box_capacity(chunk: int) -> int:
    """Box pixels (rows times odd pitch) that fit a stage of shared memory
    at ``chunk`` channels, beside the tile's 64 rows of fmap0."""
    stride = chunk + 4 if chunk > 4 else 4
    return STAGE_FLOATS // stride - TILE * TILE


def staged_share(locations, level_shapes, radius: int, channels: int = 128,
                 padding: str = "zeros"):
    """The kernel's staging rule on the host: which tiles it stages.

    For every tile of 8x8 queries and level the kernel takes the grid
    corners ``floor(location / 2^l) - r`` of the queries whose grid meets
    the map (a NaN, infinite or beyond-2^30 location has no grid; with
    ``padding="border"`` a finite ``location / 2^l`` is first clamped into
    ``[-r, w_l - 1 + r] x [-r, h_l - 1 + r]``, so that its grid always
    meets the map, and only a NaN or infinite one has none), and
    stages their bounding box, ``(max - min + 2r+2)`` a side with the row
    pitch made odd, when it holds at most ``box_capacity(4)`` pixels; the
    chunk is the largest of 32, 16, 8, 4 channels whose capacity holds the
    box. A tile whose box is larger, and every tile when ``channels`` is not
    a multiple of 4 or ``radius`` not in ``STAGED_RADII``, goes query by
    query through global memory. A tile none of whose grids meets the map
    has no reads at all and counts as staged.

    Args:
      locations: ``[B, H, W, 2]`` float32 (x, y), any device.
      level_shapes: ``(h_l, w_l)`` of every pyramid level.

    Returns a dict: ``tiles`` and ``queries``, the shares of (tile, level)
    pairs and of queries on the staged path; ``box_pixels``, per level the
    mean pixels (rows times pitch) of the staged boxes; ``chunks``, per
    level the count of staged tiles by chunk size; ``staged_pixels``, the
    box pixels of all staged tiles and levels together (times 4 C bytes:
    what a launch copies into shared memory, beside fmap0 once a level)."""
    b, h, w, _ = locations.shape
    ty, tx = -(-h // TILE), -(-w // TILE)
    gw = 2 * radius + 2
    loc = torch.full((b, ty * TILE, tx * TILE, 2), float("nan"))
    loc[:, :h, :w] = locations.detach().float().cpu()
    exists = torch.zeros(ty * TILE, tx * TILE, dtype=torch.bool)
    exists[:h, :w] = True

    def tiles(t):       # [B, ty*8, tx*8, ...] -> [B, ty, tx, 64, ...]
        t = t.reshape(b, ty, TILE, tx, TILE, *t.shape[3:])
        return t.movedim(3, 2).flatten(3, 4)

    n_exist = tiles(exists.expand(b, -1, -1)).sum(-1)
    can_stage = channels % 4 == 0 and radius in STAGED_RADII
    out = {"tiles": 0.0, "queries": 0.0, "box_pixels": [], "chunks": [],
           "staged_pixels": 0}
    for lvl, (lh, lw) in enumerate(level_shapes):
        scaled = loc * (0.5 ** lvl)
        if padding == "border":
            lo = torch.tensor([-radius, -radius], dtype=scaled.dtype)
            hi = torch.tensor([lw - 1 + radius, lh - 1 + radius],
                              dtype=scaled.dtype)
            scaled = torch.where(torch.isfinite(scaled).all(-1, True),
                                 torch.minimum(torch.maximum(scaled, lo), hi),
                                 torch.full_like(scaled, float("nan")))
        corner = torch.floor(scaled)
        ok = (corner.abs() <= MAX_CORNER).all(-1)      # NaN compares false
        corner = torch.where(ok[..., None], corner, 0.0).long() - radius
        live = (ok & (corner[..., 0] > -gw) & (corner[..., 0] < lw)
                & (corner[..., 1] > -gw) & (corner[..., 1] < lh))
        live, corner = tiles(live), tiles(corner)
        big = torch.iinfo(torch.int64).max
        lo = torch.where(live[..., None], corner, big).amin(3)
        hi = torch.where(live[..., None], corner, -big).amax(3)
        any_live = live.any(-1)
        side = torch.where(any_live[..., None], hi - lo + gw, 0)
        pixels = side[..., 1] * (side[..., 0] | 1)
        staged = (pixels <= box_capacity(4)) & can_stage
        chunk = torch.zeros_like(pixels)
        for ch in (4, 8, 16, 32):
            chunk = torch.where(staged & any_live
                                & (pixels <= box_capacity(ch)), ch, chunk)
        out["tiles"] += float(staged.float().mean())
        out["queries"] += float((n_exist * staged).sum() / n_exist.sum())
        work = staged & any_live
        out["staged_pixels"] += int(pixels[work].sum())
        out["box_pixels"].append(
            float(pixels[work].float().mean()) if work.any() else 0.0)
        out["chunks"].append({ch: int((chunk == ch).sum())
                              for ch in (32, 16, 8, 4)})
    out["tiles"] /= len(level_shapes)
    out["queries"] /= len(level_shapes)
    return out


def lookup_correlation_cuda(fmap0, fmap1_pyramid, locations, radius: int,
                            padding: str = "zeros"):
    """Windowed correlation lookup over all batch items, queries and levels
    in one kernel launch.

    Args:
      fmap0: ``[B, H, W, C]`` float32 query features.
      fmap1_pyramid: sequence of ``[B, h_l, w_l, C]`` float32 pooled target
        features (at most 8 levels).
      locations: ``[B, H, W, 2]`` float32 (x, y) lookup centres at level-0
        scale.
      padding: ``"zeros"`` (RAFT's: a tap outside the map adds 0) or
        ``"border"`` (CoTracker's: each sample position clamped into the
        map first); see ``lookup_correlation_otf``.

    Returns ``[B, H, W, L*(2r+1)^2]`` float32 correlations (scaled by
    ``1/sqrt(C)``), ordered as ``lookup_correlation_otf``. CPU tensors take
    that plain PyTorch version; CUDA tensors launch the kernel (counted in
    ``lookup_correlation_cuda.launches``) or raise. Either is a
    ``raft_lookup.launch`` span."""
    # Imported here: models.raft imports this module.
    from feature_tracker_tpu_torch.models.raft import lookup_correlation_otf

    check(padding in PADDINGS, "lookup_correlation_cuda",
          f"padding must be one of {sorted(PADDINGS)}, got {padding!r}")
    return LOOKUP(lookup_correlation_cuda, fmap0,
                  lambda: lookup_correlation_otf(fmap0, fmap1_pyramid,
                                                 locations, radius, padding),
                  lambda: _prepare_lookup(
                      "lookup_correlation_cuda", fmap0, fmap1_pyramid,
                      locations, radius, padding))


def _prepare_lookup(where: str, fmap0, fmap1_pyramid, locations, radius: int,
                   padding: str):
    """Check the inputs and allocate the output of the kernel: ``(output,
    args)`` for :meth:`Kernel.__call__` (no work for an empty output)."""
    dev = fmap0.device
    levels = len(fmap1_pyramid)
    check(1 <= levels <= MAX_LEVELS, where,
          f"need 1..{MAX_LEVELS} pyramid levels, got {levels}")
    check(fmap0.dim() == 4, where, "fmap0 must be [B, H, W, C]")
    b, h, w, c = fmap0.shape
    check(tuple(locations.shape) == (b, h, w, 2), where,
          "locations must be [B, H, W, 2]")
    for f1 in fmap1_pyramid:
        check(f1.dim() == 4 and f1.shape[0] == b and f1.shape[3] == c
              and f1.shape[1] >= 1 and f1.shape[2] >= 1, where,
              "every pyramid level must be [B, h, w, C] with fmap0's B and C")
    for t in (fmap0, locations, *fmap1_pyramid):
        check(t.device == dev and t.dtype == torch.float32
              and t.is_contiguous(), where,
              "all tensors must be contiguous float32 on one device")
    check(isinstance(radius, int) and radius >= 0, where,
          "radius must be a non-negative int")
    k = 2 * radius + 1
    out = torch.empty((b, h, w, levels * k * k), dtype=torch.float32,
                      device=dev)

    if out.numel() == 0:
        return out, None
    ptrs = (ctypes.c_void_p * levels)(*[f.data_ptr() for f in fmap1_pyramid])
    heights = (ctypes.c_int * levels)(*[f.shape[1] for f in fmap1_pyramid])
    widths = (ctypes.c_int * levels)(*[f.shape[2] for f in fmap1_pyramid])
    return out, [ctypes.cast(ptrs, _VP), ctypes.cast(heights, _VP),
                 ctypes.cast(widths, _VP), levels, fmap0.data_ptr(),
                 locations.data_ptr(), out.data_ptr(), b, h, w, c, radius,
                 PADDINGS[padding], correlation_scale(c), STREAM, None]


def lookup_phase_clocks(fmap0, fmap1_pyramid, locations, radius: int,
                        padding: str = "zeros") -> dict:
    """Where the lookup kernel's time goes on these (valid, CUDA) inputs:
    the shares of ``LOOKUP_PHASES`` in the clocks of the blocks' first
    threads (:meth:`Kernel.phase_clocks`)."""
    where = "lookup_phase_clocks"
    return LOOKUP.phase_clocks(where, fmap0, lambda: _prepare_lookup(
        where, fmap0, fmap1_pyramid, locations, radius, padding))


counts_launches(lookup_correlation_cuda)
