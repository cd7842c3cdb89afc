"""CUDA kernel for RAFT's windowed correlation lookup — the counterpart of
``feature_tracker_tpu/ops/pallas_raft_lookup.py``.

``csrc/raft_lookup.cu`` runs one warp per query pixel through every level
of the pooled feature pyramid in one launch; its header states what it
computes, its bound on an H100 and its design. It is built by ``nvcc`` at
first use (``ops/_build.py``) and called through ``ctypes`` on PyTorch's
current stream.

:func:`lookup_correlation_cuda` dispatches by the tensors' device: CPU
tensors take the plain PyTorch version
(``models/raft.py::lookup_correlation_otf``), CUDA tensors the kernel. A
CUDA input the kernel cannot take raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from feature_tracker_tpu_torch.ops.cuda_klt import (
    MAX_LEVELS,
    bind,
    check,
    raise_on_error,
)

LOOKUP_LIBRARY = ("ftk_raft_lookup", ("raft_lookup.cu",))

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def load_lookup_library() -> ctypes.CDLL:
    """Build (at first use) and load the lookup kernel's library."""
    return bind(LOOKUP_LIBRARY, "ftk_raft_lookup",
                [_VP] * 3 + [_INT] + [_VP] * 3 + [_INT] * 4 + [_FLOAT, _VP])


def correlation_scale(channels: int) -> float:
    """``1 / sqrt(C)`` as rounded in float32, the factor on fmap0."""
    return float(np.float32(1.0) / np.sqrt(np.float32(channels)))


def lookup_correlation_cuda(fmap0, fmap1_pyramid, locations, radius: int):
    """Windowed correlation lookup over all batch items, queries and levels
    in one kernel launch.

    Args:
      fmap0: ``[B, H, W, C]`` float32 query features.
      fmap1_pyramid: sequence of ``[B, h_l, w_l, C]`` float32 pooled target
        features (at most 8 levels).
      locations: ``[B, H, W, 2]`` float32 (x, y) lookup centres at level-0
        scale.

    Returns ``[B, H, W, L*(2r+1)^2]`` float32 correlations (scaled by
    ``1/sqrt(C)``), ordered as ``lookup_correlation_otf``. CPU tensors take
    that plain PyTorch version; CUDA tensors launch the kernel (counted in
    ``lookup_correlation_cuda.launches``) or raise."""
    # Imported here: models.raft imports this module.
    from feature_tracker_tpu_torch.models.raft import lookup_correlation_otf

    where = "lookup_correlation_cuda"
    dev = fmap0.device
    if dev.type == "cpu":
        return lookup_correlation_otf(fmap0, fmap1_pyramid, locations, radius)
    check(dev.type == "cuda", where, f"unsupported device {dev}")
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
        return out
    ptrs = (ctypes.c_void_p * levels)(*[f.data_ptr() for f in fmap1_pyramid])
    heights = (ctypes.c_int * levels)(*[f.shape[1] for f in fmap1_pyramid])
    widths = (ctypes.c_int * levels)(*[f.shape[2] for f in fmap1_pyramid])
    lib = load_lookup_library()
    with torch.cuda.device(dev):
        rc = lib.ftk_raft_lookup(
            ctypes.cast(ptrs, _VP), ctypes.cast(heights, _VP),
            ctypes.cast(widths, _VP), levels, fmap0.data_ptr(),
            locations.data_ptr(), out.data_ptr(), b, h * w, c, radius,
            correlation_scale(c), torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "ftk_raft_lookup", rc)
    lookup_correlation_cuda.launches += 1
    return out


lookup_correlation_cuda.launches = 0
