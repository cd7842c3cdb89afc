"""CUDA kernel for detection's greedy radius suppression (kernel 6).

No ``pallas_call`` corresponds: the JAX package's detection is plain XLA
(``feature_tracker_tpu/ops/detect.py::greedy_suppression``), which the port
runs on the host's terms as chunks of chaotic rounds, each ending in a read
of the device. ``csrc/detect_suppress.cu`` runs the sequential scan itself
in one launch and writes the padded ``uv`` and the count on the device; its
header states what it computes and its design. It is built by ``nvcc`` at
first use (``ops/_build.py``) and launched through ``ops/_launch.py``.
:func:`conflict_threshold` and :func:`grid_layout` are the rules the launch
follows, on the host.

:func:`suppress_candidates_cuda` dispatches by the tensors' device: CPU
tensors take the plain PyTorch version (``ops/detect.py::
suppress_candidates``), CUDA tensors the kernel. A CUDA input the kernel
cannot take raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from feature_tracker_tpu_torch.ops import detect
from feature_tracker_tpu_torch.ops._launch import STREAM, Kernel, check
from feature_tracker_tpu_torch.utils.profiling import count, counts_launches

SUPPRESS_LIBRARY = ("ftk_detect_suppress", ("detect_suppress.cu",))

# The grid's limits, as csrc/detect_suppress.cu sizes its shared memory.
MAX_GRID_CELLS = 11264      # cells of the shared-memory grid, at most
SLOTS = 4                   # kept points a cell can hold
MAX_SIDE = 32767            # image rows and columns, at most
# Counts a call's launches: 1 when it launched the kernel, 0 when it ran
# the plain version (CPU tensors) or had no candidate or slot.
COUNTER = "detect.suppression_kernel"

_VP, _INT = ctypes.c_void_p, ctypes.c_int
SUPPRESS = Kernel(SUPPRESS_LIBRARY, "ftk_detect_suppress",
                  [_VP, _VP] + [_INT] * 8 + [_VP] * 3, "detect.suppress", ())


def conflict_threshold(min_feature_distance) -> int:
    """The least integer squared distance that is no conflict: two pixels
    whose integer ``dx^2 + dy^2`` is below it conflict. This is the plain
    version's float32 test ``d2 < min_feature_distance ** 2`` (the square
    rounded to float32, as the comparison does) on integer distances,
    exactly while ``d2`` is below 2^24 (an image diagonal under 4096 px)."""
    square = float(np.float32(float(min_feature_distance) ** 2))
    if not square > 0.0:            # 0 or NaN: nothing conflicts
        return 0
    return min(math.ceil(square), 2 ** 31 - 1)


def grid_layout(shape, threshold: int):
    """The kernel's grid over an image of ``shape`` ``(H, W)``: ``(cell,
    cols, rows)`` with ``cell`` the least integer side whose square is at
    least ``threshold`` (so a conflicting point lies in the 3x3 cells around
    a candidate, and a cell holds at most ``SLOTS`` kept points), or None
    where the grid would have more than ``MAX_GRID_CELLS`` cells and the
    kernel tests against its list of kept points instead. The launch passes
    this layout to the kernel, which only checks it."""
    cell = math.isqrt(threshold - 1) + 1 if threshold > 0 else 1
    cols, rows = -(-shape[1] // cell), -(-shape[0] // cell)
    if cols * rows > MAX_GRID_CELLS:
        return None
    return cell, cols, rows


def suppress_candidates_cuda(top_scores, flat_idx, shape, max_num: int,
                             min_feature_distance):
    """Exact greedy radius suppression of ranked candidates in one kernel
    launch, with no read of the device.

    Args:
      top_scores: ``[k]`` float32 candidate scores in descending order,
        -inf for no candidate (``ops/detect.py::ranked_candidates``).
      flat_idx: ``[k]`` int64 flat pixel indices of the candidates.
      shape: the image's ``(H, W)``.
      max_num: maximum number of returned features.
      min_feature_distance: kept features lie at least this far apart.

    Returns ``(uv [max_num, 2] float32 (x, y) padded with -1, num int32
    0-dim)``, as ``ops/detect.py::suppress_candidates``. CPU tensors take
    that plain version; CUDA tensors launch the kernel (counted in
    ``suppress_candidates_cuda.launches`` and the ``COUNTER``) or raise.
    Either is a ``detect.suppress`` span."""
    launches = suppress_candidates_cuda.launches
    out = SUPPRESS(suppress_candidates_cuda, top_scores,
                   lambda: detect.suppress_candidates(
                       top_scores, flat_idx, shape, max_num,
                       min_feature_distance),
                   lambda: _prepare_suppress(
                       "suppress_candidates_cuda", top_scores, flat_idx,
                       shape, max_num, min_feature_distance))
    count(COUNTER, suppress_candidates_cuda.launches - launches)
    return out


def _prepare_suppress(where: str, top_scores, flat_idx, shape, max_num: int,
                      min_feature_distance):
    """Check the inputs and allocate the outputs of the kernel: ``((uv,
    num), args)`` for :meth:`Kernel.__call__`; with no candidate or no
    slot the outputs are the padding and there is no work."""
    dev = top_scores.device
    h, w = (int(s) for s in shape)
    check(top_scores.dim() == 1 and top_scores.dtype == torch.float32
          and top_scores.is_contiguous(), where,
          "top_scores must be a contiguous [k] float32 tensor")
    check(tuple(flat_idx.shape) == tuple(top_scores.shape)
          and flat_idx.dtype == torch.int64 and flat_idx.is_contiguous()
          and flat_idx.device == dev, where,
          "flat_idx must be a contiguous [k] int64 tensor beside top_scores")
    check(1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE, where,
          f"the image must be 1..{MAX_SIDE} px a side, got {h}x{w}")
    check(max_num >= 0, where, "max_num must not be negative")
    k, max_num = top_scores.shape[0], int(max_num)
    if k == 0 or max_num == 0:
        return (torch.full((max_num, 2), -1.0, dtype=torch.float32,
                           device=dev),
                torch.zeros((), dtype=torch.int32, device=dev)), None
    threshold = conflict_threshold(min_feature_distance)
    cell, cols, rows = grid_layout((h, w), threshold) or (0, 0, 0)
    uv = torch.empty((max_num, 2), dtype=torch.float32, device=dev)
    num = torch.empty((), dtype=torch.int32, device=dev)
    return (uv, num), [top_scores.data_ptr(), flat_idx.data_ptr(), k, h, w,
                       threshold, cell, cols, rows, max_num, uv.data_ptr(),
                       num.data_ptr(), STREAM]


counts_launches(suppress_candidates_cuda)
