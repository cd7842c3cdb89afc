"""CUDA kernel for the basic-KLT fast-mode tracker, whole pyramid in one
launch — the counterpart of ``feature_tracker_tpu/ops/pallas_klt.py``.

The kernel (``csrc/klt_fast.cu``) runs one warp per feature through the
entire coarse-to-fine Gauss-Newton loop; its header states what it
computes, its bound on an H100 and its design. It is built by ``nvcc`` at
first use (``ops/_build.py``) and called through ``ctypes`` on PyTorch's
current stream.

:func:`track_pyramid_fast_cuda` dispatches by the tensors' device: CPU
tensors take the plain PyTorch version
(``trackers/klt/basic.py::track_pyramid_fast_reference``), CUDA tensors
the kernel. A CUDA input the kernel cannot take raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes

import torch

from feature_tracker_tpu_torch.core.config import KltOptions
from feature_tracker_tpu_torch.ops._build import load_library

MAX_LEVELS = 8  # FTK_MAX_LEVELS in csrc/klt_fast.cu
_SOURCES = ("klt_fast.cu",)


def load_klt_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = load_library("ftk_klt_fast", _SOURCES)
    fn = lib.ftk_klt_fast_pyramid
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp, vp, vp, vp,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    lib.ftk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ftk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"track_pyramid_fast_cuda: {msg}")


def _launch(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv, skip):
    dev = ref_uv.device
    levels = len(ref_pyr)
    n = ref_uv.shape[0]
    _check(1 <= levels <= MAX_LEVELS and len(cur_pyr) == levels,
           f"need 1..{MAX_LEVELS} levels in both pyramids, got "
           f"{levels} and {len(cur_pyr)}")
    for r, c in zip(ref_pyr, cur_pyr):
        for img in (r, c):
            _check(img.device == dev, "all tensors must share one device")
            _check(img.dtype == torch.float32 and img.dim() == 2
                   and img.is_contiguous(),
                   "levels must be contiguous float32 [H, W]")
        _check(r.shape == c.shape, "ref and cur levels differ in shape")
    _check(ref_uv.shape == (n, 2) and cur_uv.shape == (n, 2),
           "ref_uv and cur_uv must be [N, 2]")
    _check(skip.shape == (n,) and skip.dtype == torch.bool,
           "skip must be bool [N]")
    for t in (ref_uv, cur_uv, skip):
        _check(t.device == dev and t.is_contiguous(),
               "uv and skip must be contiguous on the pyramids' device")
    _check(ref_uv.dtype == torch.float32 and cur_uv.dtype == torch.float32,
           "uv must be float32")

    out_uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_st = torch.empty((n,), dtype=torch.int8, device=dev)
    if n == 0:
        return out_uv, out_st
    lib = load_klt_library()
    ptrs = ctypes.c_void_p * levels
    ints = ctypes.c_int * levels
    ref_ptrs = ptrs(*[im.data_ptr() for im in ref_pyr])
    cur_ptrs = ptrs(*[im.data_ptr() for im in cur_pyr])
    hs = ints(*[im.shape[0] for im in ref_pyr])
    ws = ints(*[im.shape[1] for im in ref_pyr])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ftk_klt_fast_pyramid(
            ctypes.cast(ref_ptrs, ctypes.c_void_p),
            ctypes.cast(cur_ptrs, ctypes.c_void_p),
            ctypes.cast(hs, ctypes.c_void_p), ctypes.cast(ws, ctypes.c_void_p),
            levels, ref_uv.data_ptr(), cur_uv.data_ptr(), skip.data_ptr(),
            out_uv.data_ptr(), out_st.data_ptr(), n,
            opts.patch_row_half_size, opts.patch_col_half_size,
            opts.max_iterations, opts.max_tolerance_large_step,
            float(opts.max_converge_step), stream)
    if rc != 0:
        raise RuntimeError(
            "ftk_klt_fast_pyramid launch failed: "
            f"{lib.ftk_cuda_error_string(rc).decode()} (cudaError {rc})")
    track_pyramid_fast_cuda.launches += 1
    return out_uv, out_st


def track_pyramid_fast_cuda(opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                            cur_uv, skip):
    """Whole-pyramid FAST-mode tracker in one kernel launch.

    Args:
      ref_pyr, cur_pyr: sequences of ``[H_l, W_l]`` float32 levels, finest
        first (at most 8).
      ref_uv, cur_uv: ``[N, 2]`` float32 full-resolution positions.
      skip: ``[N]`` bool; skipped lanes return ``cur_uv`` and NOT_TRACKED.

    Returns ``(uv [N, 2] float32, status [N] int8)``; the final outside
    check and the skip pass-through of the input status are the caller's.
    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (counted in ``track_pyramid_fast_cuda.launches``) or raise."""
    # Imported here: trackers.klt imports this module.
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        require_fast,
        track_pyramid_fast_reference,
    )
    require_fast(opts)
    if ref_uv.device.type == "cpu":
        return track_pyramid_fast_reference(opts, ref_pyr, cur_pyr, ref_uv,
                                            cur_uv, skip)
    _check(ref_uv.device.type == "cuda",
           f"unsupported device {ref_uv.device}")
    return _launch(opts, ref_pyr, cur_pyr, ref_uv, cur_uv, skip)


track_pyramid_fast_cuda.launches = 0
