"""CUDA kernels for the warped KLT trackers (affine and SE(2)/LSSD), FAST
mode, one pyramid level per launch — the counterpart of
``feature_tracker_tpu/ops/pallas_warp_klt.py``.

``csrc/klt_affine.cu`` and ``csrc/klt_lssd.cu`` each run one warp per
feature through one level's Gauss-Newton loop; their headers state what
they compute, their solver, their bound on an H100 and their design. They
are built by ``nvcc`` at first use (``ops/_build.py``) and called through
``ctypes`` on PyTorch's current stream.

:func:`affine_track_level_cuda` and :func:`lssd_track_level_cuda` dispatch
by the tensors' device: CPU tensors take the plain PyTorch versions
(``trackers/klt/affine.py``, ``trackers/klt/lssd.py``), CUDA tensors the
kernels. A CUDA input a kernel cannot take raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.ops.cuda_klt import (
    bind,
    check,
    check_features,
    check_images,
    raise_on_error,
)

AFFINE_LIBRARY = ("ftk_klt_affine", ("klt_affine.cu",))
LSSD_LIBRARY = ("ftk_klt_lssd", ("klt_lssd.cu",))

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def load_affine_library() -> ctypes.CDLL:
    """Build (at first use) and load the affine kernel's library."""
    return bind(AFFINE_LIBRARY, "ftk_klt_affine_level",
                [_VP, _VP, _INT, _INT] + [_VP] * 7 + [_INT] * 5
                + [_FLOAT, _VP])


@functools.lru_cache(maxsize=None)
def load_lssd_library() -> ctypes.CDLL:
    """Build (at first use) and load the SE(2) kernel's library."""
    return bind(LSSD_LIBRARY, "ftk_klt_lssd_level",
                [_VP, _VP, _INT, _INT] + [_VP] * 7 + [_INT] * 6
                + [_FLOAT, _VP])


def _fast_only(where: str, opts: KltOptions) -> None:
    check(opts.method == KltMethod.FAST, where,
          "FAST mode only; DIRECT/INVERSE have no kernel and run in "
          "trackers.klt's plain PyTorch")


def affine_track_level_cuda(opts: KltOptions, ref_img, cur_img, ref_uv,
                            cur_uv, affine, skip):
    """FAST-mode affine KLT at one pyramid level in one kernel launch.

    Args:
      ref_img, cur_img: ``[H, W]`` float32.
      ref_uv, cur_uv: ``[N, 2]`` float32 positions at this level.
      affine: ``[N, 2, 2]`` float32.
      skip: ``[N]`` bool; skipped lanes return ``cur_uv``, ``affine`` and
        NOT_TRACKED.

    Returns ``(uv [N, 2], affine [N, 2, 2], status [N] int8)``. CPU tensors
    take the plain PyTorch version; CUDA tensors launch the kernel (counted
    in ``affine_track_level_cuda.launches``) or raise."""
    # Imported here: trackers.klt imports this module.
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_level_reference,
    )
    where = "affine_track_level_cuda"
    _fast_only(where, opts)
    dev = ref_uv.device
    if dev.type == "cpu":
        return affine_track_level_reference(opts, ref_img, cur_img, ref_uv,
                                            cur_uv, affine, skip)
    check(dev.type == "cuda", where, f"unsupported device {dev}")
    n = ref_uv.shape[0]
    check_images(where, dev, (ref_img,), (cur_img,))
    check_features(where, dev, n, skip, ref_uv=(ref_uv, (2,)),
                   cur_uv=(cur_uv, (2,)), affine=(affine, (2, 2)))
    out_uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_aff = torch.empty((n, 2, 2), dtype=torch.float32, device=dev)
    out_st = torch.empty((n,), dtype=torch.int8, device=dev)
    if n == 0:
        return out_uv, out_aff, out_st
    lib = load_affine_library()
    with torch.cuda.device(dev):
        rc = lib.ftk_klt_affine_level(
            ref_img.data_ptr(), cur_img.data_ptr(), ref_img.shape[0],
            ref_img.shape[1], ref_uv.data_ptr(), cur_uv.data_ptr(),
            affine.data_ptr(), skip.data_ptr(), out_uv.data_ptr(),
            out_aff.data_ptr(), out_st.data_ptr(), n,
            opts.patch_row_half_size, opts.patch_col_half_size,
            opts.max_iterations, opts.max_tolerance_large_step,
            float(opts.max_converge_step),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "ftk_klt_affine_level", rc)
    affine_track_level_cuda.launches += 1
    return out_uv, out_aff, out_st


def lssd_track_level_cuda(opts: KltOptions, luminance: bool, ref_img,
                          cur_img, ref_uv, rot, t, skip):
    """FAST-mode SE(2) KLT at one pyramid level in one kernel launch.

    Args:
      luminance: divide both patches by their means.
      ref_img, cur_img: ``[H, W]`` float32.
      ref_uv: ``[N, 2]`` float32 positions at this level.
      rot: ``[N, 2, 2]`` float32; t: ``[N, 2]`` float32.
      skip: ``[N]`` bool; skipped lanes return ``rot``, ``t`` and
        NOT_TRACKED.

    Returns ``(rot [N, 2, 2], t [N, 2], status [N] int8)``. CPU tensors
    take the plain PyTorch version; CUDA tensors launch the kernel (counted
    in ``lssd_track_level_cuda.launches``) or raise."""
    from feature_tracker_tpu_torch.trackers.klt.lssd import (
        lssd_track_level_reference,
    )
    where = "lssd_track_level_cuda"
    _fast_only(where, opts)
    dev = ref_uv.device
    if dev.type == "cpu":
        return lssd_track_level_reference(opts, luminance, ref_img, cur_img,
                                          ref_uv, rot, t, skip)
    check(dev.type == "cuda", where, f"unsupported device {dev}")
    n = ref_uv.shape[0]
    check_images(where, dev, (ref_img,), (cur_img,))
    check_features(where, dev, n, skip, ref_uv=(ref_uv, (2,)),
                   rot=(rot, (2, 2)), t=(t, (2,)))
    out_rot = torch.empty((n, 2, 2), dtype=torch.float32, device=dev)
    out_t = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_st = torch.empty((n,), dtype=torch.int8, device=dev)
    if n == 0:
        return out_rot, out_t, out_st
    lib = load_lssd_library()
    with torch.cuda.device(dev):
        rc = lib.ftk_klt_lssd_level(
            ref_img.data_ptr(), cur_img.data_ptr(), ref_img.shape[0],
            ref_img.shape[1], ref_uv.data_ptr(), rot.data_ptr(),
            t.data_ptr(), skip.data_ptr(), out_rot.data_ptr(),
            out_t.data_ptr(), out_st.data_ptr(), n, int(bool(luminance)),
            opts.patch_row_half_size, opts.patch_col_half_size,
            opts.max_iterations, opts.max_tolerance_large_step,
            float(opts.max_converge_step),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "ftk_klt_lssd_level", rc)
    lssd_track_level_cuda.launches += 1
    return out_rot, out_t, out_st


affine_track_level_cuda.launches = 0
lssd_track_level_cuda.launches = 0
