"""CUDA kernels for the warped KLT trackers (affine and SE(2)/LSSD), FAST
mode — the counterpart of ``feature_tracker_tpu/ops/pallas_warp_klt.py``.

``csrc/klt_affine.cu`` and ``csrc/klt_lssd.cu`` each run one warp per
feature through the whole coarse-to-fine loop in one launch (one level is a
pyramid of one). Their headers state what they compute, their solver, their
bound on an H100 and their design. They are built by ``nvcc`` at first use
(``ops/_build.py``) and called through ``ctypes`` on PyTorch's current
stream.

:func:`affine_track_pyramid_cuda`, :func:`affine_track_level_cuda`,
:func:`lssd_track_pyramid_cuda` and :func:`lssd_track_level_cuda` dispatch
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
    bind_phase_clocks,
    check,
    check_features,
    check_pyramids,
    occupancy,
    pyramid_args,
    raise_on_error,
    read_phase_clocks,
)
from feature_tracker_tpu_torch.utils.profiling import counts_launches

AFFINE_LIBRARY = ("ftk_klt_affine", ("klt_affine.cu",))
LSSD_LIBRARY = ("ftk_klt_lssd", ("klt_lssd.cu",))

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


_AFFINE_ARGTYPES = ([_VP] * 4 + [_INT] + [_VP] * 7 + [_INT] * 5
                    + [_FLOAT, _VP])
# The phases csrc/klt_affine.cu marks, in its order.
AFFINE_PHASES = ("patch", "sums of H", "reduction of H", "factorisation",
                 "step pixels", "step reduction", "step solve")


@functools.lru_cache(maxsize=None)
def load_affine_library() -> ctypes.CDLL:
    """Build (at first use) and load the affine kernel's library."""
    lib = bind(AFFINE_LIBRARY, "ftk_klt_affine_pyramid", _AFFINE_ARGTYPES)
    lib.ftk_klt_affine_occupancy.argtypes = [_INT, _INT, _VP, _VP, _VP]
    lib.ftk_klt_affine_occupancy.restype = _INT
    return lib


_LSSD_ARGTYPES = ([_VP] * 4 + [_INT] + [_VP] * 9 + [_INT] * 6
                  + [_FLOAT, _VP])
# The phases csrc/klt_lssd.cu marks, in its order.
LSSD_PHASES = ("patch", "pass 1", "means", "pass 2", "step reduction",
               "step solve")


@functools.lru_cache(maxsize=None)
def load_lssd_library() -> ctypes.CDLL:
    """Build (at first use) and load the SE(2) kernel's library."""
    lib = bind(LSSD_LIBRARY, "ftk_klt_lssd_pyramid", _LSSD_ARGTYPES)
    lib.ftk_klt_lssd_occupancy.argtypes = [_INT, _INT, _INT, _VP, _VP, _VP]
    lib.ftk_klt_lssd_occupancy.restype = _INT
    return lib


def _fast_only(where: str, opts: KltOptions) -> None:
    check(opts.method == KltMethod.FAST, where,
          "FAST mode only; DIRECT/INVERSE have no kernel and run in "
          "trackers.klt's plain PyTorch")


def _launch_affine(where: str, lib, opts: KltOptions, ref_pyr, cur_pyr,
                   ref_uv, cur_uv, affine, skip):
    """Check the inputs and launch ``lib``'s affine kernel on a pyramid
    (finest level first; positions at full resolution). Returns the outputs
    and whether a kernel was launched (not for zero features)."""
    dev = ref_uv.device
    levels = check_pyramids(where, dev, ref_pyr, cur_pyr)
    n = ref_uv.shape[0]
    check_features(where, dev, n, skip, ref_uv=(ref_uv, (2,)),
                   cur_uv=(cur_uv, (2,)), affine=(affine, (2, 2)))
    out_uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_aff = torch.empty((n, 2, 2), dtype=torch.float32, device=dev)
    out_st = torch.empty((n,), dtype=torch.int8, device=dev)
    if n == 0:
        return (out_uv, out_aff, out_st), False
    with torch.cuda.device(dev):
        rc = lib.ftk_klt_affine_pyramid(
            *pyramid_args(ref_pyr, cur_pyr), levels, ref_uv.data_ptr(),
            cur_uv.data_ptr(), affine.data_ptr(), skip.data_ptr(),
            out_uv.data_ptr(), out_aff.data_ptr(), out_st.data_ptr(), n,
            opts.patch_row_half_size, opts.patch_col_half_size,
            opts.max_iterations, opts.max_tolerance_large_step,
            float(opts.max_converge_step),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "ftk_klt_affine_pyramid", rc)
    return (out_uv, out_aff, out_st), True


def affine_track_pyramid_cuda(opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                              cur_uv, affine, skip):
    """Whole-pyramid FAST-mode affine KLT in one kernel launch.

    Args:
      ref_pyr, cur_pyr: sequences of ``[H_l, W_l]`` float32 levels, finest
        first (at most 8).
      ref_uv, cur_uv: ``[N, 2]`` float32 full-resolution positions.
      affine: ``[N, 2, 2]`` float32, the warp at the coarsest level; it is
        carried from level to level.
      skip: ``[N]`` bool; skipped lanes return ``cur_uv``, ``affine`` and
        NOT_TRACKED.

    Returns ``(uv [N, 2] at full resolution, affine [N, 2, 2], status [N]
    int8 of the finest level)``; the final outside check and the skip
    pass-through of the input status are the caller's. CPU tensors take the
    plain PyTorch version (the level loop over the one-level plain
    version); CUDA tensors launch the kernel (counted in
    ``affine_track_pyramid_cuda.launches``) or raise."""
    # Imported here: trackers.klt imports this module.
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_pyramid_reference,
    )
    _fast_only("affine_track_pyramid_cuda", opts)
    if ref_uv.device.type == "cpu":
        return affine_track_pyramid_reference(opts, ref_pyr, cur_pyr, ref_uv,
                                              cur_uv, affine, skip)
    check(ref_uv.device.type == "cuda", "affine_track_pyramid_cuda",
          f"unsupported device {ref_uv.device}")
    out, launched = _launch_affine(
        "affine_track_pyramid_cuda", load_affine_library(), opts, ref_pyr,
        cur_pyr, ref_uv, cur_uv, affine, skip)
    affine_track_pyramid_cuda.launches += launched
    return out


def affine_track_level_cuda(opts: KltOptions, ref_img, cur_img, ref_uv,
                            cur_uv, affine, skip):
    """FAST-mode affine KLT at one pyramid level in one kernel launch: the
    one-level case of :func:`affine_track_pyramid_cuda`'s kernel.

    Args:
      ref_img, cur_img: ``[H, W]`` float32.
      ref_uv, cur_uv: ``[N, 2]`` float32 positions at this level.
      affine: ``[N, 2, 2]`` float32.
      skip: ``[N]`` bool; skipped lanes return ``cur_uv``, ``affine`` and
        NOT_TRACKED.

    Returns ``(uv [N, 2], affine [N, 2, 2], status [N] int8)``. CPU tensors
    take the plain PyTorch version; CUDA tensors launch the kernel (counted
    in ``affine_track_level_cuda.launches``) or raise."""
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_level_reference,
    )
    _fast_only("affine_track_level_cuda", opts)
    if ref_uv.device.type == "cpu":
        return affine_track_level_reference(opts, ref_img, cur_img, ref_uv,
                                            cur_uv, affine, skip)
    check(ref_uv.device.type == "cuda", "affine_track_level_cuda",
          f"unsupported device {ref_uv.device}")
    out, launched = _launch_affine(
        "affine_track_level_cuda", load_affine_library(), opts, (ref_img,),
        (cur_img,), ref_uv, cur_uv, affine, skip)
    affine_track_level_cuda.launches += launched
    return out


def affine_phase_clocks(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                        affine, skip) -> dict:
    """Where the affine kernel's time goes on these CUDA inputs: one launch
    of its build with phase clocks (``csrc/klt_common.cuh``), then the
    shares of ``AFFINE_PHASES`` in the clocks of all warps
    (:func:`cuda_klt.read_phase_clocks`). A diagnostic: the clocks slow the
    kernel a little, and the launch is in no wrapper's count."""
    lib = bind_phase_clocks("ftk_klt_affine_phases", "klt_affine.cu",
                            "ftk_klt_affine_pyramid", _AFFINE_ARGTYPES)
    read_phase_clocks(lib, AFFINE_PHASES)
    _launch_affine("affine_phase_clocks", lib, opts, ref_pyr, cur_pyr, ref_uv,
                   cur_uv, affine, skip)
    torch.cuda.synchronize(ref_uv.device)
    return read_phase_clocks(lib, AFFINE_PHASES)


def affine_occupancy(opts: KltOptions) -> dict:
    """:func:`cuda_klt.occupancy` of the affine kernel at ``opts``' patch
    size."""
    return occupancy(load_affine_library(), "ftk_klt_affine_occupancy",
                     opts)


def _launch_lssd(where: str, lib, opts: KltOptions, luminance: bool,
                 ref_pyr, cur_pyr, ref_uv, rot, skip, cur_uv=None, t=None):
    """Check the inputs and launch ``lib``'s SE(2) kernel on a pyramid
    (finest level first) with ``cur_uv`` (full resolution: the whole-pyramid
    case, returns ``(uv, rot, status)``) or ``t`` (the coarsest level's
    translation: the one-level case, returns ``(rot, t, status)``). Also
    returns whether a kernel was launched (not for zero features)."""
    dev = ref_uv.device
    levels = check_pyramids(where, dev, ref_pyr, cur_pyr)
    n = ref_uv.shape[0]
    given = {"cur_uv": (cur_uv, (2,))} if t is None else {"t": (t, (2,))}
    check_features(where, dev, n, skip, ref_uv=(ref_uv, (2,)),
                   rot=(rot, (2, 2)), **given)
    out_v = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_rot = torch.empty((n, 2, 2), dtype=torch.float32, device=dev)
    out_st = torch.empty((n,), dtype=torch.int8, device=dev)
    out = ((out_v, out_rot, out_st) if t is None
           else (out_rot, out_v, out_st))
    if n == 0:
        return out, False
    ptr = (lambda x: None if x is None else x.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.ftk_klt_lssd_pyramid(
            *pyramid_args(ref_pyr, cur_pyr), levels, ref_uv.data_ptr(),
            ptr(cur_uv), ptr(t), rot.data_ptr(), skip.data_ptr(),
            out_v.data_ptr() if t is None else None, out_rot.data_ptr(),
            None if t is None else out_v.data_ptr(), out_st.data_ptr(), n,
            int(bool(luminance)), opts.patch_row_half_size,
            opts.patch_col_half_size, opts.max_iterations,
            opts.max_tolerance_large_step, float(opts.max_converge_step),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "ftk_klt_lssd_pyramid", rc)
    return out, True


def lssd_track_pyramid_cuda(opts: KltOptions, luminance: bool, ref_pyr,
                            cur_pyr, ref_uv, cur_uv, rot, skip):
    """Whole-pyramid FAST-mode SE(2) KLT in one kernel launch.

    Args:
      luminance: divide both patches by their means.
      ref_pyr, cur_pyr: sequences of ``[H_l, W_l]`` float32 levels, finest
        first (at most 8).
      ref_uv, cur_uv: ``[N, 2]`` float32 full-resolution positions.
      rot: ``[N, 2, 2]`` float32, the rotation at the coarsest level; it is
        carried from level to level. ``t = cur_uv - R ref_uv`` at the
        coarsest scale, and only ``t`` doubles between levels.
      skip: ``[N]`` bool; skipped lanes keep ``rot`` and their ``t`` and
        return NOT_TRACKED.

    Returns ``(uv = R ref_uv + t [N, 2] at full resolution, rot [N, 2, 2],
    status [N] int8 of the finest level)``; the final outside check and the
    skip pass-through of the input position and status are the caller's.
    CPU tensors take the plain PyTorch version (the level loop over the
    one-level plain version); CUDA tensors launch the kernel (counted in
    ``lssd_track_pyramid_cuda.launches``) or raise."""
    from feature_tracker_tpu_torch.trackers.klt.lssd import (
        lssd_track_pyramid_reference,
    )
    where = "lssd_track_pyramid_cuda"
    _fast_only(where, opts)
    if ref_uv.device.type == "cpu":
        return lssd_track_pyramid_reference(opts, luminance, ref_pyr,
                                            cur_pyr, ref_uv, cur_uv, rot,
                                            skip)
    check(ref_uv.device.type == "cuda", where,
          f"unsupported device {ref_uv.device}")
    out, launched = _launch_lssd(where, load_lssd_library(), opts, luminance,
                                 ref_pyr, cur_pyr, ref_uv, rot, skip,
                                 cur_uv=cur_uv)
    lssd_track_pyramid_cuda.launches += launched
    return out


def lssd_phase_clocks(opts: KltOptions, luminance: bool, ref_pyr, cur_pyr,
                      ref_uv, cur_uv, rot, skip) -> dict:
    """Where the SE(2) kernel's time goes on these CUDA inputs: one
    whole-pyramid launch of its build with phase clocks, then the shares of
    ``LSSD_PHASES`` (:func:`cuda_klt.read_phase_clocks`). A diagnostic: the
    launch is in no wrapper's count."""
    lib = bind_phase_clocks("ftk_klt_lssd_phases", "klt_lssd.cu",
                            "ftk_klt_lssd_pyramid", _LSSD_ARGTYPES)
    read_phase_clocks(lib, LSSD_PHASES)
    _launch_lssd("lssd_phase_clocks", lib, opts, luminance, ref_pyr, cur_pyr,
                 ref_uv, rot, skip, cur_uv=cur_uv)
    torch.cuda.synchronize(ref_uv.device)
    return read_phase_clocks(lib, LSSD_PHASES)


def lssd_occupancy(opts: KltOptions, luminance: bool = False) -> dict:
    """:func:`cuda_klt.occupancy` of the SE(2) kernel that ``opts`` and
    ``luminance`` launch."""
    return occupancy(load_lssd_library(), "ftk_klt_lssd_occupancy", opts,
                     int(bool(luminance)))


def lssd_track_level_cuda(opts: KltOptions, luminance: bool, ref_img,
                          cur_img, ref_uv, rot, t, skip):
    """FAST-mode SE(2) KLT at one pyramid level in one kernel launch: the
    one-level case of :func:`lssd_track_pyramid_cuda`'s kernel.

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
    if ref_uv.device.type == "cpu":
        return lssd_track_level_reference(opts, luminance, ref_img, cur_img,
                                          ref_uv, rot, t, skip)
    check(ref_uv.device.type == "cuda", where,
          f"unsupported device {ref_uv.device}")
    out, launched = _launch_lssd(where, load_lssd_library(), opts, luminance,
                                 (ref_img,), (cur_img,), ref_uv, rot, skip,
                                 t=t)
    lssd_track_level_cuda.launches += launched
    return out


counts_launches(affine_track_pyramid_cuda, affine_track_level_cuda,
                lssd_track_pyramid_cuda, lssd_track_level_cuda)
