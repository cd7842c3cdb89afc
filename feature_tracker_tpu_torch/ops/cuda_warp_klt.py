"""CUDA kernels for the warped KLT trackers (affine and SE(2)/LSSD), FAST
mode — the counterpart of ``feature_tracker_tpu/ops/pallas_warp_klt.py``.

``csrc/klt_affine.cu`` and ``csrc/klt_lssd.cu`` each run one warp per
feature through the whole coarse-to-fine loop in one launch (one level is a
pyramid of one). Their headers state what they compute, their solver, their
bound on an H100 and their design. They are built by ``nvcc`` at first use
(``ops/_build.py``) and launched through ``ops/_launch.py``.

:func:`affine_track_pyramid_cuda`, :func:`affine_track_level_cuda`,
:func:`lssd_track_pyramid_cuda` and :func:`lssd_track_level_cuda` dispatch
by the tensors' device: CPU tensors take the plain PyTorch versions
(``trackers/klt/affine.py``, ``trackers/klt/lssd.py``), CUDA tensors the
kernels. A CUDA input a kernel cannot take raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.ops._launch import STREAM, Kernel, check
from feature_tracker_tpu_torch.ops.cuda_klt import (
    check_features,
    check_pyramids,
    pyramid_args,
)
from feature_tracker_tpu_torch.utils.profiling import counts_launches

AFFINE_LIBRARY = ("ftk_klt_affine", ("klt_affine.cu",))
LSSD_LIBRARY = ("ftk_klt_lssd", ("klt_lssd.cu",))

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The phases csrc/klt_affine.cu marks, in its order.
AFFINE_PHASES = ("patch", "sums of H", "reduction of H", "factorisation",
                 "step pixels", "step reduction", "step solve")
AFFINE = Kernel(AFFINE_LIBRARY, "ftk_klt_affine_pyramid",
                [_VP] * 4 + [_INT] + [_VP] * 7 + [_INT] * 5 + [_FLOAT, _VP],
                "klt.launch", AFFINE_PHASES)

# The phases csrc/klt_lssd.cu marks, in its order.
LSSD_PHASES = ("patch", "pass 1", "means", "pass 2", "step reduction",
               "step solve")
LSSD = Kernel(LSSD_LIBRARY, "ftk_klt_lssd_pyramid",
              [_VP] * 4 + [_INT] + [_VP] * 9 + [_INT] * 6 + [_FLOAT, _VP],
              "klt.launch", LSSD_PHASES)


def _fast_only(where: str, opts: KltOptions) -> None:
    check(opts.method == KltMethod.FAST, where,
          "FAST mode only; DIRECT/INVERSE have no kernel and run in "
          "trackers.klt's plain PyTorch")


def _prepare_affine(where: str, opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                   cur_uv, affine, skip):
    """Check the inputs and allocate the outputs of the affine kernel on a
    pyramid (finest level first; positions at full resolution): ``(outputs,
    args)`` for :meth:`Kernel.__call__`."""
    dev = ref_uv.device
    levels = check_pyramids(where, dev, ref_pyr, cur_pyr)
    n = ref_uv.shape[0]
    check_features(where, dev, n, skip, ref_uv=(ref_uv, (2,)),
                   cur_uv=(cur_uv, (2,)), affine=(affine, (2, 2)))
    out_uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_aff = torch.empty((n, 2, 2), dtype=torch.float32, device=dev)
    out_st = torch.empty((n,), dtype=torch.int8, device=dev)
    if n == 0:
        return (out_uv, out_aff, out_st), None
    return (out_uv, out_aff, out_st), [
        *pyramid_args(ref_pyr, cur_pyr), levels, ref_uv.data_ptr(),
        cur_uv.data_ptr(), affine.data_ptr(), skip.data_ptr(),
        out_uv.data_ptr(), out_aff.data_ptr(), out_st.data_ptr(), n,
        opts.patch_row_half_size, opts.patch_col_half_size,
        opts.max_iterations, opts.max_tolerance_large_step,
        float(opts.max_converge_step), STREAM]


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
    ``affine_track_pyramid_cuda.launches``) or raise. Either is a
    ``klt.launch`` span."""
    # Imported here: trackers.klt imports this module.
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_pyramid_reference,
    )
    where = "affine_track_pyramid_cuda"
    _fast_only(where, opts)
    return AFFINE(affine_track_pyramid_cuda, ref_uv,
                  lambda: affine_track_pyramid_reference(
                      opts, ref_pyr, cur_pyr, ref_uv, cur_uv, affine, skip),
                  lambda: _prepare_affine(where, opts, ref_pyr, cur_pyr,
                                          ref_uv, cur_uv, affine, skip))


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
    in ``affine_track_level_cuda.launches``) or raise. Either is a
    ``klt.launch`` span."""
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_level_reference,
    )
    where = "affine_track_level_cuda"
    _fast_only(where, opts)
    return AFFINE(affine_track_level_cuda, ref_uv,
                  lambda: affine_track_level_reference(
                      opts, ref_img, cur_img, ref_uv, cur_uv, affine, skip),
                  lambda: _prepare_affine(where, opts, (ref_img,), (cur_img,),
                                          ref_uv, cur_uv, affine, skip))


def affine_phase_clocks(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                        affine, skip) -> dict:
    """Where the affine kernel's time goes on these CUDA inputs: the shares
    of ``AFFINE_PHASES`` in the clocks of all warps
    (:meth:`Kernel.phase_clocks`; the clocks slow the kernel a little)."""
    where = "affine_phase_clocks"
    return AFFINE.phase_clocks(where, ref_uv, lambda: _prepare_affine(
        where, opts, ref_pyr, cur_pyr, ref_uv, cur_uv, affine, skip))


def affine_occupancy(opts: KltOptions) -> dict:
    """:meth:`Kernel.occupancy` of the affine kernel at ``opts``' patch
    size."""
    return AFFINE.occupancy("affine_occupancy", "ftk_klt_affine_occupancy",
                            opts.patch_row_half_size,
                            opts.patch_col_half_size)


def _prepare_lssd(where: str, opts: KltOptions, luminance: bool, ref_pyr,
                 cur_pyr, ref_uv, rot, skip, cur_uv, t):
    """Check the inputs and allocate the outputs of the SE(2) kernel on a
    pyramid (finest level first) with ``cur_uv`` (full resolution: the
    whole-pyramid case, outputs ``(uv, rot, status)``) or ``t`` (the
    coarsest level's translation: the one-level case, outputs ``(rot, t,
    status)``), the other None: ``(outputs, args)`` for
    :meth:`Kernel.__call__`."""
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
        return out, None
    ptr = (lambda x: None if x is None else x.data_ptr())
    return out, [
        *pyramid_args(ref_pyr, cur_pyr), levels, ref_uv.data_ptr(),
        ptr(cur_uv), ptr(t), rot.data_ptr(), skip.data_ptr(),
        out_v.data_ptr() if t is None else None, out_rot.data_ptr(),
        None if t is None else out_v.data_ptr(), out_st.data_ptr(), n,
        int(bool(luminance)), opts.patch_row_half_size,
        opts.patch_col_half_size, opts.max_iterations,
        opts.max_tolerance_large_step, float(opts.max_converge_step),
        STREAM]


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
    ``lssd_track_pyramid_cuda.launches``) or raise. Either is a
    ``klt.launch`` span."""
    from feature_tracker_tpu_torch.trackers.klt.lssd import (
        lssd_track_pyramid_reference,
    )
    where = "lssd_track_pyramid_cuda"
    _fast_only(where, opts)
    return LSSD(lssd_track_pyramid_cuda, ref_uv,
                lambda: lssd_track_pyramid_reference(
                    opts, luminance, ref_pyr, cur_pyr, ref_uv, cur_uv, rot,
                    skip),
                lambda: _prepare_lssd(where, opts, luminance, ref_pyr, cur_pyr,
                                      ref_uv, rot, skip, cur_uv, None))


def lssd_phase_clocks(opts: KltOptions, luminance: bool, ref_pyr, cur_pyr,
                      ref_uv, cur_uv, rot, skip) -> dict:
    """Where the SE(2) kernel's time goes on these CUDA inputs: the shares
    of ``LSSD_PHASES`` in one whole-pyramid launch
    (:meth:`Kernel.phase_clocks`)."""
    where = "lssd_phase_clocks"
    return LSSD.phase_clocks(where, ref_uv, lambda: _prepare_lssd(
        where, opts, luminance, ref_pyr, cur_pyr, ref_uv, rot, skip, cur_uv,
        None))


def lssd_occupancy(opts: KltOptions, luminance: bool = False) -> dict:
    """:meth:`Kernel.occupancy` of the SE(2) kernel that ``opts`` and
    ``luminance`` launch."""
    return LSSD.occupancy("lssd_occupancy", "ftk_klt_lssd_occupancy",
                          opts.patch_row_half_size, opts.patch_col_half_size,
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
    in ``lssd_track_level_cuda.launches``) or raise. Either is a
    ``klt.launch`` span."""
    from feature_tracker_tpu_torch.trackers.klt.lssd import (
        lssd_track_level_reference,
    )
    where = "lssd_track_level_cuda"
    _fast_only(where, opts)
    return LSSD(lssd_track_level_cuda, ref_uv,
                lambda: lssd_track_level_reference(
                    opts, luminance, ref_img, cur_img, ref_uv, rot, t, skip),
                lambda: _prepare_lssd(where, opts, luminance, (ref_img,),
                                      (cur_img,), ref_uv, rot, skip, None, t))


counts_launches(affine_track_pyramid_cuda, affine_track_level_cuda,
                lssd_track_pyramid_cuda, lssd_track_level_cuda)
