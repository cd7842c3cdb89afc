"""CUDA kernels for the basic-KLT tracker, whole pyramid in one launch —
the counterpart of ``feature_tracker_tpu/ops/pallas_klt.py``.

``csrc/klt_fast.cu`` (FAST mode) and ``csrc/klt_iter.cu`` (DIRECT and
INVERSE) each run one warp per feature through the entire coarse-to-fine
Gauss-Newton loop; their headers state what they compute, their bound on
an H100 and their design. They are built by ``nvcc`` at first use
(``ops/_build.py``) and launched through ``ops/_launch.py``.

:func:`track_pyramid_fast_cuda` and :func:`track_pyramid_iter_cuda`
dispatch by the tensors' device: CPU tensors take the plain PyTorch
versions (``trackers/klt/basic.py``), CUDA tensors the kernels. A CUDA
input a kernel cannot take raises; there is no fallback. This module
keeps the checks and the C arguments of kernels 1-4's pyramids.
"""

from __future__ import annotations

import ctypes

import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.ops._launch import STREAM, Kernel, check
from feature_tracker_tpu_torch.utils.profiling import (
    count,
    counts_launches,
    enabled,
    kernel_counters,
)

MAX_LEVELS = 8  # FTK_MAX_LEVELS in csrc/klt_common.cuh
FAST_LIBRARY = ("ftk_klt_fast", ("klt_fast.cu",))
ITER_LIBRARY = ("ftk_klt_iter", ("klt_iter.cu",))

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The counters the FAST kernel adds to while tracing: Gauss-Newton steps
# (summed over the levels) and non-skipped lanes.
FAST_COUNTERS = ("klt.gn_steps", "klt.lanes")
# The phases csrc/klt_fast.cu marks, in its order.
FAST_PHASES = ("level setup", "step pixels", "step reduction",
               "step solve and update")
FAST = Kernel(FAST_LIBRARY, "ftk_klt_fast_pyramid",
              [_VP] * 4 + [_INT] + [_VP] * 5 + [_INT] * 5 + [_FLOAT, _VP, _VP],
              "klt.launch", FAST_PHASES)

# The phases csrc/klt_iter.cu marks, in its order.
ITER_PHASES = ("level setup", "step patch", "step pixels", "step reduction",
               "step solve")
ITER = Kernel(ITER_LIBRARY, "ftk_klt_iter_pyramid",
              [_VP] * 4 + [_INT] + [_VP] * 6 + [_INT] * 5 + [_FLOAT, _VP],
              "klt.launch", ITER_PHASES)


def check_images(where: str, dev, ref_imgs, cur_imgs) -> None:
    """Both sequences hold contiguous float32 ``[H, W]`` images on ``dev``,
    pairwise of one shape."""
    for r, c in zip(ref_imgs, cur_imgs):
        for img in (r, c):
            check(img.device == dev, where,
                  "all tensors must share one device")
            check(img.dtype == torch.float32 and img.dim() == 2
                  and img.is_contiguous(), where,
                  "levels must be contiguous float32 [H, W]")
        check(r.shape == c.shape, where, "ref and cur levels differ in shape")


def check_features(where: str, dev, n: int, skip, **tensors) -> None:
    """``skip`` is bool ``[N]`` and every named tensor contiguous float32
    ``[N, ...]`` of its given trailing shape, all on ``dev``."""
    check(skip.shape == (n,) and skip.dtype == torch.bool, where,
          "skip must be bool [N]")
    for name, (t, tail) in tensors.items():
        check(tuple(t.shape) == (n,) + tail, where,
              f"{name} must be [N{''.join(f', {d}' for d in tail)}]")
        check(t.dtype == torch.float32, where, f"{name} must be float32")
    for t in [skip] + [t for t, _ in tensors.values()]:
        check(t.device == dev and t.is_contiguous(), where,
              "features and skip must be contiguous on the images' device")


def check_pyramids(where: str, dev, ref_pyr, cur_pyr) -> int:
    """Both pyramids hold 1..MAX_LEVELS levels (:func:`check_images`);
    returns their number."""
    levels = len(ref_pyr)
    check(1 <= levels <= MAX_LEVELS and len(cur_pyr) == levels, where,
          f"need 1..{MAX_LEVELS} levels in both pyramids, got "
          f"{levels} and {len(cur_pyr)}")
    check_images(where, dev, ref_pyr, cur_pyr)
    return levels


def pyramid_args(ref_pyr, cur_pyr) -> list:
    """The level pointers and sizes as the C entries take them: four host
    arrays."""
    levels = len(ref_pyr)
    ptrs = ctypes.c_void_p * levels
    ints = ctypes.c_int * levels
    return [ctypes.cast(a, _VP) for a in (
        ptrs(*[im.data_ptr() for im in ref_pyr]),
        ptrs(*[im.data_ptr() for im in cur_pyr]),
        ints(*[im.shape[0] for im in ref_pyr]),
        ints(*[im.shape[1] for im in ref_pyr]))]


def _prepare_pyramid(where: str, opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                    cur_uv, status, skip):
    """Check the inputs and allocate the outputs of the FAST kernel
    (``status`` None) or the DIRECT / INVERSE kernel: ``(outputs, args)``
    for :meth:`Kernel.__call__`. While tracing, the FAST kernel
    counts its steps and lanes (``FAST_COUNTERS``) into a row of the
    tracer's device ring."""
    dev = ref_uv.device
    levels = check_pyramids(where, dev, ref_pyr, cur_pyr)
    n = ref_uv.shape[0]
    check_features(where, dev, n, skip, ref_uv=(ref_uv, (2,)),
                   cur_uv=(cur_uv, (2,)))
    if status is not None:
        check(status.shape == (n,) and status.dtype == torch.int8
              and status.device == dev and status.is_contiguous(), where,
              "status must be contiguous int8 [N] on the images' device")
    out_uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_st = torch.empty((n,), dtype=torch.int8, device=dev)
    if n == 0:
        return (out_uv, out_st), None
    if status is None:
        return (out_uv, out_st), [
            *pyramid_args(ref_pyr, cur_pyr), levels, ref_uv.data_ptr(),
            cur_uv.data_ptr(), skip.data_ptr(), out_uv.data_ptr(),
            out_st.data_ptr(), n, opts.patch_row_half_size,
            opts.patch_col_half_size, opts.max_iterations,
            opts.max_tolerance_large_step, float(opts.max_converge_step),
            STREAM, kernel_counters(dev, FAST_COUNTERS)]
    return (out_uv, out_st), [
        *pyramid_args(ref_pyr, cur_pyr), levels, ref_uv.data_ptr(),
        cur_uv.data_ptr(), status.data_ptr(), skip.data_ptr(),
        out_uv.data_ptr(), out_st.data_ptr(), n,
        int(opts.method == KltMethod.INVERSE), opts.patch_row_half_size,
        opts.patch_col_half_size, opts.max_iterations,
        float(opts.max_converge_step), STREAM]


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
    CPU tensors take the plain PyTorch version (which, while tracing,
    counts its steps and lanes as the kernel does); CUDA tensors launch the
    kernel (counted in ``track_pyramid_fast_cuda.launches``) or raise.
    Either is a ``klt.launch`` span."""
    # Imported here: trackers.klt imports this module.
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        track_pyramid_fast_reference,
    )
    where = "track_pyramid_fast_cuda"
    check(opts.method == KltMethod.FAST, where,
          "FAST mode only; DIRECT/INVERSE is track_pyramid_iter_cuda")

    def plain():
        uv, st, steps = track_pyramid_fast_reference(
            opts, ref_pyr, cur_pyr, ref_uv, cur_uv, skip, with_steps=True)
        if enabled():
            count(FAST_COUNTERS[0], int(steps.sum()))
            count(FAST_COUNTERS[1], int((~skip).sum()))
        return uv, st

    return FAST(track_pyramid_fast_cuda, ref_uv, plain,
                lambda: _prepare_pyramid(where, opts, ref_pyr, cur_pyr, ref_uv,
                                         cur_uv, None, skip))


def track_pyramid_iter_cuda(opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                            cur_uv, status, skip):
    """Whole-pyramid DIRECT / INVERSE tracker (``opts.method``) in one
    kernel launch.

    Arguments as :func:`track_pyramid_fast_cuda`, plus ``status`` ``[N]``
    int8, the incoming status: it is kept, also from level to level, until
    a break rule sets another. Skipped lanes return ``cur_uv`` and their
    incoming status.

    Returns ``(uv [N, 2] float32, status [N] int8)``; the final outside
    check is the caller's. CPU tensors take the plain PyTorch version;
    CUDA tensors launch the kernel (counted in
    ``track_pyramid_iter_cuda.launches``) or raise. Either is a
    ``klt.launch`` span."""
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        track_pyramid_iter_reference,
    )
    where = "track_pyramid_iter_cuda"
    check(opts.method != KltMethod.FAST, where,
          "DIRECT/INVERSE only; FAST mode is track_pyramid_fast_cuda")
    return ITER(track_pyramid_iter_cuda, ref_uv,
                lambda: track_pyramid_iter_reference(
                    opts, ref_pyr, cur_pyr, ref_uv, cur_uv, status, skip),
                lambda: _prepare_pyramid(where, opts, ref_pyr, cur_pyr, ref_uv,
                                         cur_uv, status, skip))


def fast_phase_clocks(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                      skip) -> dict:
    """Where the FAST kernel's time goes on these CUDA inputs: the shares
    of ``FAST_PHASES`` (:meth:`Kernel.phase_clocks`)."""
    where = "fast_phase_clocks"
    check(opts.method == KltMethod.FAST, where, "FAST mode only")
    return FAST.phase_clocks(where, ref_uv, lambda: _prepare_pyramid(
        where, opts, ref_pyr, cur_pyr, ref_uv, cur_uv, None, skip))


def fast_occupancy(opts: KltOptions) -> dict:
    """:meth:`Kernel.occupancy` of the FAST kernel at ``opts``' patch
    size."""
    return FAST.occupancy("fast_occupancy", "ftk_klt_fast_occupancy",
                          opts.patch_row_half_size, opts.patch_col_half_size)


def iter_phase_clocks(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                      status, skip) -> dict:
    """Where the DIRECT / INVERSE kernel's time goes on these CUDA inputs
    (``opts.method``): the shares of ``ITER_PHASES``
    (:meth:`Kernel.phase_clocks`)."""
    where = "iter_phase_clocks"
    check(opts.method != KltMethod.FAST, where, "DIRECT/INVERSE only")
    return ITER.phase_clocks(where, ref_uv, lambda: _prepare_pyramid(
        where, opts, ref_pyr, cur_pyr, ref_uv, cur_uv, status, skip))


def iter_occupancy(opts: KltOptions) -> dict:
    """:meth:`Kernel.occupancy` of the DIRECT / INVERSE kernel that
    ``opts`` launches."""
    return ITER.occupancy("iter_occupancy", "ftk_klt_iter_occupancy",
                          opts.patch_row_half_size, opts.patch_col_half_size,
                          int(opts.method == KltMethod.INVERSE))


counts_launches(track_pyramid_fast_cuda, track_pyramid_iter_cuda)
