"""CUDA kernels for the basic-KLT tracker, whole pyramid in one launch —
the counterpart of ``feature_tracker_tpu/ops/pallas_klt.py``.

``csrc/klt_fast.cu`` (FAST mode) and ``csrc/klt_iter.cu`` (DIRECT and
INVERSE) each run one warp per feature through the entire coarse-to-fine
Gauss-Newton loop; their headers state what they compute, their bound on
an H100 and their design. They are built by ``nvcc`` at first use
(``ops/_build.py``) and called through ``ctypes`` on PyTorch's current
stream.

:func:`track_pyramid_fast_cuda` and :func:`track_pyramid_iter_cuda`
dispatch by the tensors' device: CPU tensors take the plain PyTorch
versions (``trackers/klt/basic.py``), CUDA tensors the kernels. A CUDA
input a kernel cannot take raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.ops._build import (
    load_library,
    phase_clock_library,
)
from feature_tracker_tpu_torch.utils.profiling import (
    count,
    counts_launches,
    enabled,
    kernel_counters,
    span,
)

MAX_LEVELS = 8  # FTK_MAX_LEVELS in csrc/klt_common.cuh
FAST_LIBRARY = ("ftk_klt_fast", ("klt_fast.cu",))
ITER_LIBRARY = ("ftk_klt_iter", ("klt_iter.cu",))

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(library, function: str, argtypes) -> ctypes.CDLL:
    """Build (at first use) and load ``library = (name, sources)``, and
    declare ``function``'s C signature (it returns a cudaError)."""
    lib = load_library(*library)
    fn = getattr(lib, function)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    lib.ftk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ftk_cuda_error_string.restype = ctypes.c_char_p
    return lib


_FAST_ARGTYPES = ([_VP] * 4 + [_INT] + [_VP] * 5 + [_INT] * 5
                  + [_FLOAT, _VP, _VP])
# The counters the FAST kernel adds to while tracing: Gauss-Newton steps
# (summed over the levels) and non-skipped lanes.
FAST_COUNTERS = ("klt.gn_steps", "klt.lanes")
# The phases csrc/klt_fast.cu marks, in its order.
FAST_PHASES = ("level setup", "step pixels", "step reduction",
               "step solve and update")


@functools.lru_cache(maxsize=None)
def load_klt_library() -> ctypes.CDLL:
    """Build (at first use) and load the FAST kernel's library."""
    lib = bind(FAST_LIBRARY, "ftk_klt_fast_pyramid", _FAST_ARGTYPES)
    lib.ftk_klt_fast_occupancy.argtypes = [_INT, _INT, _VP, _VP, _VP]
    lib.ftk_klt_fast_occupancy.restype = _INT
    return lib


_ITER_ARGTYPES = [_VP] * 4 + [_INT] + [_VP] * 6 + [_INT] * 5 + [_FLOAT, _VP]
# The phases csrc/klt_iter.cu marks, in its order.
ITER_PHASES = ("level setup", "step patch", "step pixels", "step reduction",
               "step solve")


@functools.lru_cache(maxsize=None)
def load_klt_iter_library() -> ctypes.CDLL:
    """Build (at first use) and load the DIRECT / INVERSE kernel's
    library."""
    lib = bind(ITER_LIBRARY, "ftk_klt_iter_pyramid", _ITER_ARGTYPES)
    lib.ftk_klt_iter_occupancy.argtypes = [_INT, _INT, _INT, _VP, _VP, _VP]
    lib.ftk_klt_iter_occupancy.restype = _INT
    return lib


def check(cond: bool, where: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{where}: {msg}")


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


def need_card(where: str, dev=None) -> None:
    """Raise before anything is built when there is no CUDA card (or ``dev``
    is not one): the diagnostics below read a kernel on the card and have
    no plain version."""
    if not torch.cuda.is_available() or (dev is not None
                                         and dev.type != "cuda"):
        raise RuntimeError(f"{where} needs a CUDA device and CUDA tensors: "
                           "it measures a kernel on the card")


def raise_on_error(lib, function: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{function} launch failed: "
            f"{lib.ftk_cuda_error_string(rc).decode()} (cudaError {rc})")


def bind_phase_clocks(name: str, source: str, function: str, argtypes,
                      fmad: bool = False) -> ctypes.CDLL:
    """Build and load ``csrc/<source>`` with phase clocks compiled in
    (``_build.phase_clock_library``) and declare ``function``'s signature
    and the counters' reader."""
    lib = bind(phase_clock_library(name, source, fmad), function, argtypes)
    lib.ftk_phase_clocks_read.argtypes = [ctypes.c_void_p]
    lib.ftk_phase_clocks_read.restype = ctypes.c_int
    return lib


def read_phase_clocks(lib, names) -> dict:
    """Read and reset the phase counters of a library built with phase
    clocks (after a synchronise): ``{"clocks": total, "share": {name:
    share of the total}}`` for the phases in ``names``, in the kernel's
    order."""
    counters = (ctypes.c_ulonglong * 8)()
    rc = lib.ftk_phase_clocks_read(ctypes.cast(counters, ctypes.c_void_p))
    raise_on_error(lib, "ftk_phase_clocks_read", rc)
    total = sum(counters) or 1
    return {"clocks": sum(counters),
            "share": {n: c / total for n, c in zip(names, counters)}}


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


def occupancy(lib, function: str, opts: KltOptions, *extra: int) -> dict:
    """What the current card holds of a kernel at ``opts``' patch size, from
    its library's ``function`` (``ftk_*_occupancy``, which takes the two
    half sizes, ``extra`` and three outputs): ``registers`` a thread,
    ``warps_per_block``, ``blocks_per_sm`` (from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and their product
    ``warps_per_sm``. Nothing is launched."""
    regs, warps, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = getattr(lib, function)(
        opts.patch_row_half_size, opts.patch_col_half_size, *extra,
        *(ctypes.cast(ctypes.pointer(v), _VP) for v in (regs, warps, blocks)))
    raise_on_error(lib, function, rc)
    return {"registers": regs.value, "warps_per_block": warps.value,
            "blocks_per_sm": blocks.value,
            "warps_per_sm": warps.value * blocks.value}


def _launch_pyramid(where: str, opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                    cur_uv, status, skip, lib=None):
    """Check the inputs and launch the FAST kernel (``status`` None) or the
    DIRECT / INVERSE kernel, of ``lib`` if given (a build with phase
    clocks). Returns the outputs and whether a kernel was launched (not for
    zero features). While tracing, the FAST kernel counts its steps and
    lanes (``FAST_COUNTERS``) into a row of the tracer's device ring."""
    with span("klt.launch"):
        return _checked_launch(where, opts, ref_pyr, cur_pyr, ref_uv, cur_uv,
                               status, skip, lib)


def _checked_launch(where, opts, ref_pyr, cur_pyr, ref_uv, cur_uv, status,
                    skip, lib):
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
        return (out_uv, out_st), False
    pyramids = pyramid_args(ref_pyr, cur_pyr)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if status is None:
            lib, function = lib or load_klt_library(), "ftk_klt_fast_pyramid"
            rc = lib.ftk_klt_fast_pyramid(
                *pyramids, levels, ref_uv.data_ptr(), cur_uv.data_ptr(),
                skip.data_ptr(), out_uv.data_ptr(), out_st.data_ptr(), n,
                opts.patch_row_half_size, opts.patch_col_half_size,
                opts.max_iterations, opts.max_tolerance_large_step,
                float(opts.max_converge_step), stream,
                kernel_counters(dev, FAST_COUNTERS))
        else:
            lib = lib or load_klt_iter_library()
            function = "ftk_klt_iter_pyramid"
            rc = lib.ftk_klt_iter_pyramid(
                *pyramids, levels, ref_uv.data_ptr(), cur_uv.data_ptr(),
                status.data_ptr(), skip.data_ptr(), out_uv.data_ptr(),
                out_st.data_ptr(), n,
                int(opts.method == KltMethod.INVERSE),
                opts.patch_row_half_size, opts.patch_col_half_size,
                opts.max_iterations, float(opts.max_converge_step), stream)
    raise_on_error(lib, function, rc)
    return (out_uv, out_st), True


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
    check(opts.method == KltMethod.FAST, "track_pyramid_fast_cuda",
          "FAST mode only; DIRECT/INVERSE is track_pyramid_iter_cuda")
    if ref_uv.device.type == "cpu":
        with span("klt.launch"):
            uv, st, steps = track_pyramid_fast_reference(
                opts, ref_pyr, cur_pyr, ref_uv, cur_uv, skip, with_steps=True)
            if enabled():
                count(FAST_COUNTERS[0], int(steps.sum()))
                count(FAST_COUNTERS[1], int((~skip).sum()))
            return uv, st
    check(ref_uv.device.type == "cuda", "track_pyramid_fast_cuda",
          f"unsupported device {ref_uv.device}")
    out, launched = _launch_pyramid("track_pyramid_fast_cuda", opts, ref_pyr,
                                    cur_pyr, ref_uv, cur_uv, None, skip)
    track_pyramid_fast_cuda.launches += launched
    return out


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
    ``track_pyramid_iter_cuda.launches``; a ``klt.launch`` span) or
    raise."""
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        track_pyramid_iter_reference,
    )
    check(opts.method != KltMethod.FAST, "track_pyramid_iter_cuda",
          "DIRECT/INVERSE only; FAST mode is track_pyramid_fast_cuda")
    if ref_uv.device.type == "cpu":
        return track_pyramid_iter_reference(opts, ref_pyr, cur_pyr, ref_uv,
                                            cur_uv, status, skip)
    check(ref_uv.device.type == "cuda", "track_pyramid_iter_cuda",
          f"unsupported device {ref_uv.device}")
    out, launched = _launch_pyramid("track_pyramid_iter_cuda", opts, ref_pyr,
                                    cur_pyr, ref_uv, cur_uv, status, skip)
    track_pyramid_iter_cuda.launches += launched
    return out


def fast_phase_clocks(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                      skip) -> dict:
    """Where the FAST kernel's time goes on these CUDA inputs: one launch of
    its build with phase clocks, then the shares of ``FAST_PHASES``
    (:func:`read_phase_clocks`). A diagnostic: the launch is in no
    wrapper's count."""
    check(opts.method == KltMethod.FAST, "fast_phase_clocks", "FAST mode only")
    need_card("fast_phase_clocks", ref_uv.device)
    lib = bind_phase_clocks("ftk_klt_fast_phases", "klt_fast.cu",
                            "ftk_klt_fast_pyramid", _FAST_ARGTYPES)
    read_phase_clocks(lib, FAST_PHASES)
    _launch_pyramid("fast_phase_clocks", opts, ref_pyr, cur_pyr, ref_uv,
                    cur_uv, None, skip, lib=lib)
    torch.cuda.synchronize(ref_uv.device)
    return read_phase_clocks(lib, FAST_PHASES)


def fast_occupancy(opts: KltOptions) -> dict:
    """:func:`occupancy` of the FAST kernel at ``opts``' patch size."""
    need_card("fast_occupancy")
    return occupancy(load_klt_library(), "ftk_klt_fast_occupancy", opts)


def iter_phase_clocks(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                      status, skip) -> dict:
    """Where the DIRECT / INVERSE kernel's time goes on these CUDA inputs
    (``opts.method``): one launch of its build with phase clocks, then the
    shares of ``ITER_PHASES`` (:func:`read_phase_clocks`). A diagnostic:
    the launch is in no wrapper's count."""
    check(opts.method != KltMethod.FAST, "iter_phase_clocks",
          "DIRECT/INVERSE only")
    lib = bind_phase_clocks("ftk_klt_iter_phases", "klt_iter.cu",
                            "ftk_klt_iter_pyramid", _ITER_ARGTYPES)
    read_phase_clocks(lib, ITER_PHASES)
    _launch_pyramid("iter_phase_clocks", opts, ref_pyr, cur_pyr, ref_uv,
                    cur_uv, status, skip, lib=lib)
    torch.cuda.synchronize(ref_uv.device)
    return read_phase_clocks(lib, ITER_PHASES)


def iter_occupancy(opts: KltOptions) -> dict:
    """:func:`occupancy` of the DIRECT / INVERSE kernel that ``opts``
    launches."""
    return occupancy(load_klt_iter_library(), "ftk_klt_iter_occupancy", opts,
                     int(opts.method == KltMethod.INVERSE))


counts_launches(track_pyramid_fast_cuda, track_pyramid_iter_cuda)
