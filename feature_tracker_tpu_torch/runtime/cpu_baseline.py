"""ctypes wrapper for the single-thread native CPU trackers
(``native/klt_cpu_baseline.cpp``).

Two jobs:
 - a measured single-thread CPU baseline;
 - the float32 ground truth for parity tests: the C++ loops implement the
   same break and status rules as the port's trackers, so tracked counts
   and end points agree to float tolerance.

The library is compiled at first use from ``native/`` with the flags of
``native/Makefile``, ``-ffp-contract=off`` included (FMA contraction would
change its sums from host to host), into ``feature_tracker_tpu_torch/
_build/`` (see ``runtime/native.py``). The functions take the port's option
classes, accept numpy arrays and tensors on any device, and return numpy.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import KltOptions
from feature_tracker_tpu_torch.runtime.native import host_library_path
from feature_tracker_tpu_torch.trackers.dense import DenseFlowOptions
from feature_tracker_tpu_torch.trackers.direct import DirectMethodOptions

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = host_library_path("ftk_klt_baseline", "klt_cpu_baseline.cpp",
                                 ("-ffp-contract=off",))
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        pf = ctypes.POINTER(ctypes.c_float)
        common = [
            ctypes.POINTER(pf), ctypes.POINTER(pf),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            pf, pf, ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
        ]
        lib.ftk_klt_fast_pyramid.restype = ctypes.c_int
        lib.ftk_klt_fast_pyramid.argtypes = common
        lib.ftk_klt_affine_fast_pyramid.restype = ctypes.c_int
        lib.ftk_klt_affine_fast_pyramid.argtypes = common
        lib.ftk_klt_lssd_fast_pyramid.restype = ctypes.c_int
        lib.ftk_klt_lssd_fast_pyramid.argtypes = common + [ctypes.c_int]
        lib.ftk_direct_method_pyramid.restype = ctypes.c_int
        lib.ftk_direct_method_pyramid.argtypes = [
            ctypes.POINTER(pf), ctypes.POINTER(pf),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            pf, pf, pf, pf, pf, pf,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
        ]
        lib.ftk_farneback_pyramid.restype = ctypes.c_int
        lib.ftk_farneback_pyramid.argtypes = [
            ctypes.POINTER(pf), ctypes.POINTER(pf),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            pf, pf,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native CPU baseline library could not be "
                           "built (needs g++)")
    return lib


def _host(x, dtype=np.float32) -> np.ndarray:
    """A C-contiguous numpy copy of an array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype)


class _Pyramids:
    """Both pyramids as contiguous float32 numpy levels, and the pointer
    and shape arrays the C functions take (the levels stay referenced for
    as long as this object lives)."""

    def __init__(self, ref_pyramid, cur_pyramid):
        pf = ctypes.POINTER(ctypes.c_float)
        self.refs = [_host(im) for im in ref_pyramid]
        self.curs = [_host(im) for im in cur_pyramid]
        self.levels = levels = len(self.refs)
        self.ref_ptrs = (pf * levels)(*[im.ctypes.data_as(pf)
                                        for im in self.refs])
        self.cur_ptrs = (pf * levels)(*[im.ctypes.data_as(pf)
                                        for im in self.curs])
        self.hs = (ctypes.c_int * levels)(*[im.shape[0] for im in self.refs])
        self.ws = (ctypes.c_int * levels)(*[im.shape[1] for im in self.refs])

    def args(self):
        return self.ref_ptrs, self.cur_ptrs, self.hs, self.ws, self.levels


def _ptr(a, ctype=ctypes.c_float):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _run_fast(fn_name, ref_pyramid, cur_pyramid, ref_uv, cur_uv, status,
              opts, extra=()):
    opts = opts or KltOptions()
    lib = _library()
    pyr = _Pyramids(ref_pyramid, cur_pyramid)
    ref_uv = _host(ref_uv)
    n = ref_uv.shape[0]
    out_uv = (_host(cur_uv).copy() if cur_uv is not None
              and np.shape(cur_uv) == (n, 2) else ref_uv.copy())
    out_st = (_host(status, np.int8).copy() if status is not None
              and np.shape(status) == (n,) else np.zeros(n, np.int8))
    rc = getattr(lib, fn_name)(
        *pyr.args(), _ptr(ref_uv), _ptr(out_uv), _ptr(out_st, ctypes.c_int8),
        n, opts.max_track_points,
        opts.patch_row_half_size, opts.patch_col_half_size,
        opts.max_iterations, opts.max_tolerance_large_step,
        opts.max_converge_step, *extra)
    if rc != 0:
        raise ValueError(
            f"{fn_name}: unsupported config (patch side > 62, "
            f"levels outside 1..16) - rc={rc}")
    return out_uv, out_st


def klt_fast_cpu(ref_pyramid, cur_pyramid, ref_uv, cur_uv=None, status=None,
                 opts=None):
    """Single-thread CPU basic KLT, FAST, over a pyramid (level 0 =
    finest). ``BasicKlt.track``'s contract: (cur_uv [N, 2] float32,
    status [N] int8)."""
    return _run_fast("ftk_klt_fast_pyramid", ref_pyramid, cur_pyramid,
                     ref_uv, cur_uv, status, opts)


def klt_affine_fast_cpu(ref_pyramid, cur_pyramid, ref_uv, cur_uv=None,
                        status=None, opts=None):
    """Affine KLT, FAST, ground truth (``AffineKlt.track``'s contract)."""
    return _run_fast("ftk_klt_affine_fast_pyramid", ref_pyramid,
                     cur_pyramid, ref_uv, cur_uv, status, opts)


def klt_lssd_fast_cpu(ref_pyramid, cur_pyramid, ref_uv, cur_uv=None,
                      status=None, opts=None, luminance=False):
    """SE(2) / LSSD KLT, FAST, ground truth (``LssdKlt.track``'s
    contract)."""
    return _run_fast("ftk_klt_lssd_fast_pyramid", ref_pyramid, cur_pyramid,
                     ref_uv, cur_uv, status, opts,
                     extra=(int(luminance),))


def direct_method_cpu(ref_pyramid, cur_pyramid, k4, p_c_in_ref, ref_uv,
                      q_rc=None, p_rc=None, opts=None):
    """Direct method (DIRECT mode) pose ground truth; ``DirectMethod.
    track``'s contract: (cur_uv, q_rc, p_rc, status)."""
    opts = opts or DirectMethodOptions()
    lib = _library()
    pyr = _Pyramids(ref_pyramid, cur_pyramid)
    ref_uv = _host(ref_uv)
    p_ref = _host(p_c_in_ref)
    k4 = _host(k4)
    n = ref_uv.shape[0]
    out_uv = ref_uv.copy()
    q = _host(q_rc if q_rc is not None else [1, 0, 0, 0]).copy()
    p = _host(p_rc if p_rc is not None else [0, 0, 0]).copy()
    st = np.zeros(n, np.int8)
    rc = lib.ftk_direct_method_pyramid(
        *pyr.args(), _ptr(k4), _ptr(p_ref), _ptr(ref_uv), _ptr(out_uv),
        _ptr(q), _ptr(p), _ptr(st, ctypes.c_int8),
        n, opts.max_track_points,
        opts.patch_row_half_size, opts.patch_col_half_size,
        opts.max_iterations, opts.max_converge_step)
    if rc != 0:
        raise ValueError(
            "ftk_direct_method_pyramid: unsupported config (patch side "
            f"> 64, n > 4096, levels outside 1..16) - rc={rc}")
    return out_uv, q, p, st


def farneback_cpu(ref_pyramid, cur_pyramid, opts=None):
    """Single-thread CPU dense Farnebäck flow over a pyramid (level 0 =
    finest). ``DenseOpticalFlow.track``'s contract: flow [2, H, W]
    (channel 0 = row flow, 1 = column flow)."""
    opts = opts or DenseFlowOptions()
    lib = _library()
    pyr = _Pyramids(ref_pyramid, cur_pyramid)
    h, w = pyr.refs[0].shape
    out_r = np.zeros((h, w), np.float32)
    out_c = np.zeros((h, w), np.float32)
    rc = lib.ftk_farneback_pyramid(
        *pyr.args(), opts.half_patch_size, opts.max_iterations,
        opts.max_converge_step, opts.max_delta_flow_step,
        _ptr(out_r), _ptr(out_c))
    if rc != 0:
        raise ValueError(
            f"ftk_farneback_pyramid: unsupported config - rc={rc}")
    return np.stack([out_r, out_c])
