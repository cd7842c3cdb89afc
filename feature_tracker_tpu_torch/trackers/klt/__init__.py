"""Sparse pyramidal Lucas-Kanade trackers (basic / affine / LSSD warps).

  tracker = BasicKlt(KltOptions(...), device="cuda")
  cur_uv, status = tracker.track(ref_pyramid, cur_pyramid, ref_uv)

Semantics shared with the JAX package:
 - A missing/mismatched ``cur_uv`` prediction falls back to ``ref_uv``; a
   missing/mismatched ``status`` resets to NOT_TRACKED.
 - Features whose incoming status is > TRACKED are not re-tracked, and
   only the first ``max_track_points`` features are tracked; skipped
   features pass their input position and status through.
 - A final position outside the full-resolution image maps to OUTSIDE.

On CUDA tensors the basic tracker runs the whole pyramid through one
launch of a CUDA kernel in every solver mode (``ops/cuda_klt.py``), and
the affine and LSSD trackers run the whole pyramid through one launch of
their FAST-mode kernels (``ops/cuda_warp_klt.py``); on CPU tensors each
takes its kernel's plain PyTorch version. The DIRECT / INVERSE modes of the
affine and LSSD trackers have no kernel in the JAX package either and are
plain PyTorch on both devices.
"""

from __future__ import annotations

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import fresh_status, is_failed
from feature_tracker_tpu_torch.ops.cuda_klt import (
    track_pyramid_fast_cuda,
    track_pyramid_iter_cuda,
)
from feature_tracker_tpu_torch.ops.cuda_warp_klt import (
    affine_track_pyramid_cuda,
    lssd_track_pyramid_cuda,
)
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt import affine as _affine
from feature_tracker_tpu_torch.trackers.klt import lssd as _lssd
from feature_tracker_tpu_torch.trackers.klt.engine import final_outside_check
from feature_tracker_tpu_torch.utils.profiling import span

__all__ = ["BasicKlt", "AffineKlt", "LssdKlt", "KltOptions", "KltMethod"]


def _skip_mask(n: int, status, opts: KltOptions):
    return is_failed(status) | (
        torch.arange(n, device=status.device) >= opts.max_track_points)


def _finish(skip, cur_uv, status, new_uv, new_status, image_shape):
    """The final outside check, then skipped lanes pass their inputs
    through."""
    new_status = final_outside_check(new_uv, new_status, tuple(image_shape))
    return (torch.where(skip[:, None], cur_uv, new_uv),
            torch.where(skip, status, new_status))


def basic_pyramid(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                   status):
    skip = _skip_mask(ref_uv.shape[0], status, opts)
    if opts.method == KltMethod.FAST:
        s_cur, st = track_pyramid_fast_cuda(opts, ref_pyr, cur_pyr, ref_uv,
                                            cur_uv, skip)
    else:
        s_cur, st = track_pyramid_iter_cuda(opts, ref_pyr, cur_pyr, ref_uv,
                                            cur_uv, status, skip)
    return _finish(skip, cur_uv, status, s_cur, st, cur_pyr[0].shape)


def affine_pyramid(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                    status, affine0=None, level_fn=None):
    """Affine tracker over a pyramid. ``affine0`` is None for the
    multi-level call (A starts at identity once per call and persists
    across levels) or the single-level call's ``predict_affine``.

    FAST mode goes through ``affine_track_pyramid_cuda``: one kernel launch
    for all levels on CUDA tensors, the plain level loop on CPU tensors.
    DIRECT / INVERSE, and any call that passes ``level_fn`` (a function
    that tracks one level: a check may pass the plain version in, or record
    what goes through), run the level loop here."""
    n = ref_uv.shape[0]
    skip = _skip_mask(n, status, opts)
    if affine0 is None:
        affine0 = torch.eye(2, dtype=torch.float32, device=ref_uv.device)
    aff = affine0.expand(n, 2, 2).contiguous()
    if level_fn is None and opts.method == KltMethod.FAST:
        s_cur, _, st = affine_track_pyramid_cuda(
            opts, ref_pyr, cur_pyr, ref_uv, cur_uv, aff, skip)
        return _finish(skip, cur_uv, status, s_cur, st, cur_pyr[0].shape)
    level_fn = level_fn or _affine.track_level
    scale = float(1 << (len(ref_pyr) - 1))
    s_ref = ref_uv / scale
    s_cur = cur_uv / scale
    st = status
    for lvl in range(len(ref_pyr) - 1, -1, -1):
        s_cur, aff, st = level_fn(
            opts, ref_pyr[lvl], cur_pyr[lvl], s_ref, s_cur, aff, st, skip)
        if lvl > 0:
            s_ref = s_ref * 2.0
            s_cur = s_cur * 2.0
    return _finish(skip, cur_uv, status, s_cur, st, cur_pyr[0].shape)


def lssd_pyramid(opts: KltOptions, luminance: bool, ref_pyr, cur_pyr,
                  ref_uv, cur_uv, status, predict_rot, level_fn=None):
    """SE(2) tracker over a pyramid: ``t = s_cur - R s_ref`` at the coarsest
    scale, only ``t`` doubles between levels, and the final position is
    ``R ref_uv + t`` at full resolution.

    FAST mode goes through ``lssd_track_pyramid_cuda``: one kernel launch
    for all levels on CUDA tensors, the plain level loop on CPU tensors.
    DIRECT / INVERSE, and any call that passes ``level_fn``, run the level
    loop here, as in :func:`affine_pyramid`."""
    n = ref_uv.shape[0]
    skip = _skip_mask(n, status, opts)
    rot = predict_rot.expand(n, 2, 2).contiguous()
    if level_fn is None and opts.method == KltMethod.FAST:
        out, _, st = lssd_track_pyramid_cuda(opts, luminance, ref_pyr,
                                             cur_pyr, ref_uv, cur_uv, rot,
                                             skip)
        return _finish(skip, cur_uv, status, out, st, cur_pyr[0].shape)
    level_fn = level_fn or _lssd.track_level
    scale = float(1 << (len(ref_pyr) - 1))
    s_ref = ref_uv / scale
    t = cur_uv / scale - _lssd.rotate_uv(rot, s_ref)
    st = status
    for lvl in range(len(ref_pyr) - 1, -1, -1):
        rot, t, st = level_fn(opts, luminance, ref_pyr[lvl], cur_pyr[lvl],
                              s_ref, rot, t, st, skip)
        if lvl > 0:
            s_ref = s_ref * 2.0
            t = t * 2.0
    out = _lssd.rotate_uv(rot, ref_uv) + t
    return _finish(skip, cur_uv, status, out, st, cur_pyr[0].shape)


class _KltBase:
    """Argument handling and the stream loop shared by the three
    trackers; a subclass supplies ``_pyramid``."""

    def __init__(self, options: KltOptions | None = None, device="cuda"):
        self.options = options or KltOptions()
        self.device = resolve_device(device)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).contiguous()

    def _prep(self, ref_uv, cur_uv, status):
        ref_uv = self._f32(ref_uv)
        n = ref_uv.shape[0]
        if cur_uv is None or np.shape(cur_uv) != (n, 2):
            cur_uv = ref_uv
        else:
            cur_uv = self._f32(cur_uv)
        if status is None or np.shape(status) != (n,):
            status = fresh_status(n, self.device)
        else:
            status = torch.as_tensor(status, device=self.device).to(
                torch.int8).contiguous()
        return ref_uv, cur_uv, status

    def _pyramid(self, ref_pyr, cur_pyr, ref_uv, cur_uv, status,
                 single_level: bool = False, stream: bool = False):
        raise NotImplementedError

    def track(self, ref_pyramid, cur_pyramid, ref_uv, cur_uv=None,
              status=None):
        """Track ``ref_uv [N, 2]`` from ``ref_pyramid`` into
        ``cur_pyramid`` (levels finest first). Returns ``(uv [N, 2]
        float32, status [N] int8)`` on the tracker's device."""
        with span("klt.track"):
            ref_uv, cur_uv, status = self._prep(ref_uv, cur_uv, status)
            return self._pyramid(tuple(self._f32(l) for l in ref_pyramid),
                                 tuple(self._f32(l) for l in cur_pyramid),
                                 ref_uv, cur_uv, status)

    def track_single_level(self, ref_image, cur_image, ref_uv, cur_uv=None,
                           status=None):
        """Track on one image pair (a one-level pyramid; the warp trackers
        start from their ``predict_affine`` / ``predict_rotation``)."""
        ref_uv, cur_uv, status = self._prep(ref_uv, cur_uv, status)
        return self._pyramid((self._f32(ref_image),), (self._f32(cur_image),),
                             ref_uv, cur_uv, status, single_level=True)

    def track_stream(self, frames, ref_uv, status=None, levels: int = 4):
        """Track features through a ``[T, H, W]`` frame stream: T-1
        chained pairs.

        Each pair's tracked positions become the next pair's reference
        positions and prediction; failed features stay skipped on later
        frames. The warp starts anew at every pair (affine and rotation at
        identity). Returns ``(uv [T-1, N, 2], status [T-1, N] int8)``, the
        state after each pair."""
        pyr = build_pyramid(frames, levels, device=self.device)
        uv, _, st = self._prep(ref_uv, None, status)
        n = uv.shape[0]
        uvs, sts = [], []
        for t in range(pyr[0].shape[0] - 1):
            uv, st = self._pyramid(tuple(p[t] for p in pyr),
                                   tuple(p[t + 1] for p in pyr),
                                   uv, uv, st, stream=True)
            uvs.append(uv)
            sts.append(st)
        if not uvs:
            return (torch.empty((0, n, 2), device=self.device),
                    torch.empty((0, n), dtype=torch.int8,
                                device=self.device))
        return torch.stack(uvs), torch.stack(sts)


class BasicKlt(_KltBase):
    """Translation-only pyramidal KLT."""

    def _pyramid(self, ref_pyr, cur_pyr, ref_uv, cur_uv, status,
                 single_level: bool = False, stream: bool = False):
        return basic_pyramid(self.options, ref_pyr, cur_pyr, ref_uv, cur_uv,
                              status)


class AffineKlt(_KltBase):
    """Affine-warp pyramidal KLT. ``predict_affine`` (2x2, identity by
    default) seeds single-level calls only."""

    def __init__(self, options: KltOptions | None = None, device="cuda"):
        super().__init__(options, device)
        self.predict_affine = np.eye(2, dtype=np.float32)

    def _pyramid(self, ref_pyr, cur_pyr, ref_uv, cur_uv, status,
                 single_level: bool = False, stream: bool = False):
        affine0 = self._f32(self.predict_affine) if single_level else None
        return affine_pyramid(self.options, ref_pyr, cur_pyr, ref_uv,
                               cur_uv, status, affine0)


class LssdKlt(_KltBase):
    """SE(2) pyramidal KLT with optional luminance normalisation.
    ``predict_rotation`` (2x2, identity by default) seeds ``track`` and
    ``track_single_level``; a stream starts every pair at identity."""

    def __init__(self, options: KltOptions | None = None,
                 consider_patch_luminance: bool = False, device="cuda"):
        super().__init__(options, device)
        self.consider_patch_luminance = consider_patch_luminance
        self.predict_rotation = np.eye(2, dtype=np.float32)

    def _pyramid(self, ref_pyr, cur_pyr, ref_uv, cur_uv, status,
                 single_level: bool = False, stream: bool = False):
        rot = (np.eye(2, dtype=np.float32) if stream
               else self.predict_rotation)
        return lssd_pyramid(self.options, self.consider_patch_luminance,
                             ref_pyr, cur_pyr, ref_uv, cur_uv, status,
                             self._f32(rot))
