"""Sparse pyramidal Lucas-Kanade trackers.

  tracker = BasicKlt(KltOptions(...), device="cuda")
  cur_uv, status = tracker.track(ref_pyramid, cur_pyramid, ref_uv)

Semantics shared with the JAX package:
 - A missing/mismatched ``cur_uv`` prediction falls back to ``ref_uv``; a
   missing/mismatched ``status`` resets to NOT_TRACKED.
 - Features whose incoming status is > TRACKED are not re-tracked, and
   only the first ``max_track_points`` features are tracked; skipped
   features pass their input position and status through.
 - A final position outside the full-resolution image maps to OUTSIDE.

On CUDA tensors the whole pyramid runs through one launch of the CUDA
kernel (``ops/cuda_klt.py``); on CPU tensors through its plain PyTorch
version. FAST mode only: DIRECT/INVERSE and the affine and LSSD warps are
later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import fresh_status, is_failed
from feature_tracker_tpu_torch.ops.cuda_klt import track_pyramid_fast_cuda
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt.basic import require_fast
from feature_tracker_tpu_torch.trackers.klt.engine import final_outside_check

__all__ = ["BasicKlt", "KltOptions", "KltMethod"]


def _skip_mask(n: int, status, opts: KltOptions):
    return is_failed(status) | (
        torch.arange(n, device=status.device) >= opts.max_track_points)


def _basic_pyramid(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                   status):
    require_fast(opts)
    skip = _skip_mask(ref_uv.shape[0], status, opts)
    s_cur, st = track_pyramid_fast_cuda(opts, ref_pyr, cur_pyr, ref_uv,
                                        cur_uv, skip)
    st = final_outside_check(s_cur, st, tuple(cur_pyr[0].shape))
    out_uv = torch.where(skip[:, None], cur_uv, s_cur)
    out_st = torch.where(skip, status, st)
    return out_uv, out_st


class BasicKlt:
    """Translation-only pyramidal KLT (FAST mode)."""

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
                torch.int8)
        return ref_uv, cur_uv, status

    def track(self, ref_pyramid, cur_pyramid, ref_uv, cur_uv=None,
              status=None):
        """Track ``ref_uv [N, 2]`` from ``ref_pyramid`` into
        ``cur_pyramid`` (levels finest first). Returns ``(uv [N, 2]
        float32, status [N] int8)`` on the tracker's device."""
        ref_uv, cur_uv, status = self._prep(ref_uv, cur_uv, status)
        return _basic_pyramid(self.options,
                              tuple(self._f32(l) for l in ref_pyramid),
                              tuple(self._f32(l) for l in cur_pyramid),
                              ref_uv, cur_uv, status)

    def track_single_level(self, ref_image, cur_image, ref_uv, cur_uv=None,
                           status=None):
        """Track on one image pair (a one-level pyramid)."""
        return self.track((ref_image,), (cur_image,), ref_uv, cur_uv, status)

    def track_stream(self, frames, ref_uv, status=None, levels: int = 4):
        """Track features through a ``[T, H, W]`` frame stream: T-1
        chained pairs.

        Each pair's tracked positions become the next pair's reference
        positions and prediction; failed features stay skipped on later
        frames. Returns ``(uv [T-1, N, 2], status [T-1, N] int8)``, the
        state after each pair."""
        pyr = build_pyramid(frames, levels, device=self.device)
        uv, _, st = self._prep(ref_uv, None, status)
        n = uv.shape[0]
        uvs, sts = [], []
        for t in range(pyr[0].shape[0] - 1):
            uv, st = _basic_pyramid(self.options,
                                    tuple(p[t] for p in pyr),
                                    tuple(p[t + 1] for p in pyr),
                                    uv, uv, st)
            uvs.append(uv)
            sts.append(st)
        if not uvs:
            return (torch.empty((0, n, 2), device=self.device),
                    torch.empty((0, n), dtype=torch.int8,
                                device=self.device))
        return torch.stack(uvs), torch.stack(sts)
