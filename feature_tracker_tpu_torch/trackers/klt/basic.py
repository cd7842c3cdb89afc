"""Translation-only pyramidal KLT, FAST mode, in plain PyTorch.

This is the plain version of the CUDA kernel in ``ops/cuda_klt.py``: the
JAX package's per-feature ``_fast_one`` written out as a batch over
features. It runs the CPU path of :class:`BasicKlt` and is what the kernel
is held against on the card.

Per feature and level (the JAX package's semantics):
 - sample the extended ``(pr+2, pc+2)`` reference patch with one anchor and
   four constant bilinear weights; taps whose anchor leaves ``[0, dim-2]``
   are invalid and read 0,
 - central-difference gradients over the inner patch, masked by the AND of
   the four neighbours' validity, and the constant 2x2 H,
 - OUTSIDE if the extended patch has no valid tap, else LARGE_RESIDUAL,
 - up to ``max_iterations`` Gauss-Newton steps (engine.py's break rules),
   each resampling the current patch and solving H v = b with
   ``b = -sum(grad * (cur - inner))`` over the jointly valid pixels.
The status is rewritten at every level; only level 0's survives.
"""

from __future__ import annotations

import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.ops.solve import solve2x2
from feature_tracker_tpu_torch.ops.window import (
    const_weights,
    pad_image,
    slice_window,
    tap_validity,
)
from feature_tracker_tpu_torch.trackers.klt.engine import (
    StepResult,
    run_klt_iterations,
)


def require_fast(opts: KltOptions) -> None:
    """The port covers FAST mode; DIRECT/INVERSE come with the next slice."""
    if opts.method != KltMethod.FAST:
        raise NotImplementedError(
            f"KltMethod.{opts.method.name} is not ported yet: the "
            "DIRECT/INVERSE basic KLT (the per-iteration H/b rebuild, "
            "_iterative_one, and its kernel track_pyramid_iter_pallas) is "
            "the next slice of the port. Use KltMethod.FAST.")


def _weighted_taps(block, weights, rows: int, cols: int):
    """Constant-weight bilinear combination of the 4 tap views of
    ``[N, win, win]`` blocks; weights are ``[N]`` each."""
    w_tl, w_tr, w_bl, w_br = (w[:, None, None] for w in weights)
    return (w_tl * block[:, 0:rows, 0:cols]
            + w_tr * block[:, 0:rows, 1:cols + 1]
            + w_bl * block[:, 1:rows + 1, 0:cols]
            + w_br * block[:, 1:rows + 1, 1:cols + 1])


def _fast_level(opts: KltOptions, img_shape, ref_pad, cur_pad, pad: int,
                ref_uv, cur_uv0):
    """FAST mode for a batch of features at one level.

    Returns ``(uv [N, 2], status [N] int8, steps [N] int32)``."""
    epr, epc = opts.ex_patch_rows, opts.ex_patch_cols
    pr, pc = opts.patch_rows, opts.patch_cols
    n = ref_uv.shape[0]
    dev = ref_uv.device

    r0, c0, wts = const_weights(ref_uv)
    min_r = r0 - epr // 2
    min_c = c0 - epc // 2
    block = slice_window(ref_pad, pad, min_r, min_c, max(epr, epc) + 1)
    ex_valid = tap_validity(img_shape, min_r, min_c, epr, epc)
    ex_patch = torch.where(ex_valid, _weighted_taps(block, wts, epr, epc),
                           0.0)
    n_valid_ref = ex_valid.sum(dim=(1, 2))

    gvalid = (ex_valid[:, 1:-1, :-2] & ex_valid[:, 1:-1, 2:]
              & ex_valid[:, :-2, 1:-1] & ex_valid[:, 2:, 1:-1])
    dx = torch.where(gvalid,
                     ex_patch[:, 1:-1, 2:] - ex_patch[:, 1:-1, :-2], 0.0)
    dy = torch.where(gvalid,
                     ex_patch[:, 2:, 1:-1] - ex_patch[:, :-2, 1:-1], 0.0)
    h00 = (dx * dx).sum(dim=(1, 2))
    h01 = (dx * dy).sum(dim=(1, 2))
    h11 = (dy * dy).sum(dim=(1, 2))
    inner_patch = ex_patch[:, 1:-1, 1:-1]
    inner_valid = ex_valid[:, 1:-1, 1:-1]

    no_pixels = n_valid_ref == 0
    status0 = torch.where(no_pixels, int(TrackStatus.OUTSIDE),
                          int(TrackStatus.LARGE_RESIDUAL)).to(torch.int8)
    no_break = torch.zeros((n,), dtype=torch.int8, device=dev)

    def step(cur_uv):
        cr0, cc0, cwts = const_weights(cur_uv)
        cmin_r = cr0 - pr // 2
        cmin_c = cc0 - pc // 2
        cblock = slice_window(cur_pad, pad, cmin_r, cmin_c, max(pr, pc) + 1)
        cvalid = tap_validity(img_shape, cmin_r, cmin_c, pr, pc)
        cur_patch = _weighted_taps(cblock, cwts, pr, pc)
        valid = cvalid & inner_valid
        dt = torch.where(valid, cur_patch - inner_patch, 0.0)
        b0 = -(dx * dt).sum(dim=(1, 2))
        b1 = -(dy * dt).sum(dim=(1, 2))
        v = solve2x2(h00, h01, h11, b0, b1)
        return StepResult(valid.sum(dim=(1, 2)), v, cur_uv + v, no_break)

    return run_klt_iterations(step, cur_uv0, status0, no_pixels, opts,
                              divergence_counter=True)


def track_level(opts: KltOptions, ref_img, cur_img, ref_uv, cur_uv, status):
    """FAST-mode tracking of a batch of features at one level.

    ``status`` is accepted for the JAX package's signature; fast mode
    rewrites it unconditionally. Returns ``(uv [N, 2], status [N] int8)``."""
    require_fast(opts)
    del status
    pad = max(opts.ex_patch_rows, opts.ex_patch_cols) + 3
    uv, st, _ = _fast_level(opts, tuple(ref_img.shape),
                            pad_image(ref_img, pad), pad_image(cur_img, pad),
                            pad, ref_uv, cur_uv)
    return uv, st


def track_pyramid_fast_reference(opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                                 cur_uv, skip, with_steps: bool = False):
    """Whole-pyramid FAST-mode tracking, coarse to fine, in plain PyTorch:
    the plain version of ``ops.cuda_klt.track_pyramid_fast_cuda``.

    Args:
      ref_pyr, cur_pyr: sequences of ``[H_l, W_l]`` float32 levels, finest
        first.
      ref_uv, cur_uv: ``[N, 2]`` float32 full-resolution positions.
      skip: ``[N]`` bool; skipped features are not tracked.
      with_steps: also return ``[N]`` int32, the Gauss-Newton steps each
        feature took over all levels (the work the kernel does).

    Returns ``(uv [N, 2], status [N] int8)`` (plus ``steps``). Skipped
    lanes return ``cur_uv`` and NOT_TRACKED; the final outside check and
    the skip pass-through of the input status are the caller's."""
    require_fast(opts)
    levels = len(ref_pyr)
    scale = float(1 << (levels - 1))
    s_ref = ref_uv / scale
    s_cur = cur_uv / scale
    pad = max(opts.ex_patch_rows, opts.ex_patch_cols) + 3
    steps = torch.zeros(ref_uv.shape[0], dtype=torch.int32,
                        device=ref_uv.device)
    for lvl in range(levels - 1, -1, -1):
        ref_img, cur_img = ref_pyr[lvl], cur_pyr[lvl]
        s_cur, st, lvl_steps = _fast_level(
            opts, tuple(ref_img.shape), pad_image(ref_img, pad),
            pad_image(cur_img, pad), pad, s_ref, s_cur)
        steps += lvl_steps
        if lvl > 0:
            s_ref = s_ref * 2.0
            s_cur = s_cur * 2.0
    uv = torch.where(skip[:, None], cur_uv, s_cur)
    st = torch.where(skip, int(TrackStatus.NOT_TRACKED), st)
    if with_steps:
        return uv, st, torch.where(skip, 0, steps)
    return uv, st
