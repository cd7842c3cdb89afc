"""Translation-only pyramidal KLT in plain PyTorch, all three solver modes.

These are the plain versions of the CUDA kernels in ``ops/cuda_klt.py``:
the JAX package's per-feature ``_fast_one`` and ``_iterative_one`` written
out as batches over features. They run the CPU path of :class:`BasicKlt`
and are what the kernels are held against on the card.

FAST mode, per feature and level (the JAX package's semantics):
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

DIRECT / INVERSE mode, per feature and level:
 - H and b are rebuilt every step. The gradients come from the reference
   image at ``ref_uv`` (INVERSE, fixed per level) or from the current image
   at the current position (DIRECT); the four +-1 shifts share the anchor's
   fraction, so one constant-weight window yields them and the centre,
 - a pixel counts when all four gradient taps, the reference tap and the
   current tap are valid,
 - the incoming status is kept (also from level to level): a feature that
   never converges leaves with the status it came in with. No divergence
   counter; after each update an OUTSIDE break on the updated position
   against that level's ``w-1`` / ``h-1``.
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


def patch_offsets(opts: KltOptions, device):
    """``(dcol [pr, pc], drow [pr, pc])`` float32 offsets of the patch's
    pixels from its centre, row-major (the row varies slowest)."""
    dr = torch.arange(-opts.patch_row_half_size, opts.patch_row_half_size + 1,
                      dtype=torch.float32, device=device)
    dc = torch.arange(-opts.patch_col_half_size, opts.patch_col_half_size + 1,
                      dtype=torch.float32, device=device)
    drr, dcc = torch.meshgrid(dr, dc, indexing="ij")
    return dcc, drr


def _weighted_taps(block, weights, rows: int, cols: int, r0: int = 0,
                   c0: int = 0):
    """Constant-weight bilinear combination of the 4 tap views of the
    sub-region of ``[N, win, win]`` blocks starting at ``(r0, c0)``;
    weights are ``[N]`` each."""
    w_tl, w_tr, w_bl, w_br = (w[:, None, None] for w in weights)
    return (w_tl * block[:, r0:r0 + rows, c0:c0 + cols]
            + w_tr * block[:, r0:r0 + rows, c0 + 1:c0 + cols + 1]
            + w_bl * block[:, r0 + 1:r0 + rows + 1, c0:c0 + cols]
            + w_br * block[:, r0 + 1:r0 + rows + 1, c0 + 1:c0 + cols + 1])


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


def _iterative_level(opts: KltOptions, img_shape, ref_pad, cur_pad, pad: int,
                     ref_uv, cur_uv0, status_in):
    """DIRECT / INVERSE mode for a batch of features at one level.

    Returns ``(uv [N, 2], status [N] int8, steps [N] int32)``."""
    pr, pc = opts.patch_rows, opts.patch_cols
    h, w = img_shape
    win = max(pr, pc) + 3  # patch + 1px gradient border + 1 bilinear tap
    inverse = opts.method == KltMethod.INVERSE
    outside_status = torch.tensor(int(TrackStatus.OUTSIDE), dtype=torch.int8,
                                  device=ref_uv.device)

    def load(padded, uv):
        r0, c0, wts = const_weights(uv)
        min_r = r0 - pr // 2
        min_c = c0 - pc // 2
        block = slice_window(padded, pad, min_r - 1, min_c - 1, win)
        return block, wts, min_r, min_c

    def shifted(loaded, dr, dc):
        block, wts, _, _ = loaded
        return _weighted_taps(block, wts, pr, pc, 1 + dr, 1 + dc)

    def validity(loaded, dr, dc):
        _, _, min_r, min_c = loaded
        return tap_validity(img_shape, min_r + dr, min_c + dc, pr, pc)

    ref_loaded = load(ref_pad, ref_uv)
    refv = shifted(ref_loaded, 0, 0)
    ref_valid = validity(ref_loaded, 0, 0)

    def gradients(loaded):
        fx = shifted(loaded, 0, 1) - shifted(loaded, 0, -1)
        fy = shifted(loaded, 1, 0) - shifted(loaded, -1, 0)
        ok = (validity(loaded, 0, -1) & validity(loaded, 0, 1)
              & validity(loaded, -1, 0) & validity(loaded, 1, 0))
        return fx, fy, ok

    if inverse:  # gradients fixed per level
        ref_grads = gradients(ref_loaded)

    def step(cur_uv):
        cur_loaded = load(cur_pad, cur_uv)
        gx, gy, gok = ref_grads if inverse else gradients(cur_loaded)
        curv = shifted(cur_loaded, 0, 0)
        valid = gok & ref_valid & validity(cur_loaded, 0, 0)
        fx = torch.where(valid, gx, 0.0)
        fy = torch.where(valid, gy, 0.0)
        ft = torch.where(valid, curv - refv, 0.0)
        h00 = (fx * fx).sum(dim=(1, 2))
        h01 = (fx * fy).sum(dim=(1, 2))
        h11 = (fy * fy).sum(dim=(1, 2))
        b0 = -(fx * ft).sum(dim=(1, 2))
        b1 = -(fy * ft).sum(dim=(1, 2))
        v = solve2x2(h00, h01, h11, b0, b1)
        new_uv = cur_uv + v
        outside = ((new_uv[:, 0] < 0) | (new_uv[:, 0] > w - 1)
                   | (new_uv[:, 1] < 0) | (new_uv[:, 1] > h - 1))
        brk = torch.where(outside, outside_status, 0)
        return StepResult(valid.sum(dim=(1, 2)), v, new_uv, brk)

    done0 = torch.zeros(ref_uv.shape[0], dtype=torch.bool,
                        device=ref_uv.device)
    return run_klt_iterations(step, cur_uv0, status_in, done0, opts,
                              divergence_counter=False)


def track_level(opts: KltOptions, ref_img, cur_img, ref_uv, cur_uv, status):
    """Tracking of a batch of features at one level, in plain PyTorch.

    FAST mode rewrites ``status`` unconditionally; DIRECT / INVERSE keep
    it until a break rule sets another. Returns ``(uv [N, 2], status [N]
    int8)``."""
    pad = max(opts.ex_patch_rows, opts.ex_patch_cols) + 3
    args = (opts, tuple(ref_img.shape), pad_image(ref_img, pad),
            pad_image(cur_img, pad), pad, ref_uv, cur_uv)
    if opts.method == KltMethod.FAST:
        uv, st, _ = _fast_level(*args)
    else:
        uv, st, _ = _iterative_level(*args, status.to(torch.int8))
    return uv, st


def _pyramid_reference(opts: KltOptions, ref_pyr, cur_pyr, ref_uv, cur_uv,
                       status):
    """Coarse-to-fine level loop shared by the two plain versions.
    ``status`` is None in FAST mode. Returns ``(uv, status, steps)`` at
    full resolution."""
    levels = len(ref_pyr)
    scale = float(1 << (levels - 1))
    s_ref = ref_uv / scale
    s_cur = cur_uv / scale
    pad = max(opts.ex_patch_rows, opts.ex_patch_cols) + 3
    steps = torch.zeros(ref_uv.shape[0], dtype=torch.int32,
                        device=ref_uv.device)
    st = status
    for lvl in range(levels - 1, -1, -1):
        ref_img, cur_img = ref_pyr[lvl], cur_pyr[lvl]
        args = (opts, tuple(ref_img.shape), pad_image(ref_img, pad),
                pad_image(cur_img, pad), pad, s_ref, s_cur)
        if status is None:
            s_cur, st, lvl_steps = _fast_level(*args)
        else:
            s_cur, st, lvl_steps = _iterative_level(*args, st)
        steps += lvl_steps
        if lvl > 0:
            s_ref = s_ref * 2.0
            s_cur = s_cur * 2.0
    return s_cur, st, steps


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
    if opts.method != KltMethod.FAST:
        raise ValueError("track_pyramid_fast_reference is FAST mode; "
                         "DIRECT/INVERSE is track_pyramid_iter_reference")
    s_cur, st, steps = _pyramid_reference(opts, ref_pyr, cur_pyr, ref_uv,
                                          cur_uv, None)
    uv = torch.where(skip[:, None], cur_uv, s_cur)
    st = torch.where(skip, int(TrackStatus.NOT_TRACKED), st)
    if with_steps:
        return uv, st, torch.where(skip, 0, steps)
    return uv, st


def track_pyramid_iter_reference(opts: KltOptions, ref_pyr, cur_pyr, ref_uv,
                                 cur_uv, status, skip,
                                 with_steps: bool = False):
    """Whole-pyramid DIRECT / INVERSE tracking, coarse to fine, in plain
    PyTorch: the plain version of ``ops.cuda_klt.track_pyramid_iter_cuda``.

    Arguments as :func:`track_pyramid_fast_reference`, plus ``status``
    ``[N]`` int8: the incoming status, kept from level to level until a
    break rule sets another. Skipped lanes return ``cur_uv`` and their
    incoming status; the final outside check is the caller's."""
    if opts.method == KltMethod.FAST:
        raise ValueError("track_pyramid_iter_reference is DIRECT/INVERSE; "
                         "FAST mode is track_pyramid_fast_reference")
    status = status.to(torch.int8)
    s_cur, st, steps = _pyramid_reference(opts, ref_pyr, cur_pyr, ref_uv,
                                          cur_uv, status)
    uv = torch.where(skip[:, None], cur_uv, s_cur)
    st = torch.where(skip, status, st)
    if with_steps:
        return uv, st, torch.where(skip, 0, steps)
    return uv, st
