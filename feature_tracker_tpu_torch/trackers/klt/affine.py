"""Affine-warp pyramidal KLT in plain PyTorch, batched over features.

Warp model: ``pos_cur = A @ (dcol, drow) + cur_uv`` with a per-feature 2x2
affine ``A``; the Gauss-Newton state is z in R^6 (the columns of dA
stacked, then dt).

 - FAST mode: H (6x6, ``J = [x0 dx, x0 dy, y0 dx, y0 dy, dx, dy]`` with
   ``x0, y0`` = patch offset + the level-entry ``cur_uv``) is summed once
   per level from the reference patch's gradients; the bias is rebuilt
   every step at the warped absolute positions. The status is rewritten at
   every level. :func:`affine_track_level_reference` and the level loop
   over it, :func:`affine_track_pyramid_reference`, are the plain versions
   of the CUDA kernel behind ``ops.cuda_warp_klt.affine_track_level_cuda``
   and ``affine_track_pyramid_cuda``.
 - DIRECT / INVERSE: H and b rebuilt every step from per-pixel bilinear
   samples, the incoming status kept, an OUTSIDE break on the updated
   position. The JAX package has no TPU kernel for these modes; here they
   are plain PyTorch on either device.
 - Position update ``v = z[0:2] * x + z[2:4] * y + z[4:6]`` at the
   feature's position, and the columns of ``A`` grow by ``z[0:2]`` and
   ``z[2:4]``; convergence is checked on ``v``, not ``z``.

Samples are taken wherever the warp leads (no window limit), and H is the
consistent ``sum(J J^T)``, both as in the JAX package's jnp path. The
per-pixel arithmetic is float32 as there; the sums of H and b and the
solve are float64 (``ops/solve.py`` says why), as in the CUDA kernel.
"""

from __future__ import annotations

import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.ops.interp import (
    bilinear_sample,
    extract_const_weight_patch,
    inner_gradients,
)
from feature_tracker_tpu_torch.ops.solve import (
    gram,
    normal_equations,
    solve_sym,
)
from feature_tracker_tpu_torch.trackers.klt.basic import patch_offsets
from feature_tracker_tpu_torch.trackers.klt.engine import (
    StepResult,
    run_klt_iterations,
)


def _solve_and_update(z_h, z_b, cur_uv, affine):
    """Solve the 6x6 systems and apply the update rule."""
    z = solve_sym(z_h, z_b)
    v = (z[:, 0:2] * cur_uv[:, 0:1] + z[:, 2:4] * cur_uv[:, 1:2]
         + z[:, 4:6])
    new_uv = cur_uv + v
    new_affine = affine + torch.stack([z[:, 0:2], z[:, 2:4]], dim=-1)
    return v, new_uv, new_affine


def _warp(offsets, affine, cur_uv):
    """``A @ offset + cur_uv`` per pixel: ``[N, P, 2]``."""
    ox, oy = offsets
    wx = ox * affine[:, 0, 0:1] + oy * affine[:, 0, 1:2] + cur_uv[:, 0:1]
    wy = ox * affine[:, 1, 0:1] + oy * affine[:, 1, 1:2] + cur_uv[:, 1:2]
    return torch.stack([wx, wy], dim=-1)


def flat_offsets(opts: KltOptions, device):
    dcc, drr = patch_offsets(opts, device)
    return dcc.reshape(1, -1), drr.reshape(1, -1)


def reference_setup(opts: KltOptions, ref_img, ref_uv):
    """What FAST mode takes from the reference image per level, shared by
    the affine and SE(2) trackers: ``(dx, dy, inner_patch, inner_valid)``
    flattened to ``[N, P]``, and ``n_valid_ref [N]``."""
    ex_patch, ex_valid = extract_const_weight_patch(
        ref_img, ref_uv, opts.ex_patch_rows, opts.ex_patch_cols)
    n = ref_uv.shape[0]
    dx, dy = inner_gradients(ex_patch, ex_valid)
    return (dx.flatten(1), dy.flatten(1),
            ex_patch[:, 1:-1, 1:-1].flatten(1),
            ex_valid[:, 1:-1, 1:-1].flatten(1),
            ex_valid.sum(dim=(1, 2)))


def fast_initial_status(n_valid_ref):
    """FAST mode's status before the first step: OUTSIDE (and done) when
    the extended reference patch has no valid tap, else LARGE_RESIDUAL."""
    no_pixels = n_valid_ref == 0
    status0 = torch.where(no_pixels, int(TrackStatus.OUTSIDE),
                          int(TrackStatus.LARGE_RESIDUAL)).to(torch.int8)
    return no_pixels, status0


def no_break_status(n: int, device):
    return torch.zeros((n,), dtype=torch.int8, device=device)


def affine_track_level_reference(opts: KltOptions, ref_img, cur_img, ref_uv,
                                 cur_uv, affine, skip,
                                 with_steps: bool = False):
    """FAST-mode affine KLT at one level, in plain PyTorch.

    Args:
      ref_img, cur_img: ``[H, W]`` float32.
      ref_uv, cur_uv: ``[N, 2]`` float32 positions at this level.
      affine: ``[N, 2, 2]`` float32.
      skip: ``[N]`` bool; skipped lanes return ``cur_uv``,
        ``affine`` and NOT_TRACKED.
      with_steps: also return ``[N]`` int32, the steps each feature took.

    Returns ``(uv [N, 2], affine [N, 2, 2], status [N] int8)``."""
    n = ref_uv.shape[0]
    dev = ref_uv.device
    dx, dy, inner_patch, inner_valid, n_valid_ref = reference_setup(
        opts, ref_img, ref_uv)
    offsets = flat_offsets(opts, dev)
    x0 = offsets[0] + cur_uv[:, 0:1]
    y0 = offsets[1] + cur_uv[:, 1:2]
    j6 = torch.stack([x0 * dx, x0 * dy, y0 * dx, y0 * dy, dx, dy], dim=-1)
    hess = gram(j6)
    no_pixels, status0 = fast_initial_status(n_valid_ref)
    no_pixels = no_pixels | skip
    no_break = no_break_status(n, dev)

    def step(state):
        uv, aff = state
        warped = _warp(offsets, aff, uv)
        curv, okcur = bilinear_sample(cur_img, warped)
        valid = okcur & inner_valid
        dt = torch.where(valid, curv - inner_patch, 0.0)
        xw = torch.where(valid, warped[..., 0], 0.0)
        yw = torch.where(valid, warped[..., 1], 0.0)
        b = -torch.stack([dt * xw * dx, dt * xw * dy, dt * yw * dx,
                          dt * yw * dy, dt * dx, dt * dy],
                         dim=-1).double().sum(1)
        v, new_uv, new_aff = _solve_and_update(hess, b, uv, aff)
        return StepResult(valid.sum(1), v, (new_uv, new_aff), no_break)

    (uv, aff), status, steps = run_klt_iterations(
        step, (cur_uv, affine), status0, no_pixels, opts,
        divergence_counter=True)
    status = torch.where(skip, int(TrackStatus.NOT_TRACKED), status)
    if with_steps:
        return uv, aff, status, steps
    return uv, aff, status


def affine_track_pyramid_reference(opts: KltOptions, ref_pyr, cur_pyr,
                                   ref_uv, cur_uv, affine, skip,
                                   with_steps: bool = False):
    """FAST-mode affine KLT over a whole pyramid, in plain PyTorch: the
    level loop over :func:`affine_track_level_reference`.

    Args:
      ref_pyr, cur_pyr: sequences of ``[H_l, W_l]`` float32 levels, finest
        first.
      ref_uv, cur_uv: ``[N, 2]`` float32 full-resolution positions.
      affine: ``[N, 2, 2]`` float32, carried from level to level.
      skip: ``[N]`` bool.
      with_steps: also return ``[N]`` int32, the steps each feature took
        over all levels.

    Returns ``(uv [N, 2] at full resolution, affine [N, 2, 2], status [N]
    int8 of the finest level)``."""
    scale = float(1 << (len(ref_pyr) - 1))
    s_ref = ref_uv / scale
    s_cur = cur_uv / scale
    steps = 0
    for lvl in range(len(ref_pyr) - 1, -1, -1):
        s_cur, affine, status, lvl_steps = affine_track_level_reference(
            opts, ref_pyr[lvl], cur_pyr[lvl], s_ref, s_cur, affine, skip,
            with_steps=True)
        steps = steps + lvl_steps
        if lvl > 0:
            s_ref = s_ref * 2.0
            s_cur = s_cur * 2.0
    if with_steps:
        return s_cur, affine, status, steps
    return s_cur, affine, status


def _iterative_level(opts: KltOptions, ref_img, cur_img, ref_uv, cur_uv,
                     affine, status_in, done0):
    """DIRECT / INVERSE affine KLT at one level (no TPU kernel exists for
    it; plain PyTorch on either device)."""
    dev = ref_uv.device
    offsets = flat_offsets(opts, dev)
    h, w = cur_img.shape
    ex = torch.tensor([1.0, 0.0], dtype=torch.float32, device=dev)
    ey = torch.tensor([0.0, 1.0], dtype=torch.float32, device=dev)
    outside_status = torch.tensor(int(TrackStatus.OUTSIDE), dtype=torch.int8,
                                  device=dev)
    p_ref = torch.stack([ref_uv[:, 0:1] + offsets[0],
                         ref_uv[:, 1:2] + offsets[1]], dim=-1)
    refv, okref = bilinear_sample(ref_img, p_ref)

    def step(state):
        uv, aff = state
        warped = _warp(offsets, aff, uv)
        if opts.method == KltMethod.DIRECT:
            g_img, g_pos = cur_img, warped
        else:
            g_img, g_pos = ref_img, p_ref
        vl, okl = bilinear_sample(g_img, g_pos - ex)
        vr, okr = bilinear_sample(g_img, g_pos + ex)
        vt, okt = bilinear_sample(g_img, g_pos - ey)
        vb, okb = bilinear_sample(g_img, g_pos + ey)
        curv, okcur = bilinear_sample(cur_img, warped)
        valid = okl & okr & okt & okb & okref & okcur
        dx = torch.where(valid, vr - vl, 0.0)
        dy = torch.where(valid, vb - vt, 0.0)
        dt = torch.where(valid, curv - refv, 0.0)
        xw = torch.where(valid, warped[..., 0], 0.0)
        yw = torch.where(valid, warped[..., 1], 0.0)
        j6 = torch.stack([xw * dx, xw * dy, yw * dx, yw * dy, dx, dy],
                         dim=-1)
        hess, b = normal_equations(j6, dt)
        v, new_uv, new_aff = _solve_and_update(hess, b, uv, aff)
        outside = ((new_uv[:, 0] < 0) | (new_uv[:, 0] > w - 1)
                   | (new_uv[:, 1] < 0) | (new_uv[:, 1] > h - 1))
        brk = torch.where(outside, outside_status, 0)
        return StepResult(valid.sum(1), v, (new_uv, new_aff), brk)

    (uv, aff), status, _ = run_klt_iterations(
        step, (cur_uv, affine), status_in.to(torch.int8), done0, opts,
        divergence_counter=False)
    return uv, aff, status


def track_level(opts: KltOptions, ref_img, cur_img, ref_uv, cur_uv, affine,
                status, skip=None):
    """Affine KLT for a batch of features at one level.

    FAST mode goes through ``affine_track_level_cuda`` (the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors) and rewrites the
    status; DIRECT / INVERSE are plain PyTorch and keep it. ``skip``
    ``[N]`` bool lanes are not tracked: what they return is the caller's to
    replace. Returns ``(uv, affine, status int8)``."""
    if skip is None:
        skip = torch.zeros(ref_uv.shape[0], dtype=torch.bool,
                           device=ref_uv.device)
    if opts.method == KltMethod.FAST:
        from feature_tracker_tpu_torch.ops.cuda_warp_klt import (
            affine_track_level_cuda,
        )
        return affine_track_level_cuda(opts, ref_img, cur_img, ref_uv,
                                       cur_uv, affine, skip)
    return _iterative_level(opts, ref_img, cur_img, ref_uv, cur_uv, affine,
                            status, skip)
