"""SE(2) (rotation + translation) pyramidal KLT with optional luminance
normalisation ("LSSD": locally scaled sum of squared differences), in
plain PyTorch, batched over features.

Warp model: ``pos_cur = R @ pos_ref + t`` with a per-feature 2x2 rotation
``R`` and translation ``t``; the Gauss-Newton step is v in R^3 =
(dtheta, dt_x, dt_y).

 - FAST mode: the 3x3 H is rebuilt every step (R changes); the optional
   mean normalisation is gated by ``luminance``. The status is rewritten
   at every level. :func:`lssd_track_level_reference` and the level loop
   over it, :func:`lssd_track_pyramid_reference`, are the plain versions of
   the CUDA kernel behind ``ops.cuda_warp_klt.lssd_track_level_cuda`` and
   ``lssd_track_pyramid_cuda``.
 - DIRECT / INVERSE: always mean-normalised; the incoming status is kept.
   The JAX package has no TPU kernel for these modes; here they are plain
   PyTorch on either device.
 - Rotation update by the small-angle matrix ``[[1, -v0], [v0, 1]]``, then
   the whole matrix divided by the norm of its first column.
 - The SE(2) jacobian column is ``grad . (R @ (-row, col))``.

Luminance means, kept as the JAX package has them: the sum over the
*inner* region of a patch is divided by the valid count of the *whole*
patch (extended patch for the reference, sampled patch for the current
image), with no guard against an empty patch. The per-pixel arithmetic is
float32 as there; the sums of H and b and the solve are float64
(``ops/solve.py`` says why), as in the CUDA kernel.
"""

from __future__ import annotations

import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.ops.interp import bilinear_sample
from feature_tracker_tpu_torch.ops.solve import normal_equations, solve_sym
from feature_tracker_tpu_torch.trackers.klt.affine import (
    flat_offsets,
    no_break_status,
    fast_initial_status,
    reference_setup,
)
from feature_tracker_tpu_torch.trackers.klt.engine import (
    StepResult,
    run_klt_iterations,
)


def _update_se2(rot, t, v):
    """``R <- R @ [[1, -v0], [v0, 1]]`` divided as a whole by the norm of
    its first column; ``t <- t + v[1:3]``. The small-angle matrix is formed
    as ``I + [[0, -1], [1, 0]] * v0`` and the product written out entry by
    entry, so that it rounds as in the CUDA kernel (a library matrix
    product may fuse its multiply-adds)."""
    v0 = v[:, 0]
    d00 = 1.0 + 0.0 * v0
    d01 = 0.0 + -1.0 * v0
    d10 = 0.0 + 1.0 * v0
    d11 = 1.0 + 0.0 * v0
    r00, r01, r10, r11 = rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1]
    n00 = r00 * d00 + r01 * d10
    n01 = r00 * d01 + r01 * d11
    n10 = r10 * d00 + r11 * d10
    n11 = r10 * d01 + r11 * d11
    norm = torch.sqrt(n00 * n00 + n10 * n10)
    new_rot = torch.stack([torch.stack([n00 / norm, n01 / norm], dim=-1),
                           torch.stack([n10 / norm, n11 / norm], dim=-1)],
                          dim=-2)
    return new_rot, t + v[:, 1:3]


def _sum_f64(x):
    """Row sums of float32 ``x [N, P]`` accumulated in float64 and rounded
    once to float32: independent of the order of the sum."""
    return x.double().sum(1).float()


def _rotate(rot, x, y):
    """``R @ (x, y)`` per pixel for ``x, y [N, P]``."""
    return (x * rot[:, 0, 0:1] + y * rot[:, 0, 1:2],
            x * rot[:, 1, 0:1] + y * rot[:, 1, 1:2])


def _system(jtheta, dx, dy, residual):
    """``H = J^T J`` and ``b = -J^T r`` for ``J = [jtheta, dx, dy]``, in
    float64."""
    return normal_equations(torch.stack([jtheta, dx, dy], dim=-1), residual)


def lssd_track_level_reference(opts: KltOptions, luminance: bool, ref_img,
                               cur_img, ref_uv, rot, t, skip,
                               with_steps: bool = False):
    """FAST-mode SE(2) KLT at one level, in plain PyTorch.

    Args:
      luminance: divide both patches by their means.
      ref_img, cur_img: ``[H, W]`` float32.
      ref_uv: ``[N, 2]`` float32 positions at this level.
      rot: ``[N, 2, 2]`` float32; t: ``[N, 2]`` float32.
      skip: ``[N]`` bool; skipped lanes return ``rot``, ``t`` and
        NOT_TRACKED.
      with_steps: also return ``[N]`` int32, the steps each feature took.

    Returns ``(rot [N, 2, 2], t [N, 2], status [N] int8)``."""
    n = ref_uv.shape[0]
    dev = ref_uv.device
    pr, pc = opts.patch_rows, opts.patch_cols
    dx, dy, inner_patch, inner_valid, n_valid_ref = reference_setup(
        opts, ref_img, ref_uv)
    if luminance:
        ref_mean = (_sum_f64(inner_patch)
                    / n_valid_ref.to(torch.float32))[:, None]
        dx = dx / ref_mean
        dy = dy / ref_mean
        inner_patch = inner_patch / ref_mean
    offsets = flat_offsets(opts, dev)
    px = ref_uv[:, 0:1] + offsets[0]    # absolute subpixel ref coords
    py = ref_uv[:, 1:2] + offsets[1]
    no_pixels, status0 = fast_initial_status(n_valid_ref)
    no_pixels = no_pixels | skip
    no_break = no_break_status(n, dev)

    def step(state):
        r, tt = state
        posx, posy = _rotate(r, px, py)
        pos = torch.stack([posx + tt[:, 0:1], posy + tt[:, 1:2]], dim=-1)
        curv, okcur = bilinear_sample(cur_img, pos)
        cur_patch = curv  # already 0 where invalid
        if luminance:
            n_cur = okcur.sum(1).to(torch.float32)
            grid = cur_patch.reshape(n, pr, pc)
            cur_mean = _sum_f64(grid[:, 1:-1, 1:-1].flatten(1)) / n_cur
            cur_patch = cur_patch / cur_mean[:, None]
        valid = okcur & inner_valid
        residual = torch.where(valid, cur_patch - inner_patch, 0.0)
        jrx, jry = _rotate(r, -py, px)   # d(pos)/dtheta = R @ (-row, col)
        jtheta = dx * jrx + dy * jry
        hess, b = _system(torch.where(valid, jtheta, 0.0),
                          torch.where(valid, dx, 0.0),
                          torch.where(valid, dy, 0.0), residual)
        v = solve_sym(hess, b)
        return StepResult(valid.sum(1), v, _update_se2(r, tt, v), no_break)

    (rot, t), status, steps = run_klt_iterations(
        step, (rot, t), status0, no_pixels, opts, divergence_counter=True)
    status = torch.where(skip, int(TrackStatus.NOT_TRACKED), status)
    if with_steps:
        return rot, t, status, steps
    return rot, t, status


def rotate_uv(rot, uv):
    """``R @ uv`` per feature: ``rot [N, 2, 2]``, ``uv [N, 2]``."""
    return torch.stack([rot[:, 0, 0] * uv[:, 0] + rot[:, 0, 1] * uv[:, 1],
                        rot[:, 1, 0] * uv[:, 0] + rot[:, 1, 1] * uv[:, 1]],
                       dim=-1)


def lssd_track_pyramid_reference(opts: KltOptions, luminance: bool, ref_pyr,
                                 cur_pyr, ref_uv, cur_uv, rot, skip,
                                 with_steps: bool = False):
    """FAST-mode SE(2) KLT over a whole pyramid, in plain PyTorch: the level
    loop over :func:`lssd_track_level_reference`. ``t = s_cur - R s_ref``
    at the coarsest scale, R is carried from level to level, only ``s_ref``
    and ``t`` double between levels, and the result is ``R ref_uv + t``.

    Args:
      luminance: divide both patches by their means.
      ref_pyr, cur_pyr: sequences of ``[H_l, W_l]`` float32 levels, finest
        first.
      ref_uv, cur_uv: ``[N, 2]`` float32 full-resolution positions.
      rot: ``[N, 2, 2]`` float32, the rotation at the coarsest level.
      skip: ``[N]`` bool; skipped lanes keep ``rot`` and ``t`` and return
        NOT_TRACKED.
      with_steps: also return ``[N]`` int32, the steps each feature took
        over all levels.

    Returns ``(uv [N, 2] at full resolution, rot [N, 2, 2], status [N] int8
    of the finest level)``."""
    scale = float(1 << (len(ref_pyr) - 1))
    s_ref = ref_uv / scale
    t = cur_uv / scale - rotate_uv(rot, s_ref)
    steps = 0
    for lvl in range(len(ref_pyr) - 1, -1, -1):
        rot, t, status, lvl_steps = lssd_track_level_reference(
            opts, luminance, ref_pyr[lvl], cur_pyr[lvl], s_ref, rot, t, skip,
            with_steps=True)
        steps = steps + lvl_steps
        if lvl > 0:
            s_ref = s_ref * 2.0
            t = t * 2.0
    uv = rotate_uv(rot, ref_uv) + t
    if with_steps:
        return uv, rot, status, steps
    return uv, rot, status


def _iterative_level(opts: KltOptions, ref_img, cur_img, ref_uv, rot, t,
                     status_in, done0):
    """DIRECT / INVERSE SE(2) KLT at one level; always mean-normalised (no
    TPU kernel exists for it; plain PyTorch on either device)."""
    dev = ref_uv.device
    offsets = flat_offsets(opts, dev)
    ex = torch.tensor([1.0, 0.0], dtype=torch.float32, device=dev)
    ey = torch.tensor([0.0, 1.0], dtype=torch.float32, device=dev)
    px = ref_uv[:, 0:1] + offsets[0]
    py = ref_uv[:, 1:2] + offsets[1]
    p_ref = torch.stack([px, py], dim=-1)
    inverse = opts.method == KltMethod.INVERSE
    refv, okref = bilinear_sample(ref_img, p_ref)
    no_break = no_break_status(ref_uv.shape[0], dev)

    def step(state):
        r, tt = state
        posx, posy = _rotate(r, px, py)
        pos = torch.stack([posx + tt[:, 0:1], posy + tt[:, 1:2]], dim=-1)
        g_img, g_pos = (ref_img, p_ref) if inverse else (cur_img, pos)
        vl, okl = bilinear_sample(g_img, g_pos - ex)
        vr, okr = bilinear_sample(g_img, g_pos + ex)
        vt, okt = bilinear_sample(g_img, g_pos - ey)
        vb, okb = bilinear_sample(g_img, g_pos + ey)
        curv, okcur = bilinear_sample(cur_img, pos)
        valid = okl & okr & okt & okb & okref & okcur
        nvalid = valid.sum(1)
        nvalid_f = nvalid.to(torch.float32)
        ref_mean = (_sum_f64(torch.where(valid, refv, 0.0))
                    / nvalid_f)[:, None]
        cur_mean = (_sum_f64(torch.where(valid, curv, 0.0))
                    / nvalid_f)[:, None]
        g_mean = ref_mean if inverse else cur_mean
        dx = torch.where(valid, vr - vl, 0.0) / g_mean
        dy = torch.where(valid, vb - vt, 0.0) / g_mean
        residual = torch.where(valid, curv / cur_mean - refv / ref_mean, 0.0)
        jrx, jry = _rotate(r, -py, px)
        hess, b = _system(dx * jrx + dy * jry, dx, dy, residual)
        v = solve_sym(hess, b)
        return StepResult(nvalid, v, _update_se2(r, tt, v), no_break)

    (rot, t), status, _ = run_klt_iterations(
        step, (rot, t), status_in.to(torch.int8), done0, opts,
        divergence_counter=False)
    return rot, t, status


def track_level(opts: KltOptions, luminance: bool, ref_img, cur_img, ref_uv,
                rot, t, status, skip=None):
    """SE(2) KLT for a batch of features at one level.

    FAST mode goes through ``lssd_track_level_cuda`` (the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors) and rewrites the
    status; DIRECT / INVERSE are plain PyTorch and keep it. ``skip``
    ``[N]`` bool lanes are not tracked: what they return is the caller's to
    replace. Returns ``(rot, t, status int8)``."""
    if skip is None:
        skip = torch.zeros(ref_uv.shape[0], dtype=torch.bool,
                           device=ref_uv.device)
    if opts.method == KltMethod.FAST:
        from feature_tracker_tpu_torch.ops.cuda_warp_klt import (
            lssd_track_level_cuda,
        )
        return lssd_track_level_cuda(opts, luminance, ref_img, cur_img,
                                     ref_uv, rot, t, skip)
    return _iterative_level(opts, ref_img, cur_img, ref_uv, rot, t, status,
                            skip)
