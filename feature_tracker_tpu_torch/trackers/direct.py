"""Direct photometric SE(3) camera-pose tracker.

Estimates the relative pose (q_rc, p_rc) of the current frame with respect
to a reference frame with depth, by one Gauss-Newton problem over the
photometric residuals of all feature patches (one pose for the frame).

The JAX package's semantics:
 - the world-frame entry lifts landmarks into the reference camera frame
   and composes T_rc from the two world poses;
 - the relative entry runs coarse to fine with the intrinsics scaled per
   level; ``cur_uv`` is carried across levels as it is (it starts at the
   full-resolution ``ref_uv``); a final outside check sets OUTSIDE, every
   other feature is reported TRACKED (or keeps the status passed in);
 - DIRECT: per feature the 2x6 d(pixel)/d(xi) Jacobian from the
   reference-frame point, per patch pixel the 0.5-scaled central difference
   of the current image, one 6x6 system over all features, an additive
   position update and a left-multiplied small-angle quaternion update;
   features with non-positive depth in either frame are left out; a NaN
   step, or a squared step below ``max_converge_step``, ends the level;
 - INVERSE takes the gradients from the reference image; FAST also keeps H
   from the reference-only validity mask, so an iteration rebuilds only b.

Here the 6x6 system is accumulated in float64 (its per-pixel terms stay
float32) and solved by ``ops/solve.py::solve_sym``, which raises nothing on
a singular system: its NaN step ends the level as in JAX. The all-done exit
of JAX's ``while_loop`` is a Python loop that reads ``done`` once per
iteration, one host synchronisation each; ``DirectMethod.last_stats``
records the iterations and reads of the last call.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.geometry import (
    pinhole_project,
    quat_conjugate,
    quat_from_small_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.ops.solve import solve_sym
from feature_tracker_tpu_torch.ops.window import (
    const_weights,
    pad_image,
    slice_window,
)

_EPS_Z = 1e-6


class DirectMethodMode(enum.Enum):
    INVERSE = "inverse"
    DIRECT = "direct"
    FAST = "fast"


@dataclasses.dataclass(frozen=True)
class DirectMethodOptions:
    """Defaults of the reference's DirectMethodOptions."""

    max_track_points: int = 500
    max_iterations: int = 15
    patch_row_half_size: int = 6
    patch_col_half_size: int = 6
    max_converge_step: float = 1e-6
    max_converge_residual: float = 2.0  # read nowhere, as in the reference
    method: DirectMethodMode = DirectMethodMode.DIRECT


def _sample_patch(padded, pad: int, img_shape, uv, pr: int, pc: int,
                  grads: bool):
    """Constant-weight patches (and optionally their +-1 central-difference
    gradients) of all features ``uv [N, 2]``, each from one window slice.

    The patch is rigidly offset from the projected pixel, so all its samples
    share the anchor's bilinear weights: the block is interpolated once,
    and the patch and its four shifted neighbours are views of it (each
    element the same four-term sum as JAX's shifted views give it). Tap
    validity is separable into rows and columns.

    Returns (value [N, P], valid [N, P], grad [N, P, 2] | None,
    ok_grad [N, P] | None)."""
    n, npix = uv.shape[0], pr * pc
    win = max(pr, pc) + 3
    r0, c0, wts = const_weights(uv)
    min_r = r0 - pr // 2
    min_c = c0 - pc // 2
    block = slice_window(padded, pad, min_r - 1, min_c - 1, win)
    w_tl, w_tr, w_bl, w_br = (w[:, None, None] for w in wts)
    interp = (w_tl * block[:, :-1, :-1] + w_tr * block[:, :-1, 1:]
              + w_bl * block[:, 1:, :-1] + w_br * block[:, 1:, 1:])

    def sh(dr, dc):
        return interp[:, 1 + dr:1 + dr + pr, 1 + dc:1 + dc + pc]

    # Rows min_r - 1 .. min_r + pr and columns min_c - 1 .. min_c + pc:
    # a tap anchor is valid within [0, dim - 2].
    h, w = img_shape
    rr = min_r[:, None] + torch.arange(-1, pr + 1, device=uv.device)
    cc = min_c[:, None] + torch.arange(-1, pc + 1, device=uv.device)
    row_ok = (rr >= 0) & (rr <= h - 2)
    col_ok = (cc >= 0) & (cc <= w - 2)
    v_c = (row_ok[:, 1:-1, None] & col_ok[:, None, 1:-1]).reshape(n, npix)
    value = torch.where(v_c, sh(0, 0).reshape(n, npix), 0.0)
    if not grads:
        return value, v_c, None, None
    # The centre and its four neighbours valid (tap_validity of the four
    # shifted patches, ANDed).
    rows3 = row_ok[:, :-2] & row_ok[:, 1:-1] & row_ok[:, 2:]
    cols3 = col_ok[:, :-2] & col_ok[:, 1:-1] & col_ok[:, 2:]
    ok = (rows3[:, :, None] & cols3[:, None, :]).reshape(n, npix)
    grad = 0.5 * torch.stack([(sh(0, 1) - sh(0, -1)).reshape(n, npix),
                              (sh(1, 0) - sh(-1, 0)).reshape(n, npix)], dim=-1)
    return value, v_c, grad, ok


def _pixel_xi_jacobian(p_ref, fx, fy):
    """2x6 d(pixel)/d(xi) ``[N, 2, 6]`` from the reference-frame points."""
    x, y, z = p_ref[..., 0], p_ref[..., 1], p_ref[..., 2]
    # Features of non-positive depth are masked out of H and b later, but
    # 1/0 here would give NaN * 0 = NaN in the sums: substitute depth 1.
    zi = 1.0 / torch.where(z >= _EPS_Z, z, 1.0)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * zi, zero, -fx * x * zi2,
                        -fx * x * y * zi2, fx + fx * x * x * zi2,
                        -fx * y * zi], dim=-1)
    row1 = torch.stack([zero, fy * zi, -fy * y * zi2,
                        -fy - fy * y * y * zi2, fy * x * y * zi2,
                        fy * x * zi], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _chain(grad, jac_xi):
    """Per-pixel 1x6 Jacobians ``[N, P, 6]``: ``grad [N, P, 2]`` times
    ``jac_xi [N, 2, 6]``, two products and one sum per entry."""
    return (grad[..., 0, None] * jac_xi[:, None, 0, :]
            + grad[..., 1, None] * jac_xi[:, None, 1, :])


def _gram(jm, jac):
    """``sum_n,p jm^T jac``, 6x6, accumulated in float64."""
    return jm.reshape(-1, 6).double().T @ jac.reshape(-1, 6).double()


def _own_sums(*sums):
    """The 6x6 system's sums of one process: nothing to add."""
    return sums


def _track_level(opts: DirectMethodOptions, ref_img, cur_img, k4, p_ref,
                 ref_uv, cur_uv0, q0, p0, reduce=_own_sums, first: int = 0):
    """One pyramid level. Returns (q, p, cur_uv, iterations).

    ``p_ref`` may be one slice of the features, whose first has the global
    index ``first``; ``reduce`` then sums H and b over every slice
    (``parallel/sharded.py::track_direct_sharded``), so that each process
    solves the same system and ends its loop at the same iteration."""
    n = p_ref.shape[0]
    dev = p_ref.device
    pr, pc = 2 * opts.patch_row_half_size + 1, 2 * opts.patch_col_half_size + 1
    pad = max(pr, pc) + 3
    ref_pad = pad_image(ref_img, pad)
    cur_pad = pad_image(cur_img, pad)
    in_limit = (torch.arange(first, first + n, device=dev)
                < opts.max_track_points)
    fx, fy = k4[0], k4[1]
    valid_ref_depth = p_ref[:, 2] >= _EPS_Z

    need_ref_grads = opts.method != DirectMethodMode.DIRECT
    direct_mode = opts.method == DirectMethodMode.DIRECT
    refv, okref, grad_ref, ok_grad = _sample_patch(
        ref_pad, pad, ref_img.shape, ref_uv, pr, pc, need_ref_grads)
    jac_xi = _pixel_xi_jacobian(p_ref, fx, fy)          # [N, 2, 6]

    if need_ref_grads:
        # Reference-frame gradients do not depend on the pose: once.
        ok_grad_ref = ok_grad & okref
        jac_ref = _chain(grad_ref, jac_xi)               # [N, P, 6]
    if opts.method == DirectMethodMode.FAST:
        # H frozen from the reference-only validity.
        mask_fast = (ok_grad_ref & valid_ref_depth[:, None]
                     & in_limit[:, None]).float()
        (h_fast,) = reduce(_gram(jac_ref * mask_fast[..., None], jac_ref))

    q, p, cur_uv = q0, p0, cur_uv0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iterations = 0
    while iterations < opts.max_iterations:
        p_cur = quat_rotate(quat_conjugate(q)[None, :], p_ref - p[None, :])
        valid_feat = valid_ref_depth & (p_cur[:, 2] >= _EPS_Z) & in_limit
        norm_xy = p_cur[:, :2] / p_cur[:, 2:3]
        proj_uv = pinhole_project(norm_xy, k4)
        cur_uv = torch.where((valid_feat & ~done)[:, None], proj_uv, cur_uv)

        curv, okcur, grad, ok_grad_cur = _sample_patch(
            cur_pad, pad, cur_img.shape, cur_uv, pr, pc, direct_mode)
        if direct_mode:
            okpix = ok_grad_cur & okref & okcur
            jac = _chain(grad, jac_xi)
        else:
            okpix = ok_grad_ref & okcur
            jac = jac_ref

        mask = (okpix & valid_feat[:, None]).float()
        residual = (curv - refv) * mask
        jm = jac * mask[..., None]
        bias = residual.reshape(1, -1).double() @ jm.reshape(-1, 6).double()
        if opts.method == DirectMethodMode.FAST:
            hess = h_fast
            (bias,) = reduce(bias)
        else:
            hess, bias = reduce(_gram(jm, jac), bias)

        dx = solve_sym(hess[None], bias)[0]
        isnan = torch.isnan(dx).any()
        upd = ~(done | isnan)
        p = torch.where(upd, p + dx[:3], p)
        dq = quat_multiply(quat_from_small_angle(dx[3:6]), q)
        q = torch.where(upd, quat_normalize(dq), q)
        done = done | isnan | ((dx * dx).sum() < opts.max_converge_step)
        iterations += 1
        if bool(done):                  # one host synchronisation
            break
    return q, p, cur_uv, iterations


class DirectMethod:
    """Photometric SE(3) pose tracker over a pyramid.

    ``last_stats`` holds, after each call, the Gauss-Newton iterations run
    at each level (coarsest first) and the host synchronisations they took
    (one read of ``done`` per iteration)."""

    def __init__(self, options: DirectMethodOptions | None = None,
                 device="cuda"):
        self.options = options or DirectMethodOptions()
        self.device = resolve_device(device)
        self.last_stats = {"iterations": [], "host_syncs": 0}

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def track(self, ref_pyramid, cur_pyramid, k4, p_c_in_ref, ref_uv,
              q_rc=None, p_rc=None, cur_uv=None, status=None):
        """Relative-frame entry. Returns ``(cur_uv [N, 2], q_rc [4],
        p_rc [3], status [N] int8)`` on the tracker's device."""
        return self._track(ref_pyramid, cur_pyramid, k4, p_c_in_ref, ref_uv,
                           q_rc, p_rc, cur_uv, status)

    def _track(self, ref_pyramid, cur_pyramid, k4, p_c_in_ref, ref_uv, q_rc,
               p_rc, cur_uv, status, reduce=_own_sums, first: int = 0):
        """:meth:`track` on one slice of the features (see
        :func:`_track_level` for ``reduce`` and ``first``)."""
        k4 = self._f32(k4)
        p_c_in_ref = self._f32(p_c_in_ref)
        ref_uv = self._f32(ref_uv)
        n = ref_uv.shape[0]
        if cur_uv is None or np.shape(cur_uv) != (n, 2):
            cur_uv = ref_uv
        else:
            cur_uv = self._f32(cur_uv)
        q = (self._f32(q_rc) if q_rc is not None
             else self._f32([1.0, 0.0, 0.0, 0.0]))
        p = self._f32(p_rc) if p_rc is not None else self._f32([0.0] * 3)

        levels = len(ref_pyramid)
        scale = float(1 << (levels - 1))
        s_ref = ref_uv / scale
        s_k = k4 / scale
        iterations = []
        for lvl in range(levels - 1, -1, -1):
            q, p, cur_uv, its = _track_level(
                self.options, self._f32(ref_pyramid[lvl]),
                self._f32(cur_pyramid[lvl]), s_k, p_c_in_ref, s_ref, cur_uv,
                q, p, reduce, first)
            iterations.append(its)
            if lvl > 0:
                s_ref = s_ref * 2.0
                s_k = s_k * 2.0
        self.last_stats = {"iterations": iterations,
                           "host_syncs": sum(iterations)}

        # Outside check on the full-resolution image; everything else is
        # reported TRACKED.
        h, w = ref_pyramid[0].shape
        if status is None or np.shape(status) != (n,):
            status = torch.full((n,), int(TrackStatus.TRACKED),
                                dtype=torch.int8, device=self.device)
        else:
            status = torch.as_tensor(status, device=self.device).to(
                torch.int8)
        outside = ((cur_uv[:, 0] < 0) | (cur_uv[:, 0] > w - 1)
                   | (cur_uv[:, 1] < 0) | (cur_uv[:, 1] > h - 1))
        status = torch.where(outside, int(TrackStatus.OUTSIDE),
                             status).to(torch.int8)
        return cur_uv, q, p, status

    def track_world(self, ref_pyramid, cur_pyramid, k4, ref_q_wc, ref_p_wc,
                    p_w, ref_uv, cur_q_wc, cur_p_wc, cur_uv=None,
                    status=None):
        """World-frame entry. Returns ``(cur_uv, cur_q_wc, cur_p_wc,
        status)``."""
        ref_q_wc = self._f32(ref_q_wc)
        ref_p_wc = self._f32(ref_p_wc)
        p_w = self._f32(p_w)
        cur_q_wc = self._f32(cur_q_wc)
        cur_p_wc = self._f32(cur_p_wc)

        ref_q_cw = quat_conjugate(ref_q_wc)
        p_c_in_ref = quat_rotate(ref_q_cw[None, :], p_w - ref_p_wc[None, :])
        q_rc = quat_multiply(ref_q_cw, cur_q_wc)
        p_rc = quat_rotate(ref_q_cw, cur_p_wc - ref_p_wc)

        cur_uv, q_rc, p_rc, status = self.track(
            ref_pyramid, cur_pyramid, k4, p_c_in_ref, ref_uv, q_rc, p_rc,
            cur_uv, status)
        new_q_wc = quat_multiply(ref_q_wc, q_rc)
        new_p_wc = quat_rotate(ref_q_wc, p_rc) + ref_p_wc
        return cur_uv, new_q_wc, new_p_wc, status
