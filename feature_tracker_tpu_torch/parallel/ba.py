"""Sharded Schur-complement bundle adjustment.

Jointly refines camera poses and landmarks from pixel observations (the
JAX package's ``parallel/ba.py``; the reference has no multi-view
refinement):

 - **Landmark-block layout**: observations are stored per landmark
   ``[L, O]`` (pose index, uv, mask); the landmark axis is the shard axis.
   Every per-landmark quantity (3x3 A_l, Schur terms, back-substitution)
   is an independent batch lane.
 - **Schur complement**: each landmark eliminates its own 3x3 block in
   closed form; its contribution to the reduced camera system is
   ``B_l - W_l A_l^-1 W_l^T`` over the poses it is seen from. With
   landmarks sharded, each rank sums its landmarks' contributions and one
   all-reduce of the [6P, 6P] + [6P] system is the only collective of a
   step.
 - **Replicated solve**: the reduced 6P x 6P system is tiny (P = window
   keyframes) and solved on every rank; back-substitution is shard-local.

Where the JAX package scatter-adds each landmark's [O, O, 6, 6] pair
blocks into [P, P, 6, 6] (``.at[].add``), the port forms the same sums
without atomics, so that two runs give the same bits: a one-hot over the
P poses per observation slot folds each landmark's ``W A^-1`` and ``W``
rows into per-pose rows ``U_l, V_l`` [P, 6, 3], and then two matrix
products over the landmark axis give ``sum_l U_l V_l^T`` and the diagonal
blocks with the right-hand side. Per-observation terms (residuals,
jacobians) are float32 as in JAX; every entry point here switches TF32 off
for its own work and restores the caller's setting. The landmark blocks,
the shard's sums and the replicated solve are float64, as the warp
trackers' systems (``ops/solve.py``): in float32 the order of the sums
alone moved a converged rms history by 4e-4 relative between thread
counts, and a short-baseline landmark's 3x3 inverse by 1e-2 between the
card and the CPU. The all-reduced payload stays float32, the size
``ba_comm_report`` counts.

Pose convention: world-to-camera (q_cw, t_cw), p_c = R(q) p_w + t.
Left SE(3) perturbation: p_c' ~= p_c + dtheta x p_c + dt, giving
d p_c/d theta = -[p_c]_x and d p_c/d t = I; landmark jacobian is R(q).
Gauge freedom is fixed by freezing the first pose(s).
"""

from __future__ import annotations

import dataclasses

import torch

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.geometry import (
    quat_from_small_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)
from feature_tracker_tpu_torch.models.raft import full_float32
from feature_tracker_tpu_torch.parallel.mesh import _all_reduce

_EPS_Z = 1e-6


@dataclasses.dataclass(frozen=True)
class BaOptions:
    max_iterations: int = 10
    landmark_damping: float = 1e-4
    pose_damping: float = 1e-4
    # Gauge fixing: freeze the first K poses. 1 pins the similarity frame
    # up to global scale (sufficient with metric depth); 2 also pins the
    # monocular scale freedom.
    num_fixed_poses: int = 1
    # Metric anchoring: quadratic prior pulling each landmark toward its
    # INITIAL position, weight in (px/m)^2 against the pixel residuals.
    # 0 = pure monocular BA (scale is a gauge freedom unless
    # num_fixed_poses >= 2); > 0 = depth-seeded windows (stereo/RGBD
    # disparity) keep their metric scale, e.g. 10-100 for KITTI-scale
    # scenes (jacobian entries fx/z ~ 10-150 px/m).
    landmark_prior: float = 0.0
    # Robust kernel: Huber width in pixels (0 = pure L2). Applied as
    # IRLS: each observation's residual/jacobians are scaled by
    # sqrt(min(1, huber_px/|r|)) before the normal equations, so outlier
    # tracks (occlusions, disparity edges) stop dominating.
    huber_px: float = 0.0


def project(p_c, k4):
    """Pinhole projection of camera-frame points [..., 3] -> [..., 2]."""
    fx, fy, cx, cy = k4[0], k4[1], k4[2], k4[3]
    z = torch.clamp(p_c[..., 2], min=_EPS_Z)
    return torch.stack([fx * p_c[..., 0] / z + cx,
                        fy * p_c[..., 1] / z + cy], dim=-1)


def reprojection_residuals(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv,
                           obs_mask, k4):
    """Masked residuals [L, O, 2] (projection - observation), the camera
    points [L, O, 3] and the validity [L, O]."""
    q_o = q_cw[obs_pose_idx]                      # [L, O, 4]
    t_o = t_cw[obs_pose_idx]                      # [L, O, 3]
    p_c = quat_rotate(q_o, landmarks[:, None, :]) + t_o
    valid = obs_mask & (p_c[..., 2] > _EPS_Z)
    r = project(p_c, k4) - obs_uv
    return torch.where(valid[..., None], r, 0.0), p_c, valid


def reprojection_rms(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv, obs_mask,
                     k4, mesh=None):
    """Root mean square reprojection error over the valid observations;
    with a mesh (landmarks sharded), over every rank's."""
    r, _, valid = reprojection_residuals(q_cw, t_cw, landmarks,
                                         obs_pose_idx, obs_uv, obs_mask, k4)
    sums = torch.stack([(r * r).sum(), valid.sum().float()])
    if mesh is not None:
        _all_reduce(mesh, sums)
    return torch.sqrt(sums[0] / torch.clamp(sums[1], min=1.0))


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _jacobians(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv, obs_mask, k4):
    """Residuals + per-observation jacobians.

    Returns r [L,O,2], j_pose [L,O,2,6] (theta cols 0-2, t cols 3-5),
    j_lm [L,O,2,3], valid [L,O]."""
    r, p_c, valid = reprojection_residuals(q_cw, t_cw, landmarks,
                                           obs_pose_idx, obs_uv, obs_mask,
                                           k4)
    fx, fy = k4[0], k4[1]
    z = torch.clamp(p_c[..., 2], min=_EPS_Z)
    zi = 1.0 / z
    x, y = p_c[..., 0], p_c[..., 1]
    zero = torch.zeros_like(zi)
    j_proj = torch.stack([
        torch.stack([fx * zi, zero, -fx * x * zi * zi], -1),
        torch.stack([zero, fy * zi, -fy * y * zi * zi], -1)], -2)  # [L,O,2,3]

    j_pose = torch.cat([
        torch.einsum("loij,lojk->loik", j_proj, -_skew(p_c)),
        j_proj], dim=-1)                                         # [L,O,2,6]

    rot = quat_to_matrix(q_cw)[obs_pose_idx]                     # [L,O,3,3]
    j_lm = torch.einsum("loij,lojk->loik", j_proj, rot)          # [L,O,2,3]

    m = valid[..., None, None].float()
    return r, j_pose * m, j_lm * m, valid


def _landmark_terms(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv, obs_mask,
                    k4, opts: BaOptions, landmarks0):
    """Every shard-local quantity of a step, float64: (a_inv [L,3,3],
    g_l [L,3], w [L,O,6,3], w_ainv [L,O,6,3], b_blk [L,O,6,6],
    rhs [L,O,6])."""
    r, j_pose, j_lm, _ = _jacobians(q_cw, t_cw, landmarks, obs_pose_idx,
                                    obs_uv, obs_mask, k4)
    if opts.huber_px > 0.0:
        # IRLS Huber weights per observation (scale r and J by sqrt(w)).
        rn = torch.linalg.norm(r, dim=-1)                        # [L,O]
        sw = torch.sqrt(torch.clamp(rn.new_full((), opts.huber_px)
                                    / torch.clamp(rn, min=1e-6), max=1.0))
        r = r * sw[..., None]
        j_pose = j_pose * sw[..., None, None]
        j_lm = j_lm * sw[..., None, None]

    # The landmark blocks in float64 from the float32 per-observation terms
    # (the rule of ops/solve.py): A_l of a landmark seen along a short
    # baseline reaches cond ~1e6, where its float32 inverse moved landmarks
    # by 1e-2 between the card and the CPU.
    r, j_pose, j_lm = r.double(), j_pose.double(), j_lm.double()

    # Damping is RELATIVE (Levenberg-Marquardt lambda*diag(A) + floor): at
    # pixel-unit jacobian scales (fx ~ 700, A entries ~ 1e5) an absolute
    # 1e-4 ridge is below float32 rounding of the Gram product, and a
    # landmark seen from identical poses (rank-2 A) would invert to NaN.
    eye3 = torch.eye(3, dtype=torch.float64, device=landmarks.device)
    a_l = torch.einsum("loik,loij->lkj", j_lm, j_lm)             # [L,3,3]
    lm_scale = torch.diagonal(a_l, dim1=1, dim2=2)               # [L,3]
    a_l = a_l + eye3 * (opts.landmark_damping * lm_scale
                        + opts.landmark_damping)[:, None, :]
    g_l = -torch.einsum("loik,loi->lk", j_lm, r)                 # [L,3]
    if opts.landmark_prior > 0.0:
        # Quadratic metric prior 0.5*w*|lm - lm0|^2: w*I on A and
        # -w*(lm - lm0) on g (W/B untouched, so the Schur elimination
        # absorbs it unchanged).
        a_l = a_l + opts.landmark_prior * eye3
        g_l = g_l - opts.landmark_prior * (landmarks - landmarks0).double()
    w = torch.einsum("loik,loij->lokj", j_pose, j_lm)            # [L,O,6,3]
    b_blk = torch.einsum("loik,loij->lokj", j_pose, j_pose)      # [L,O,6,6]
    c = -torch.einsum("loik,loi->lok", j_pose, r)                # [L,O,6]

    # inv_ex: no host synchronisation and no error on a singular block
    # (its NaN step is zeroed below, as in JAX).
    a_inv = torch.linalg.inv_ex(a_l).inverse                     # [L,3,3]
    w_ainv = torch.einsum("loij,ljk->loik", w, a_inv)            # [L,O,6,3]
    rhs = c - torch.einsum("loik,lk->loi", w_ainv, g_l)          # [L,O,6]
    return a_inv, g_l, w, w_ainv, b_blk, rhs


def _reduced_system(obs_pose_idx, w, w_ainv, b_blk, rhs, num_poses: int):
    """This shard's sums of the reduced camera system, packed in one
    float32 vector: H [6P, 6P] (row 6a+i, column 6b+j holds pose block
    (a, b) entry (i, j)), then b [P, 6]. ``H = sum_l (B_l - W_l A_l^-1
    W_l^T)`` over the poses each landmark is seen from, formed by products
    with a one-hot over the poses instead of a scatter-add, and summed in
    float64: rounded once to float32 for the all-reduce, the shard's sums
    then do not depend on their order (the card's, the CPU's, any
    thread count)."""
    p = num_poses
    l, o = obs_pose_idx.shape
    onehot = (obs_pose_idx[..., None]
              == torch.arange(p, device=w.device)).double()      # [L,O,P]
    # Per-pose rows of each landmark: U_l[a] = sum_o [idx=a] (W A^-1)_o,
    # V_l[a] = sum_o [idx=a] W_o; their products over (l, k) are the
    # -W A^-1 W^T part of every pose pair.
    u = torch.einsum("loa,loik->ailk", onehot, w_ainv)           # [P,6,L,3]
    v = torch.einsum("loa,loik->lkai", onehot, w)                # [L,3,P,6]
    cross = u.reshape(6 * p, 3 * l) @ v.reshape(3 * l, 6 * p)
    # The B_l diagonal blocks and the right-hand side per pose.
    diag_rhs = onehot.reshape(l * o, p).T @ torch.cat(
        [b_blk.reshape(l * o, 36), rhs.reshape(l * o, 6)], 1)    # [P, 42]
    blocks = (torch.eye(p, dtype=torch.float64, device=w.device)
              [:, None, :, None] * diag_rhs[:, :36].reshape(p, 6, 1, 6))
    h = blocks.reshape(6 * p, 6 * p) - cross
    return torch.cat([h.reshape(-1), diag_rhs[:, 36:].reshape(-1)]).float()


def ba_step(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv, obs_mask, k4,
            opts: BaOptions = BaOptions(), landmarks0=None, mesh=None):
    """One damped Gauss-Newton step with Schur elimination of landmarks.

    ``landmarks0`` (with ``opts.landmark_prior > 0``) anchors landmarks to
    their initial metric positions. With a mesh, the landmark-axis inputs
    are this rank's slices (``shard_features``) and the poses replicated:
    the reduced camera system is all-reduced over the mesh, the step's
    only collective. Returns (q_cw, t_cw, landmarks) updated."""
    if landmarks0 is None:
        landmarks0 = landmarks
    with full_float32():
        return _ba_step_f32(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv,
                            obs_mask, k4, opts, landmarks0, mesh)


def _ba_step_f32(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv, obs_mask, k4,
                 opts: BaOptions, landmarks0, mesh):
    p = q_cw.shape[0]
    a_inv, g_l, w, w_ainv, b_blk, rhs = _landmark_terms(
        q_cw, t_cw, landmarks, obs_pose_idx, obs_uv, obs_mask, k4, opts,
        landmarks0)
    packed = _reduced_system(obs_pose_idx, w, w_ainv, b_blk, rhs, p)
    if mesh is not None:
        _all_reduce(mesh, packed)
    h = packed[:36 * p * p].reshape(6 * p, 6 * p).double()
    b = packed[36 * p * p:].double()

    # Replicated from here, in float64 (the system's entries span ~1e5 and
    # its right-hand side is a small difference near convergence): damping
    # on the diagonal of every pose block, then the gauge (the first K
    # poses frozen: zero rows and columns, identity diagonal).
    h = h + torch.diag(opts.pose_damping * torch.diagonal(h)
                       + opts.pose_damping)
    if opts.num_fixed_poses > 0:
        keep = (torch.arange(6 * p, device=h.device) // 6
                >= opts.num_fixed_poses).double()
        h = h * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
        b = b * keep
    dx_p = torch.linalg.solve_ex(h, b[:, None])[0].reshape(p, 6)
    dx_p = torch.where(torch.isnan(dx_p), 0.0, dx_p)

    # Back-substitution (shard-local): dl = A^-1 (g - sum_o W^T dp_o).
    dp_at_obs = dx_p[obs_pose_idx]                               # [L,O,6]
    corr = torch.einsum("loik,loi->lk", w, dp_at_obs)            # [L,3]
    dl = torch.einsum("lij,lj->li", a_inv, g_l - corr).float()
    dl = torch.where(torch.isnan(dl), 0.0, dl)
    dx_p = dx_p.float()

    # Apply updates: left-perturbation pose update, additive landmarks.
    dq = quat_from_small_angle(dx_p[:, :3])
    new_q = quat_normalize(quat_multiply(dq, q_cw))
    new_t = quat_rotate(dq, t_cw) + dx_p[:, 3:]
    return new_q, new_t, landmarks + dl


def _ba_device(mesh, device) -> torch.device:
    """``device``; by default the mesh's device type, else ``"cuda"``."""
    if device is None:
        device = mesh.device_type if mesh is not None else "cuda"
    return resolve_device(device)


def bundle_adjust(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv, obs_mask, k4,
                  opts: BaOptions = BaOptions(), mesh=None, device=None):
    """Run ``opts.max_iterations`` damped GN steps; returns (q_cw, t_cw,
    landmarks, rms_history [iters+1]) as tensors on the device.

    Inputs may be numpy or tensors. Without a mesh everything runs on
    ``device`` (``"cuda"`` by default; without a GPU this raises unless it
    is ``"cpu"``). With a mesh, ``landmarks``, ``obs_*`` are this rank's
    slices of the landmark axis (``shard_features``), the poses and ``k4``
    are the same on every rank, and the results are this rank's landmarks
    and the common poses. The rms history stays on the device until the
    end: a step waits for no host read."""
    dev = _ba_device(mesh, device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    q_cw, t_cw, landmarks, obs_uv, k4 = (f32(x) for x in (
        q_cw, t_cw, landmarks, obs_uv, k4))
    obs_pose_idx = torch.as_tensor(obs_pose_idx, device=dev).long()
    obs_mask = torch.as_tensor(obs_mask, device=dev).bool()

    landmarks0 = landmarks
    rms = [reprojection_rms(q_cw, t_cw, landmarks, obs_pose_idx, obs_uv,
                            obs_mask, k4, mesh)]
    for _ in range(opts.max_iterations):
        q_cw, t_cw, landmarks = ba_step(q_cw, t_cw, landmarks, obs_pose_idx,
                                        obs_uv, obs_mask, k4, opts,
                                        landmarks0, mesh)
        rms.append(reprojection_rms(q_cw, t_cw, landmarks, obs_pose_idx,
                                    obs_uv, obs_mask, k4, mesh))
    return q_cw, t_cw, landmarks, torch.stack(rms)
