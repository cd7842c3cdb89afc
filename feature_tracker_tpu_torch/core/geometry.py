"""Quaternion / SE(3) / pinhole-camera primitives.

Quaternions are ``[..., 4]`` tensors in (w, x, y, z) order (Eigen's
constructor convention). All functions broadcast over leading dimensions
and run on the device of their first tensor argument; numpy inputs become
float32 tensors.
"""

from __future__ import annotations

import torch


def _t(x, like=None):
    """A tensor as it is; anything else (numpy, lists) as float32, on the
    device of ``like`` if one is given."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32,
                           device=None if like is None else like.device)


def quat_identity(device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                        device=device)


def quat_normalize(q):
    q = _t(q)
    return q / torch.sqrt((q * q).sum(-1, keepdim=True))


def quat_conjugate(q):
    q = _t(q)
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_multiply(a, b):
    a = _t(a)
    b = _t(b, a)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors ``[..., 3]`` by unit quaternions ``[..., 4]``."""
    q = _t(q)
    v = _t(v, q)
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_from_small_angle(dtheta):
    """Eigen-style Quat(1, d/2).normalized(): the direct method's pose
    update."""
    dtheta = _t(dtheta)
    q = torch.cat([torch.ones_like(dtheta[..., :1]), 0.5 * dtheta], dim=-1)
    return quat_normalize(q)


def quat_to_matrix(q):
    q = _t(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def pinhole_project(norm_xy, k4):
    """Normalised plane -> image plane: (fx*x + cx, fy*y + cy), with
    ``k4 = (fx, fy, cx, cy)``."""
    norm_xy = _t(norm_xy)
    k4 = _t(k4, norm_xy)
    fx, fy, cx, cy = k4[..., 0], k4[..., 1], k4[..., 2], k4[..., 3]
    return torch.stack([fx * norm_xy[..., 0] + cx,
                        fy * norm_xy[..., 1] + cy], dim=-1)
