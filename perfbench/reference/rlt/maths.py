"""Vector / rotation math on trailing-xyz tensors.

Conventions (reference: RocketSim/src/Math/MathTypes/MathTypes.h,.cpp):
rotation matrices have the body's forward / right / up axes as COLUMNS
(``R[..., :, 0]`` is forward); Euler angles are (yaw, pitch, roll) with
``R = Rz(yaw) Ry(-pitch) Rx(-roll)``.
"""

from __future__ import annotations

import numpy as np
import torch


def norm(v, dim=-1, keepdim=False):
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim))


def normalize(v, dim=-1, eps=1e-12):
    """Safe normalize: 0 for (near-)zero vectors (bullet safeNormalized)."""
    n = norm(v, dim=dim, keepdim=True)
    return torch.where(n > eps, v / torch.clamp(n, min=eps),
                       torch.zeros_like(v))


def dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def euler_to_rotmat(yaw, pitch=None, roll=None):
    """(yaw, pitch, roll) -> rotation matrix with forward/right/up columns
    (RocketSim Angle::ToRotMat, MathTypes.cpp:73-78)."""
    if pitch is None:
        pitch = torch.zeros_like(yaw)
    if roll is None:
        roll = torch.zeros_like(yaw)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(-pitch), torch.sin(-pitch)
    cr, sr = torch.cos(-roll), torch.sin(-roll)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def clamp_norm(v, max_norm, dim=-1):
    """Scale v down so its norm is at most max_norm: renormalise only when
    exceeded (Car.cpp:177-190)."""
    n = norm(v, dim=dim, keepdim=True)
    scale = torch.where(n > max_norm, max_norm / torch.clamp(n, min=1e-12),
                        torch.ones_like(n))
    return v * scale


def rotmat_forward(R):
    return R[..., :, 0]


def rotmat_right(R):
    return R[..., :, 1]


def rotmat_up(R):
    return R[..., :, 2]


def rotmat_to_euler(R):
    """Rotation matrix -> (yaw, pitch, roll), the inverse of
    ``euler_to_rotmat`` (MathTypes.cpp:62-71): R[2, 0] = sin(pitch)."""
    pitch = torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = -torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll


# The 3x3 products are elementwise multiply-and-sum, never a matmul: no
# TF32 setting reaches them, and batched 3x3 products stay off cuBLAS.

def rotate(R, v):
    """Local vector(s) into the world frame: R @ v."""
    return torch.sum(R * v[..., None, :], dim=-1)


def inv_rotate(R, v):
    """World vector(s) into the body frame: R^T @ v."""
    return torch.sum(R * v[..., :, None], dim=-2)


def matmul3(A, B):
    """(..., 3, 3) @ (..., 3, 3), elementwise."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


_CURVES: dict = {}


def _curve_tables(curve_table, dtype, device):
    """A curve's (xs, ys) on ``device``, made once: building them per call
    would copy from the host, and synchronise, on every evaluation."""
    key = (id(curve_table), dtype, device)
    hit = _CURVES.get(key)
    if hit is None or hit[0] is not curve_table:
        hit = (curve_table,) + tuple(
            torch.as_tensor(np.asarray(t), dtype=dtype, device=device)
            for t in curve_table)
        _CURVES[key] = hit
    return hit[1:]


def curve(curve_table, x):
    """A LinearPieceCurve (Math.h): piecewise linear, clamped at both ends,
    with ``numpy.interp``'s arithmetic."""
    xs, ys = _curve_tables(curve_table, x.dtype, x.device)
    i = torch.clamp(torch.searchsorted(xs, x.contiguous(), right=True), 1,
                    len(xs) - 1)
    x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
    dx = x1 - x0
    flat = torch.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(flat, y0, y0 + ((x - x0) / torch.where(flat, 1.0, dx))
                    * (y1 - y0))
    f = torch.where(x < xs[0], ys[0], f)
    return torch.where(x > xs[-1], ys[-1], f)


def orthonormalize(R):
    """Gram-Schmidt on the forward/right/up columns."""
    f = normalize(R[..., :, 0])
    r = R[..., :, 1]
    r = normalize(r - f * dot(f, r, keepdim=True))
    return torch.stack([f, r, cross(f, r)], dim=-1)


def integrate_rotation(R, ang_vel, dt):
    """Orientation advanced by ``ang_vel`` over ``dt`` with the exponential
    map (Rodrigues), then re-orthonormalised."""
    theta = norm(ang_vel, keepdim=True)
    axis = torch.where(theta > 1e-12, ang_vel / torch.clamp(theta, min=1e-12),
                       torch.zeros_like(ang_vel))
    angle = (theta * dt)[..., 0]
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    k = 1.0 - c
    rot = torch.stack([
        torch.stack([c + x * x * k, x * y * k - z * s, x * z * k + y * s],
                    dim=-1),
        torch.stack([y * x * k + z * s, c + y * y * k, y * z * k - x * s],
                    dim=-1),
        torch.stack([z * x * k - y * s, z * y * k + x * s, c + z * z * k],
                    dim=-1),
    ], dim=-2)
    return orthonormalize(matmul3(rot, R))


def take_along_axis(arr, idx, dim):
    """``numpy.take_along_axis`` with ``idx`` broadcast against ``arr`` on
    every axis but ``dim``, and indices out of range clamped into it as
    XLA's gather does."""
    dim = dim % arr.dim()
    shape = list(torch.broadcast_shapes(arr.shape[:dim] + (1,)
                                        + arr.shape[dim + 1:],
                                        idx.shape[:dim] + (1,)
                                        + idx.shape[dim + 1:]))
    shape[dim] = idx.shape[dim]
    ashape = list(shape)
    ashape[dim] = arr.shape[dim]
    idx = torch.clamp(idx.long(), 0, arr.shape[dim] - 1)
    return torch.gather(arr.expand(ashape), dim, idx.expand(shape))
