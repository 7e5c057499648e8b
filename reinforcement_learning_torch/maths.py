"""Vector / rotation math on trailing-xyz tensors.

Conventions (reference: RocketSim/src/Math/MathTypes/MathTypes.h,.cpp):
rotation matrices have the body's forward / right / up axes as COLUMNS
(``R[..., :, 0]`` is forward); Euler angles are (yaw, pitch, roll) with
``R = Rz(yaw) Ry(-pitch) Rx(-roll)``.
"""

from __future__ import annotations

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
