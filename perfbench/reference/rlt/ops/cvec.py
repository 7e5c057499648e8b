"""Component-form vector / rotation math for the plain tick (``ops/ctick``).

A Vec is a tuple ``(x, y, z)`` of same-shaped tensors; a Mat is a tuple of
3 rows, each a tuple of 3 tensors, stored row-major: ``R[i][j]`` = row i,
col j, and the body's forward/right/up axes are the COLUMNS.  With the env
axis innermost (``(C, E)`` per-car, ``(E,)`` per-env) every operation is
elementwise over arenas, the same arithmetic that ``csrc/cvec.cuh`` does
per thread.
"""

from __future__ import annotations

import numpy as np
import torch


def vzero(like):
    z = torch.zeros_like(like)
    return (z, z, z)


def vconst(xyz, like):
    return tuple(torch.full_like(like, float(c)) for c in xyz)


def vadd(*vs):
    out = vs[0]
    for v in vs[1:]:
        out = (out[0] + v[0], out[1] + v[1], out[2] + v[2])
    return out


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def vnorm2(a):
    return vdot(a, a)


def vnorm(a):
    return torch.sqrt(vnorm2(a))


def vnormalize(a, eps=1e-12):
    """0 for near-zero vectors (maths.normalize)."""
    n = vnorm(a)
    inv = torch.where(n > eps, 1.0 / torch.clamp(n, min=eps), 0.0)
    return vscale(a, inv)


def vclamp_norm(a, max_norm, eps=1e-12):
    n = vnorm(a)
    scale = torch.where(n > max_norm, max_norm / torch.clamp(n, min=eps), 1.0)
    return vscale(a, scale)


def vwhere(mask, a, b):
    return tuple(torch.where(mask, a[i], b[i]) for i in range(3))


def vbroadcast(a, shape):
    return tuple(torch.broadcast_to(c, shape) for c in a)


def mcol(R, j):
    return (R[0][j], R[1][j], R[2][j])


def forward(R):
    return mcol(R, 0)


def right(R):
    return mcol(R, 1)


def up(R):
    return mcol(R, 2)


def matvec(R, a):
    """R @ a: local vector into the world frame."""
    return (R[0][0] * a[0] + R[0][1] * a[1] + R[0][2] * a[2],
            R[1][0] * a[0] + R[1][1] * a[1] + R[1][2] * a[2],
            R[2][0] * a[0] + R[2][1] * a[1] + R[2][2] * a[2])


def mat_t_vec(R, a):
    """R^T @ a: world vector into the body frame."""
    return (R[0][0] * a[0] + R[1][0] * a[1] + R[2][0] * a[2],
            R[0][1] * a[0] + R[1][1] * a[1] + R[2][1] * a[2],
            R[0][2] * a[0] + R[1][2] * a[1] + R[2][2] * a[2])


def matmul(A, B):
    return tuple(
        tuple(A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j]
              for j in range(3))
        for i in range(3))


def mwhere(mask, A, B):
    return tuple(tuple(torch.where(mask, A[i][j], B[i][j]) for j in range(3))
                 for i in range(3))


def inv_inertia_world(R, inv_diag):
    """R diag(inv_diag) R^T (symmetric)."""
    d0, d1, d2 = inv_diag
    return tuple(
        tuple(R[i][0] * d0 * R[k][0] + R[i][1] * d1 * R[k][1]
              + R[i][2] * d2 * R[k][2] for k in range(3))
        for i in range(3))


def orthonormalize(R):
    """Gram-Schmidt on the forward/right/up columns."""
    f = vnormalize(forward(R))
    r = right(R)
    r = vnormalize(vsub(r, vscale(f, vdot(f, r))))
    u = vcross(f, r)
    return ((f[0], r[0], u[0]), (f[1], r[1], u[1]), (f[2], r[2], u[2]))


def axis_angle_mat(axis, c, s):
    x, y, z = axis
    C = 1.0 - c
    return ((c + x * x * C, x * y * C - z * s, x * z * C + y * s),
            (y * x * C + z * s, c + y * y * C, y * z * C - x * s),
            (z * x * C - y * s, z * y * C + x * s, c + z * z * C))


def integrate_rotation(R, ang_vel, dt):
    """Exponential map (Rodrigues) + orthonormalize."""
    theta = vnorm(ang_vel)
    inv = torch.where(theta > 1e-12, 1.0 / torch.clamp(theta, min=1e-12),
                      0.0)
    axis = vscale(ang_vel, inv)
    angle = theta * dt
    rot = axis_angle_mat(axis, torch.cos(angle), torch.sin(angle))
    return orthonormalize(matmul(rot, R))


def yaw_mat(yaw):
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    return ((cy, -sy, z), (sy, cy, z), (z, z, o))


def roll_angle(R):
    """Roll of R = Rz(yaw) Ry(-pitch) Rx(-roll): -atan2(R21, R22)."""
    return -torch.atan2(R[2][1], R[2][2])


def curve(table, x):
    """LinearPieceCurve, clamped at both ends, as one select per segment
    (the same arithmetic as ``curve`` in csrc/cvec.cuh)."""
    xs, ys = [np.asarray(t, np.float64) for t in table]
    out = torch.full_like(x, float(ys[0]))
    for k in range(len(xs) - 1):
        x0, x1 = float(xs[k]), float(xs[k + 1])
        y0, y1 = float(ys[k]), float(ys[k + 1])
        t = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
        out = torch.where(x >= x0, y0 + t * (y1 - y0), out)
    return out
