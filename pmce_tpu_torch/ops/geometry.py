"""Rotation-representation conversions on batched tensors.

Port of ``pmce_tpu/ops/geometry.py``: axis-angle → rotation matrix through
the half-angle quaternion with the reference's ``+1e-8`` norm regulariser,
the 6D representation (Gram-Schmidt), quaternions and XYZ Euler angles.
Every function takes any leading batch dims and works on any device; none
branches on data.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternions [..., 4] (any norm) → [..., 3, 3]."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(*quat.shape[:-1], 3, 3)


def axis_angle_to_rotmat(axisang: torch.Tensor) -> torch.Tensor:
    """Rodrigues vectors [..., 3] → rotation matrices [..., 3, 3].

    The norm is taken of ``axisang + 1e-8``, as the reference does, so the
    value and its gradient stay finite at a zero rotation."""
    angle = torch.linalg.vector_norm(axisang + _EPS, dim=-1, keepdim=True)
    normalized = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_rotmat(quat)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation [..., 6] (read as [..., 3, 2] column pairs) → [..., 3, 3]
    by Gram-Schmidt (Zhou et al., CVPR 2019), norms floored at 1e-6."""
    x = x.reshape(*x.shape[:-1], 3, 2)
    a1, a2 = x[..., 0], x[..., 1]

    def normalize(v):
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return v / torch.clamp(n, min=1e-6)

    b1 = normalize(a1)
    dot = (b1 * a2).sum(-1, keepdim=True)
    b2 = normalize(a2 - dot * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_quat(rotmat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] → quaternions (w, x, y, z) [..., 4].

    Shepperd's four candidates, picked by masks on the transposed matrix as
    the reference's kornia port does."""
    rt = rotmat.transpose(-1, -2)
    r00, r01, r02 = rt[..., 0, 0], rt[..., 0, 1], rt[..., 0, 2]
    r10, r11, r12 = rt[..., 1, 0], rt[..., 1, 1], rt[..., 1, 2]
    r20, r21, r22 = rt[..., 2, 0], rt[..., 2, 1], rt[..., 2, 2]

    mask_d2 = r22 < eps
    mask_d0_d1 = r00 > r11
    mask_d0_nd1 = r00 < -r11

    t0 = 1 + r00 - r11 - r22
    q0 = torch.stack([r12 - r21, t0, r01 + r10, r20 + r02], dim=-1)
    t1 = 1 - r00 + r11 - r22
    q1 = torch.stack([r20 - r02, r01 + r10, t1, r12 + r21], dim=-1)
    t2 = 1 - r00 - r11 + r22
    q2 = torch.stack([r01 - r10, r20 + r02, r12 + r21, t2], dim=-1)
    t3 = 1 + r00 + r11 + r22
    q3 = torch.stack([t3, r12 - r21, r20 - r02, r01 - r10], dim=-1)

    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    q = torch.where(c0[..., None], q0, torch.where(
        c1[..., None], q1, torch.where(c2[..., None], q2, q3)))
    t = torch.where(c0, t0, torch.where(c1, t1, torch.where(c2, t2, t3)))
    return q * (0.5 / torch.sqrt(torch.clamp(t, min=eps)))[..., None]


def quat_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) [..., 4] → Rodrigues vectors [..., 3]."""
    q1, q2, q3 = quat[..., 1], quat[..., 2], quat[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    sin_theta = torch.sqrt(torch.clamp(sin_sq, min=0.0))
    cos_theta = quat[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0, torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta))
    k = torch.where(sin_sq > 0.0,
                    two_theta / torch.clamp(sin_theta, min=_EPS),
                    torch.full_like(sin_sq, 2.0))
    aa = torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)
    return torch.nan_to_num(aa, nan=0.0, posinf=torch.inf, neginf=-torch.inf)


def rotmat_to_axis_angle(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices → Rodrigues vectors, through the quaternion."""
    return quat_to_axis_angle(rotmat_to_quat(rotmat))


def euler_to_rotmat(theta: torch.Tensor) -> torch.Tensor:
    """XYZ Euler angles [..., 3] (radians) → R = Rz @ Ry @ Rx."""
    tx, ty, tz = theta.unbind(-1)
    cx, sx = torch.cos(tx), torch.sin(tx)
    cy, sy = torch.cos(ty), torch.sin(ty)
    cz, sz = torch.cos(tz), torch.sin(tz)
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)

    def mat(*entries):
        return torch.stack(entries, dim=-1).reshape(*tx.shape, 3, 3)

    rx = mat(one, zero, zero, zero, cx, -sx, zero, sx, cx)
    ry = mat(cy, zero, sy, zero, one, zero, -sy, zero, cy)
    rz = mat(cz, -sz, zero, sz, cz, zero, zero, zero, one)
    return rz @ ry @ rx
