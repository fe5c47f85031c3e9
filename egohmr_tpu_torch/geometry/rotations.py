"""Rotation representation conversions (port of
egohmr_tpu/geometry/rotations.py).

Two 6-D layouts, as in the JAX package:
  * 'prohmr'    — x.reshape(-1, 2, 3): rows are the two 3-vectors
  * 'diffusion' — x.reshape(-1, 3, 2): columns are the two 3-vectors
"""
from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(q.shape[:-1] + (3, 3))


def aa_to_rotmat(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3], keeping the
    reference's `theta + 1e-8` regulariser inside the norm."""
    norm = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    normalized = theta / norm
    half = norm * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_rotmat(quat)


def _gram_schmidt(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True)
    u2 = a2 - proj * b1
    b2 = u2 / torch.linalg.norm(u2, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)  # columns


def rot6d_to_rotmat(x: torch.Tensor, rot6d_mode: str = "prohmr") -> torch.Tensor:
    """6-D rotation -> [N, 3, 3] with N = x.numel() // 6."""
    flat = x.reshape(-1, 6)
    if rot6d_mode == "prohmr":
        m = flat.reshape(-1, 2, 3)
        a1, a2 = m[:, 0, :], m[:, 1, :]
    elif rot6d_mode == "diffusion":
        m = flat.reshape(-1, 3, 2)
        a1, a2 = m[:, :, 0], m[:, :, 1]
    else:
        raise ValueError(f"unknown rot6d_mode: {rot6d_mode}")
    return _gram_schmidt(a1, a2)


def rotmat_to_rot6d(rotmat: torch.Tensor, rot6d_mode: str = "diffusion") -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> [N, 6]."""
    r = rotmat.reshape(-1, 3, 3)
    if rot6d_mode == "diffusion":
        return r[:, :, :2].reshape(-1, 6)
    if rot6d_mode == "prohmr":
        return r[:, :, :2].transpose(1, 2).reshape(-1, 6)
    raise ValueError(f"unknown rot6d_mode: {rot6d_mode}")


def rotmat_to_quat(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (w, x, y, z) [..., 4].

    The four candidates of the numerically stable conversion are all
    computed and one is selected per matrix with `torch.where`: on the
    trace when it is positive, else on the largest diagonal entry."""
    m = rotmat
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-24))

    s0 = safe_sqrt(trace + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    cond0 = (trace > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    return torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))


def quat_to_aa(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> axis-angle [..., 3], stable near
    the zero rotation."""
    w = quat[..., 0]
    xyz = quat[..., 1:]
    sin_sq = torch.sum(xyz * xyz, dim=-1)
    sin_theta = torch.sqrt(torch.clamp(sin_sq, min=1e-24))
    two_theta = 2.0 * torch.where(
        w < 0.0, torch.atan2(-sin_theta, -w), torch.atan2(sin_theta, w))
    k = torch.where(sin_sq > 1e-12, two_theta / sin_theta,
                    2.0 * torch.ones_like(sin_theta))
    return xyz * k[..., None]


def rotmat_to_aa(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    return quat_to_aa(rotmat_to_quat(rotmat))
