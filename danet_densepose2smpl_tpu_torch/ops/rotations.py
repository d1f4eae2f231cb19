"""Rotation-representation conversions (port of the JAX `ops/rotations.py`
functions on the serving and training paths)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def batch_rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), through the
    half-angle quaternion, with the same `theta + eps` norm at theta = 0."""
    angle = torch.linalg.vector_norm(aa + _EPS, dim=-1, keepdim=True)
    axis = aa / angle
    half = 0.5 * angle
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True).clamp_min(_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (wy + xz)], dim=-1)
    row1 = torch.stack([2 * (wz + xy), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (wx + yz), ww - xx - yy + zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> rotation matrix (..., 3, 3).

    The 6 values are read as a (3, 2) column pair (column a1 = x[0::2],
    a2 = x[1::2]); the output stacks the orthonormal frame as matrix
    *columns*.
    """
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(_EPS)
    a2_perp = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2_perp / torch.linalg.vector_norm(a2_perp, dim=-1, keepdim=True).clamp_min(_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rot6d_rows_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """HMR 2.0's 6D rotation (..., 6) -> rotation matrix (..., 3, 3)
    (`hmr2/utils/geometry.py::rot6d_to_rotmat` of 4D-Humans).

    The 6 values are read as two rows, a1 = x[0:3] and a2 = x[3:6], so
    its identity is (1, 0, 0, 0, 1, 0); the frame is normalized as
    `F.normalize` does (norms clamped at 1e-12) and stacked as matrix
    columns. Away from degenerate pairs it is `rot6d_to_rotmat` of the
    values interleaved (a1[0], a2[0], a1[1], a2[1], a1[2], a2[2]).
    """
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    a2_perp = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2_perp / torch.linalg.vector_norm(a2_perp, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)
