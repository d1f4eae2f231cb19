"""Camera projection and the batched translation fit (port of the JAX
`ops/projection.py::perspective_projection` and `estimate_translation`)."""

from __future__ import annotations

import torch

from port_bench.reference.constants import FOCAL_LENGTH, IMG_RES


def perspective_projection(points: torch.Tensor, rotation: torch.Tensor,
                           translation: torch.Tensor, focal_length,
                           camera_center: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of (B, N, 3) points. rotation: (B, 3, 3);
    translation: (B, 3); focal_length: scalar or (B,); camera_center:
    (B, 2). Returns (B, N, 2) pixel coordinates."""
    cam_pts = torch.einsum("bij,bnj->bni", rotation, points) + translation[:, None, :]
    xy = cam_pts[..., :2] / cam_pts[..., 2:3]
    f = torch.as_tensor(focal_length, dtype=xy.dtype, device=xy.device)
    f = f.reshape(-1, 1, 1) if f.dim() else f
    return xy * f + camera_center[:, None, :]


def estimate_translation(joints_3d: torch.Tensor, joints_2d: torch.Tensor,
                         focal_length: float = FOCAL_LENGTH, img_size: float = IMG_RES,
                         use_gt_subset: bool = True) -> torch.Tensor:
    """Weighted-least-squares camera translation (B, 3), one batched 3x3
    solve of the normal equations, weights = the 2D confidences.

    joints_3d: (B, J, 3); joints_2d: (B, J, 3) with confidence in channel
    2; `use_gt_subset` keeps the 24 GT joints (25:49). A 1e-6 Tikhonov term
    keeps all-zero-confidence samples finite (~0, masked by the caller).
    """
    if use_gt_subset:
        joints_3d = joints_3d[:, 25:, :]
        joints_2d = joints_2d[:, 25:, :]
    w = joints_2d[..., 2]
    center = img_size / 2.0
    f = focal_length
    x, y, z = joints_3d[..., 0], joints_3d[..., 1], joints_3d[..., 2]
    du = joints_2d[..., 0] - center
    dv = joints_2d[..., 1] - center
    fz = torch.full_like(du, f)

    a00 = (w * fz * fz).sum(1)
    a02 = (w * fz * (-du)).sum(1)
    a11 = (w * fz * fz).sum(1)
    a12 = (w * fz * (-dv)).sum(1)
    a22 = (w * (du * du + dv * dv)).sum(1)
    zeros = torch.zeros_like(a00)
    A = torch.stack([
        torch.stack([a00, zeros, a02], dim=-1),
        torch.stack([zeros, a11, a12], dim=-1),
        torch.stack([a02, a12, a22], dim=-1),
    ], dim=-2)

    ru = du * z - f * x
    rv = dv * z - f * y
    b = torch.stack([(w * fz * ru).sum(1), (w * fz * rv).sum(1),
                     (w * (-du * ru - dv * rv)).sum(1)], dim=-1)
    A = A + 1e-6 * torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A, b[..., None])[..., 0]
