"""Integral-pose soft-argmax and Gaussian target heatmaps (port of the JAX
`ops/keypoints.py::soft_argmax_2d` and `gaussian_heatmaps`)."""

from __future__ import annotations

import torch


def soft_argmax_2d(heatmaps: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """heatmaps: (B, H, W, J) logits, channels last. Returns (B, J, 2) (x, y)
    in pixel units (0..W-1 / 0..H-1)."""
    b, h, w, j = heatmaps.shape
    flat = (heatmaps * temperature).permute(0, 3, 1, 2).reshape(b, j, h * w)
    p = torch.softmax(flat, dim=-1).reshape(b, j, h, w)
    xs = torch.arange(w, dtype=p.dtype, device=p.device)
    ys = torch.arange(h, dtype=p.dtype, device=p.device)
    x = (p.sum(dim=2) * xs).sum(dim=-1)
    y = (p.sum(dim=3) * ys).sum(dim=-1)
    return torch.stack([x, y], dim=-1)


def gaussian_heatmaps(joints_uv: torch.Tensor, heatmap_size: int, sigma: float = 1.0):
    """Unnormalized Gaussian heatmaps from joint positions in [0, 1].

    joints_uv: (..., J, 2). Returns (heatmaps (..., H, W, J) fp32, weights
    (..., J)): centres round to the nearest pixel, a joint whose 3-sigma
    support lies fully outside the map gets weight 0."""
    hs = heatmap_size
    mu = torch.floor(joints_uv * hs + 0.5)
    r = 3.0 * sigma
    in_bounds = ((mu[..., 0] - r < hs) & (mu[..., 1] - r < hs)
                 & (mu[..., 0] + r + 1 >= 0) & (mu[..., 1] + r + 1 >= 0))
    w = in_bounds.to(torch.float32)
    xs = torch.arange(hs, dtype=torch.float32, device=joints_uv.device)
    dx = xs - mu[..., None, 0]
    dy = xs - mu[..., None, 1]
    g = torch.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2) / (2.0 * sigma ** 2))
    g = g * w[..., None, None]
    return torch.movedim(g, -3, -1), w
