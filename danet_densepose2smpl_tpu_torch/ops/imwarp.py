"""Differentiable image warping (port of the JAX `ops/imwarp.py`):
bilinear grid-sample and the axis-aligned STN crops as interpolation
matrices (`_axis_weights`, `separable_crop` and its two layout variants).

Convention: channels-last images (B, H, W, C); normalized coordinates in
[-1, 1], `align_corners=False` (pixel centers at (2i + 1)/S - 1), zero
padding outside the image.
"""

from __future__ import annotations

import torch


def _axis_weights(centers, scales, src_size: int, out_size: int, dtype) -> torch.Tensor:
    """(..., out, src) bilinear interpolation matrix for the 1-D map
    out-pixel o -> normalized coord scale*((2o+1)/out - 1) + center.

    Coordinates are computed in at least fp32 (bf16 pixel coordinates would
    shift samples by up to half a pixel) and in f64 when `dtype` is f64;
    only the finished weights are cast to `dtype`.
    """
    ct = torch.promote_types(torch.float32, dtype)
    dev = centers.device
    o = (2.0 * torch.arange(out_size, dtype=ct, device=dev) + 1.0) / out_size - 1.0
    xin = scales[..., None].to(ct) * o + centers[..., None].to(ct)
    u = (xin + 1.0) * (src_size / 2.0) - 0.5                    # pixel coords
    src = torch.arange(src_size, dtype=ct, device=dev)
    w = (1.0 - (u[..., :, None] - src).abs()).clamp(0.0, 1.0)   # (..., out, src)
    return w.to(dtype)


def separable_crop(images: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                   out_size: int) -> torch.Tensor:
    """Axis-aligned multi-crop as two contractions per part.

    images: (B, H, W, C); centers: (B, K, 2) normalized (x, y); scales:
    (B, K). Returns (B, K, S, S, C).
    """
    h, w = images.shape[1:3]
    dt = images.dtype
    wx = _axis_weights(centers[..., 0], scales, w, out_size, dt)  # (B, K, S, W)
    wy = _axis_weights(centers[..., 1], scales, h, out_size, dt)  # (B, K, S, H)
    tmp = torch.einsum("bkoh,bhwc->bkowc", wy, images)
    return torch.einsum("bkowc,bkpw->bkopc", tmp, wx)


def separable_crop_concat(images: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                          out_size: int) -> torch.Tensor:
    """`separable_crop` in the channel-concat layout (B, S, S, K*C) that the
    grouped partial-IUV head consumes (channel k*C + c = part k)."""
    b, h, w = images.shape[:3]
    dt = images.dtype
    wx = _axis_weights(centers[..., 0], scales, w, out_size, dt)
    wy = _axis_weights(centers[..., 1], scales, h, out_size, dt)
    tmp = torch.einsum("bkoh,bhwc->bkowc", wy, images)
    crops = torch.einsum("bkowc,bkpw->bopkc", tmp, wx)
    return crops.reshape(b, out_size, out_size, -1)


def separable_crop_pixel_major(images: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                               out_size: int) -> torch.Tensor:
    """Per-part crops of a pixel-major (B, H, W, K, C) tensor: part k crops
    its own slice. Returns (B, K, S, S, C)."""
    h, w = images.shape[1:3]
    dt = images.dtype
    wx = _axis_weights(centers[..., 0], scales, w, out_size, dt)
    wy = _axis_weights(centers[..., 1], scales, h, out_size, dt)
    tmp = torch.einsum("bkoh,bhwkc->bkowc", wy, images)
    return torch.einsum("bkowc,bkpw->bkopc", tmp, wx)


def grid_sample_bilinear(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding, align_corners=False.

    images: (B, H, W, C); grid: (B, Ho, Wo, 2) normalized (x, y). Returns
    (B, Ho, Wo, C) (the JAX function vmapped over the batch)."""
    b, h, w, _ = images.shape
    fx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    fy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[..., None].to(images.dtype), (fy - y0)[..., None].to(images.dtype)
    bs = torch.arange(b, device=images.device).reshape(b, 1, 1)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = images[bs, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return vals * valid[..., None].to(images.dtype)

    top = gather(y0, x0) * (1 - tx) + gather(y0, x0 + 1) * tx
    bot = gather(y0 + 1, x0) * (1 - tx) + gather(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty
