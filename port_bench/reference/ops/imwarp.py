"""Image warping of the reference (a frozen copy of the port's
`ops/imwarp.py`): bilinear grid-sample, affine crops (the training ingest)
and the axis-aligned STN part crops, here as gathers of each output
pixel's two bilinear taps, counted over the taps' nonzero weights
(`counting_crops`), where the port contracts interpolation matrices.

Convention: channels-last images (B, H, W, C); normalized coordinates in
[-1, 1], `align_corners=False` (pixel centers at (2i + 1)/S - 1), zero
padding outside the image.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch


class CropCount:
    """What the STN crops of a forward (and backward) compute: `flops`
    counts each crop over the nonzeros of its interpolation weights, 2 C
    (W nnz(wy) + S nnz(wx)), twice where the images take a gradient (the
    backward's transposed interpolation); `calls` lists (B, H, W, C, S, K,
    nnz(wy), nnz(wx)) for each crop. Active inside `counting_crops()`."""

    def __init__(self):
        self.flops = 0
        self.calls = []


_COUNT: contextvars.ContextVar = contextvars.ContextVar("port_bench_crop_count", default=None)


@contextlib.contextmanager
def counting_crops():
    count = CropCount()
    token = _COUNT.set(count)
    try:
        yield count
    finally:
        _COUNT.reset(token)


def _axis_taps(centers, scales, src_size: int, out_size: int):
    """The two bilinear taps of each output pixel of the 1-D map out-pixel
    o -> normalized coord scale*((2o+1)/out - 1) + center (align_corners
    False, zero padding): (index (..., out, 2) int64 clamped into the
    source, weight (..., out, 2) fp32 or f64, 0 outside the source)."""
    ct = torch.promote_types(torch.float32, centers.dtype)
    dev = centers.device
    o = (2.0 * torch.arange(out_size, dtype=ct, device=dev) + 1.0) / out_size - 1.0
    xin = scales[..., None].to(ct) * o + centers[..., None].to(ct)
    u = (xin + 1.0) * (src_size / 2.0) - 0.5                    # pixel coords
    lo = torch.floor(u)
    t = u - lo
    idx = torch.stack([lo, lo + 1.0], dim=-1)
    w = torch.stack([1.0 - t, t], dim=-1)
    w = torch.where((idx >= 0) & (idx <= src_size - 1), w, torch.zeros_like(w))
    return idx.clamp(0, src_size - 1).long(), w


def _crop(images: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor, out_size: int,
          pixel_major: bool = False) -> torch.Tensor:
    """(B, K, S, S, C) bilinear part crops of (B, H, W, C) images, or of
    a pixel-major (B, H, W, K, C) stack (part k crops its own slice):
    rows first, then columns, each output pixel a weighted sum of its two
    taps (gathers, no interpolation matrix)."""
    b, h, w = images.shape[:3]
    c, k, s = images.shape[-1], centers.shape[1], out_size
    iy, wy = _axis_taps(centers[..., 1], scales, h, s)           # (B, K, S, 2)
    ix, wx = _axis_taps(centers[..., 0], scales, w, s)
    count = _COUNT.get()
    if count is not None:
        ny, nx = int((wy != 0).sum()), int((wx != 0).sum())
        grad = 2 if images.requires_grad and torch.is_grad_enabled() else 1
        count.flops += grad * 2 * c * (w * ny + s * nx)
        count.calls.append((b, h, w, c, s, k, ny, nx))
    dt = images.dtype
    bi = torch.arange(b, device=images.device)[:, None, None, None]
    ki = torch.arange(k, device=images.device)[None, :, None, None]
    if pixel_major:
        rows = images.permute(0, 3, 1, 2, 4)[bi, ki, iy]           # (B, K, S, 2, W, C)
    else:
        rows = images[bi, iy]                                     # (B, K, S, 2, W, C)
    tmp = (rows * wy[..., None, None].to(dt)).sum(3)              # (B, K, S, W, C)
    cols = tmp[bi, ki, :, ix]                                     # (B, K, S, 2, S, C): (x, tap, y)
    crop = (cols * wx[..., None, None].to(dt)).sum(3)             # (B, K, Sx, Sy, C)
    return crop.transpose(2, 3)


def separable_crop_concat(images: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                          out_size: int) -> torch.Tensor:
    """`separable_crop` in the channel-concat layout (B, S, S, K*C) that the
    grouped partial-IUV head consumes (channel k*C + c = part k)."""
    crops = _crop(images, centers, scales, out_size)
    b = crops.shape[0]
    return crops.permute(0, 2, 3, 1, 4).reshape(b, out_size, out_size, -1)


def separable_crop_pixel_major(images: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                               out_size: int) -> torch.Tensor:
    """Per-part crops of a pixel-major (B, H, W, K, C) tensor: part k crops
    its own slice. Returns (B, K, S, S, C)."""
    return _crop(images, centers, scales, out_size, pixel_major=True)


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


def div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d, correctly rounded on every device. PyTorch's CUDA kernels
    divide by a Python number as a product with its reciprocal (one bit
    off), which its CPU kernels and JAX do not; a tensor divisor keeps the
    IEEE division, so the card's crops equal the CPU's."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def affine_grid(theta: torch.Tensor, out_size: int) -> torch.Tensor:
    """Sampling grid of a 2x3 affine map over normalized coordinates.

    theta: (..., 2, 3) maps output normalized (x, y, 1) to input normalized
    coordinates (`F.affine_grid` semantics, align_corners=False). Returns
    (..., S, S, 2) in theta's dtype. The three products and two sums run
    elementwise, so no matrix unit (TF32 on the card) rounds a sample
    position, as `Precision.HIGHEST` keeps the JAX contraction exact."""
    base = div(2.0 * torch.arange(out_size, dtype=theta.dtype, device=theta.device) + 1.0, out_size) - 1.0
    gx, gy = base[None, :], base[:, None]                     # (1, S) varies in x, (S, 1) in y
    t = theta[..., None, None]                                # (..., 2, 3, 1, 1)
    rows = [t[..., i, 0, :, :] * gx + t[..., i, 1, :, :] * gy + t[..., i, 2, :, :] for i in (0, 1)]
    return torch.stack(rows, dim=-1)


def affine_crop(images: torch.Tensor, theta: torch.Tensor, out_size: int) -> torch.Tensor:
    """K affine crops of each image: images (B, H, W, C), theta (B, K, 2, 3)
    -> (B, K, S, S, C), bilinear with zero padding (`grid_sample_bilinear`
    on the grids of all K crops at once)."""
    b, k = theta.shape[:2]
    grid = affine_grid(theta, out_size).reshape(b, k * out_size, out_size, 2)
    return grid_sample_bilinear(images, grid).reshape(b, k, out_size, out_size, images.shape[-1])
