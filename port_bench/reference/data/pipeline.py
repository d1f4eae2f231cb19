"""Image preprocessing on the card (port of the JAX package's
`data/pipeline.py`): the host decodes frames of one size into a uint8
batch, and the crop, resize, augmentation and normalization run on the
device that holds it.

`crop_thetas` is the exact twin of the host transform
(`data/transforms.get_transform`, inverted, as a normalized
align_corners=False theta); `device_preprocess` is the eval crop and
`device_preprocess_train` the training crop with rotation, flip and channel
noise. Both take and return NHWC. The affine, the sample positions and
the samples are elementwise arithmetic (no matrix product, so TF32 never
touches them, and `torch.autocast` casts none of these ops); the callers
run them before the autocast block all the same.
"""

from __future__ import annotations

import torch

from port_bench.reference.constants import IMG_NORM_MEAN, IMG_NORM_STD, IMG_RES
from port_bench.reference.ops.imwarp import affine_crop, div


def crop_thetas(
    centers: torch.Tensor,
    scales: torch.Tensor,
    src_hw,
    rots: torch.Tensor | None = None,
    out_size: int = IMG_RES,
) -> torch.Tensor:
    """(B, 2, 3) thetas mapping crop coordinates to source normalized
    coordinates for the SPIN box convention (a square box of side
    200*scale at `centers`, optional in-plane rotation in degrees), in the
    dtype of `centers` and `scales`.

    `get_transform` (batched: source px -> crop px) is
    t(p) = (S/box) R (p - c) + S/2 with R the rotation by -rot; its
    inverse, crop px -> source px, is written out in closed form,
    p = (box/S) R^T (o - S/2) + c, rather than inverted numerically: the
    same map, but each entry a few roundings from the parameters (a 3x3
    inverse of t in fp32 loses ~1e-5 px to the cancellation in t's
    translation). Then the pixel affine becomes the normalized theta that
    `affine_crop` consumes (output pixel o samples at p = (2o+1)/S - 1;
    source pixel u = (q+1)*W/2 - 0.5). Elementwise only: no matrix unit
    (TF32) touches it."""
    h, w = src_hw
    s = float(out_size)
    dt = torch.promote_types(centers.dtype, scales.dtype)
    centers, scales = centers.to(dt), scales.to(dt)
    box = 200.0 * scales                                       # box side, px
    if rots is None:
        cs, sn = torch.ones_like(box), torch.zeros_like(box)
    else:
        # in f64, rounded once: the card's and the CPU's fp32 sin / cos
        # differ in the last bit, which white-noise frames magnify to ~1e-4
        rad = -torch.deg2rad(rots.to(torch.float64))
        cs, sn = torch.cos(rad).to(dt), torch.sin(rad).to(dt)

    # crop px -> source px: A = (box/S) R^T, b = c - (box/2) R^T (1, 1)
    k, half = div(box, s), box / 2.0
    a00, a01, a10, a11 = k * cs, k * sn, -(k * sn), k * cs
    b0 = centers[:, 0] - half * (cs + sn)
    b1 = centers[:, 1] - half * (cs - sn)

    # pixel affine -> normalized theta: A_n = D_in^-1 A D_out^-1,
    # b_n = D_in^-1 (b + 1/2) - 1 - A_n (1/S - 1)
    dx, dy = 2.0 / w, 2.0 / h
    n00, n01 = a00 * dx * (s / 2.0), a01 * dx * (s / 2.0)
    n10, n11 = a10 * dy * (s / 2.0), a11 * dy * (s / 2.0)
    bn0 = dx * (b0 + 0.5) - 1.0 - (n00 + n01) * (1.0 / s - 1.0)
    bn1 = dy * (b1 + 0.5) - 1.0 - (n10 + n11) * (1.0 / s - 1.0)
    return torch.stack([torch.stack([n00, n01, bn0], -1), torch.stack([n10, n11, bn1], -1)], dim=-2)


def _normalize(crops: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of (B, S, S, 3) crops in [0, 1], by the fp32
    constants: an fp32 crop stays fp32, an f64 one f64, as in JAX."""
    mean = torch.from_numpy(IMG_NORM_MEAN).to(crops.device)
    std = torch.from_numpy(IMG_NORM_STD).to(crops.device)
    return (crops - mean) / std


def device_preprocess(
    images: torch.Tensor,
    centers: torch.Tensor,
    scales: torch.Tensor,
    rots: torch.Tensor | None = None,
    out_size: int = IMG_RES,
) -> torch.Tensor:
    """Batched crop + resize + normalize on the images' device.

    images: (B, H, W, 3) uint8 (or float in 0-255) RGB frames of one size;
    centers (B, 2) px; scales (B,) SPIN convention; rots (B,) degrees.
    Returns normalized (B, out, out, 3) fp32 crops: the bilinear,
    zero-padded twin of `data/transforms.crop` and the ImageNet
    normalization (the frames are fp32 whatever the thetas' dtype, as in
    JAX)."""
    dev = images.device
    x = div(images.to(torch.float32), 255.0)
    theta = crop_thetas(centers.to(dev), scales.to(dev), images.shape[1:3],
                        None if rots is None else rots.to(dev), out_size=out_size)
    return _normalize(affine_crop(x, theta[:, None], out_size)[:, 0])


def device_preprocess_train(
    images: torch.Tensor,
    centers: torch.Tensor,
    scales: torch.Tensor,
    rots: torch.Tensor,
    flips: torch.Tensor,
    pixel_noise: torch.Tensor,
    out_size: int = IMG_RES,
) -> torch.Tensor:
    """The training ingest on the card: crop (with rotation) + flip +
    channel noise + normalize, the image half of
    `data/dataset.NpzDataset.__getitem__`'s augmentation (reference
    `datasets/base_dataset.py:145-158,244-251`); the labels are augmented
    on the host.

    images: (B, H, W, 3) uint8 RGB frames of one size; rots (B,) degrees;
    flips (B,) in {0, 1}; pixel_noise (B, 3) per-channel multipliers.
    Returns normalized (B, out, out, 3) crops, fp32 (f64 for f64
    `pixel_noise`, as in JAX)."""
    dev = images.device
    x = images.to(torch.float32)
    theta = crop_thetas(centers.to(dev), scales.to(dev), images.shape[1:3], rots.to(dev), out_size=out_size)
    crops = affine_crop(x, theta[:, None], out_size)[:, 0]
    crops = torch.where(flips.to(dev).bool()[:, None, None, None], crops.flip(2), crops)
    crops = div(torch.clamp(crops * pixel_noise.to(dev)[:, None, None, :], 0.0, 255.0), 255.0)
    return _normalize(crops)

