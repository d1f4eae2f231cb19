"""Crop transforms of the eval path, without cv2.

Port of `get_transform` and `uncrop` of the JAX package's
`data/transforms.py` (SPIN convention: the bounding box is `center` and a
square of 200 * `scale` pixels). `uncrop` pastes label maps back into
original-image coordinates on their device.
"""

from __future__ import annotations

import numpy as np
import torch


def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """3x3 matrix taking original-image coords to res-crop coords
    (reference `utils/imutils.py:11-35`; h = 200*scale box convention)."""
    h = 200.0 * scale
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot_rad = -rot * np.pi / 180.0
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1.0]])
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2.0
        t_mat[1, 2] = -res[0] / 2.0
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def _opencv_inverse(m: np.ndarray) -> np.ndarray:
    """The 2x3 inverse that `cv2.warpAffine` computes (in double) when it is
    handed a forward map without WARP_INVERSE_MAP."""
    a, b, c, d, e, f = m.reshape(-1)
    det = a * e - b * d
    det = 1.0 / det if det != 0 else 0.0
    a2, b2, d2, e2 = e * det, -b * det, -d * det, a * det
    return np.array([[a2, b2, -a2 * c - b2 * f], [d2, e2, -d2 * c - e2 * f]])


def uncrop(imgs: torch.Tensor, centers, scales, orig_shapes) -> list[torch.Tensor]:
    """Paste crops back into original-image coordinates, nearest neighbour,
    0 outside the crop (reference `utils/imutils.py:89-113`).

    imgs: (B, h, w) label maps on any device; centers (B, 2), scales (B,),
    orig_shapes (B, 2) as (H, W): host arrays. Returns B tensors of shapes
    orig_shapes[i], on imgs' device, in imgs' dtype.

    The JAX package calls `cv2.warpAffine(img, inv(t)[:2], (W, H),
    INTER_NEAREST)`: cv2 inverts that map back (`_opencv_inverse`), rounds
    it to fp32, and destination pixel (x, y) reads source pixel
    round-half-even(M @ (x, y, 1)), the products and sums in fp32. The same
    arithmetic here gives cv2 5's output pixel for pixel (OpenCV 4's
    fixed-point nearest path, 10 fractional bits, differs on ~3e-4 of the
    pixels)."""
    b, h, w = imgs.shape
    dev = imgs.device
    out = []
    for i in range(b):
        t = get_transform(np.asarray(centers[i], np.float64), float(scales[i]), (h, w), 0.0)
        m = torch.as_tensor(_opencv_inverse(np.linalg.inv(t)[:2]).astype(np.float32), device=dev)
        rows, cols = int(orig_shapes[i][0]), int(orig_shapes[i][1])
        x = torch.arange(cols, dtype=torch.float32, device=dev)[None, :]
        y = torch.arange(rows, dtype=torch.float32, device=dev)[:, None]
        sx = torch.round(m[0, 0] * x + m[0, 1] * y + m[0, 2]).long()
        sy = torch.round(m[1, 0] * x + m[1, 1] * y + m[1, 2]).long()
        inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        src = imgs[i][sy.clamp(0, h - 1), sx.clamp(0, w - 1)]
        out.append(torch.where(inside, src, torch.zeros((), dtype=imgs.dtype, device=dev)))
    return out
