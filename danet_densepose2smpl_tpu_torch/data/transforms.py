"""Image, keypoint and pose transforms, without cv2.

Port of the JAX package's `data/transforms.py` (SPIN convention: the
bounding box is `center` and a square of 200 * `scale` pixels): the
training crop (`crop`, cv2's `warpAffine(INTER_LINEAR)` reproduced in
numpy), the point transforms, the flips and the global-orientation
rotation of the dataset's augmentation, and `uncrop`, which pastes label
maps back into original-image coordinates on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.constants import (
    IMG_RES,
    J24_FLIP_PERM,
    J49_FLIP_PERM,
    SMPL_POSE_FLIP_PERM,
)


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


def transform_point(pt, center, scale, res, invert: bool = False, rot: float = 0.0):
    """Transform one (x, y) point; int-rounded 1-based like the reference
    (`utils/imutils.py:37-44`)."""
    t = get_transform(center, scale, res, rot)
    if invert:
        t = np.linalg.inv(t)
    p = t @ np.array([pt[0] - 1.0, pt[1] - 1.0, 1.0])
    return (p[:2].astype(int) + 1).astype(np.float64)


def transform_points(coords, center, scale, res, invert: bool = False, rot: float = 0.0):
    """Vectorized (N, 2) variant with the same int-round convention."""
    t = get_transform(center, scale, res, rot)
    if invert:
        t = np.linalg.inv(t)
    homo = np.concatenate([coords - 1.0, np.ones((coords.shape[0], 1))], axis=1)
    out = homo @ t.T
    return out[:, :2].astype(int) + 1


def _fma32(a, b, c) -> np.ndarray:
    """fp32 fused multiply-add: the product of two fp32 values is exact in
    fp64, and the sum is rounded to fp32 after it."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def crop(img: np.ndarray, center, scale, res=(IMG_RES, IMG_RES), rot: float = 0.0) -> np.ndarray:
    """Affine crop of a float32 (H, W, C) image to `res`, bilinear, 0
    outside the image (reference `crop`, `utils/imutils.py:53-87`, as one
    warp).

    The JAX package calls `cv2.warpAffine(img, t[:2], (res[1], res[0]),
    INTER_LINEAR, BORDER_CONSTANT)`. On float32 images cv2 5 inverts the
    map in double (`_opencv_inverse`), rounds it to fp32, and for
    destination pixel (x, y) samples at sx = fma(M00, x, fl(M01 * y) +
    M02) (sy alike) in fp32; with (ix, ax) = (floor(sx), sx - floor(sx))
    it blends the four neighbours, each 0 outside the image, by three
    fp32 fused lerps: top = fma(ax, p01 - p00, p00), bottom the same, out
    = fma(ay, bottom - top, top). No 1/32-pixel quantisation and no weight
    table: those are cv2's fixed-point path for integer images. The same
    arithmetic here gives cv2 5.0's output bit for bit where cv2 runs its
    vector loop, 16 columns a step on AVX2 (224 is 14 of them); the last
    width % 16 columns of other widths go through its scalar tail, which
    rounds the sample position differently (within 1e-2 on the 0-255
    scale; `tests/test_torch_data.py`)."""
    img = np.asarray(img, np.float32)
    h, w, c = img.shape
    m = _opencv_inverse(get_transform(center, scale, res, rot)[:2]).astype(np.float32)
    x = np.arange(int(res[1]), dtype=np.float32)[None, :]
    y = np.arange(int(res[0]), dtype=np.float32)[:, None]
    sx = _fma32(m[0, 0], x, m[0, 1] * y + m[0, 2])
    sy = _fma32(m[1, 0], x, m[1, 1] * y + m[1, 2])
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    # a border of zeros one pixel wide: every neighbour outside the image
    # reads one of its zeros
    padded = np.zeros((h + 2, w + 2, c), np.float32)
    padded[1:-1, 1:-1] = img
    flat = padded.reshape(-1, c)
    ix0, ix1 = (np.clip(fx + d, -1, w).astype(np.int64) + 1 for d in (0, 1))
    iy0, iy1 = ((np.clip(fy + d, -1, h).astype(np.int64) + 1) * (w + 2) for d in (0, 1))
    p00, p01, p10, p11 = flat[iy0 + ix0], flat[iy0 + ix1], flat[iy1 + ix0], flat[iy1 + ix1]
    top = _fma32(ax, p01 - p00, p00)
    bottom = _fma32(ax, p11 - p10, p10)
    return _fma32(ay, bottom - top, top)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear interpolation matrix with cv2's half-pixel
    centres, clamped at both borders."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f).astype(np.int64)
    a = (f - s).astype(np.float32)
    a[s < 0], s[s < 0] = 0, 0
    a[s >= n_in - 1], s[s >= n_in - 1] = 0, n_in - 1
    w = np.zeros((n_out, n_in), np.float32)
    np.add.at(w, (np.arange(n_out), s), 1 - a)
    np.add.at(w, (np.arange(n_out), np.minimum(s + 1, n_in - 1)), a)
    return w


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """(H, W, C) float image -> (size[0], size[1], C), bilinear: what
    `cv2.resize(img, (size[1], size[0]))` computes (within 1e-4 on float32
    images, `tests/test_torch_data.py`)."""
    wy, wx = _resize_weights(img.shape[0], int(size[0])), _resize_weights(img.shape[1], int(size[1]))
    return np.einsum("yh,hwc,xw->yxc", wy, np.asarray(img, np.float32), wx).astype(np.float32)


def flip_img(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def flip_kp(kp: np.ndarray) -> np.ndarray:
    """Flip 49- or 24-joint keypoints in normalized coords (negate x)."""
    kp = kp[J49_FLIP_PERM if kp.shape[0] == 49 else J24_FLIP_PERM].copy()
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose(pose: np.ndarray) -> np.ndarray:
    """Flip a 72-dim SMPL axis-angle pose (reference flip_pose)."""
    pose = pose[SMPL_POSE_FLIP_PERM].copy()
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose


def rot_aa_np(aa: np.ndarray, rot: float) -> np.ndarray:
    """Rotate the global-orientation axis-angle by `rot` degrees about the
    camera z axis."""
    from scipy.spatial.transform import Rotation

    r_aug = Rotation.from_euler("z", -rot, degrees=True).as_matrix()
    r = Rotation.from_rotvec(aa).as_matrix()
    return Rotation.from_matrix(r_aug @ r).as_rotvec().astype(aa.dtype)


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
