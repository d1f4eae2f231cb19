"""DensePose annotation -> training blobs in crop space (port of the JAX
package's `data/dp_annot.py`, reference `utils/dp_utils.py:12-140`).

A raw DensePose-COCO annotation (bbox, dp_x/y/I/U/V in 0..255
bbox-relative coords, 14-part `dp_masks` RLEs) becomes fixed-size
supervision for a heatmap_size x heatmap_size crop:

  ann_labels    (M, M) int32    14-part label mask resampled into the crop
  x, y          (196,) float32  annotated point coords in crop-heatmap px
  i_points      (196,) int32    patch index per point (0 pad)
  u_points      (25, 196)       channel-tiled U targets
  v_points      (25, 196)       channel-tiled V targets
  point_weights (25, 196)       indicator: channel k active where I==k

The keys are those of `models/losses.dp_uvia_losses`. Flipping needs the
DensePose UV symmetry tables; without them callers do not flip DP samples.
"""

from __future__ import annotations

import numpy as np

from danet_densepose2smpl_tpu_torch.data.rle import decode_dp_masks
from danet_densepose2smpl_tpu_torch.data.transforms import transform_point

MAX_DP_POINTS = 196
NUM_PATCHES = 24


def remap_nearest(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """`cv2.remap(src, map_x, map_y, INTER_NEAREST, BORDER_CONSTANT, 0)` for
    float32 maps: each output reads src at the coordinates rounded half to
    even, 0 where that lies outside src."""
    h, w = src.shape[:2]
    ix = np.rint(np.asarray(map_x, np.float32)).astype(np.int64)
    iy = np.rint(np.asarray(map_y, np.float32)).astype(np.int64)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    return np.where(inside, src[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)], 0).astype(src.dtype)


def dp_annot_process(
    ann: dict, heatmap_size: int, crop_res: int, center, scale,
    flip: bool = False, uv_symmetry=None,
) -> dict:
    """See module docstring. `ann` carries bbox + dp_* fields. With `flip`
    and a UV symmetry table, the annotation is mirrored first (reference
    dp_utils.py:50-52)."""
    m = heatmap_size
    bb = np.asarray(ann["bbox"], dtype=np.float64)
    x1s, y1s, x2s, y2s = bb[0], bb[1], bb[0] + bb[2], bb[1] + bb[3]

    # crop bbox in original-image coords
    ul = transform_point([1, 1], center, scale, (crop_res, crop_res), invert=True) - 1
    br = transform_point([crop_res + 1, crop_res + 1], center, scale, (crop_res, crop_res), invert=True) - 1
    x1, y1, x2, y2 = ul[0], ul[1], br[0], br[1]

    label256 = decode_dp_masks(ann["dp_masks"]) if ann.get("dp_masks") is not None else np.zeros((256, 256), np.uint8)

    gt_i = np.asarray(ann["dp_I"], dtype=np.float64).copy()
    gt_u = np.asarray(ann["dp_U"], dtype=np.float64).copy()
    gt_v = np.asarray(ann["dp_V"], dtype=np.float64).copy()
    gt_x = np.asarray(ann["dp_x"], dtype=np.float64).copy()
    gt_y = np.asarray(ann["dp_y"], dtype=np.float64).copy()

    if flip and uv_symmetry is not None:
        from danet_densepose2smpl_tpu_torch.smpl.densepose_methods import get_symmetric_densepose

        gt_i, gt_u, gt_v, gt_x, gt_y, label256 = get_symmetric_densepose(
            gt_i, gt_u, gt_v, gt_x, gt_y, label256, uv_symmetry
        )

    # resample the 256x256 bbox-space label mask into the M x M crop
    xs = (np.arange(x1, x2, (x2 - x1) / float(m))[:m] - x1s) * (255.0 / (x2s - x1s))
    ys = (np.arange(y1, y2, (y2 - y1) / float(m))[:m] - y1s) * (255.0 / (y2s - y1s))
    gx, gy = np.meshgrid(xs, ys)
    ann_labels = remap_nearest(label256, gx.astype(np.float32), gy.astype(np.float32)).astype(np.int32)

    # annotated points: bbox-relative 0..255 -> crop-heatmap pixels
    gt_y = ((gt_y / 255.0) * (y2s - y1s) + y1s - y1) * (m / (y2 - y1))
    gt_x = ((gt_x / 255.0) * (x2s - x1s) + x1s - x1) * (m / (x2 - x1))
    inside = (gt_x >= 0) & (gt_x <= m - 1) & (gt_y >= 0) & (gt_y <= m - 1) & (gt_i > 0)

    gt_i, gt_u, gt_v = gt_i[inside], gt_u[inside], gt_v[inside]
    gt_x, gt_y = gt_x[inside], gt_y[inside]
    n = min(len(gt_i), MAX_DP_POINTS)

    xp = np.zeros(MAX_DP_POINTS, np.float32)
    yp = np.zeros(MAX_DP_POINTS, np.float32)
    ip = np.zeros(MAX_DP_POINTS, np.int32)
    up = np.zeros(MAX_DP_POINTS, np.float32)
    vp = np.zeros(MAX_DP_POINTS, np.float32)
    xp[:n], yp[:n], ip[:n] = gt_x[:n], gt_y[:n], gt_i[:n].astype(np.int32)
    up[:n], vp[:n] = gt_u[:n], gt_v[:n]

    # channel-tiled UV targets + per-channel indicator weights
    u_pts = np.tile(up, (NUM_PATCHES + 1, 1))
    v_pts = np.tile(vp, (NUM_PATCHES + 1, 1))
    w_pts = (ip[None, :] == np.arange(NUM_PATCHES + 1)[:, None]).astype(np.float32)
    w_pts[0] = 0.0

    return {
        "x": xp,
        "y": yp,
        "i_points": ip,
        "u_points": u_pts.astype(np.float32),
        "v_points": v_pts.astype(np.float32),
        "point_weights": w_pts,
        "ann_labels": ann_labels,
    }


def empty_dp_dict(heatmap_size: int) -> dict:
    m = heatmap_size
    return {
        "x": np.zeros(MAX_DP_POINTS, np.float32),
        "y": np.zeros(MAX_DP_POINTS, np.float32),
        "i_points": np.zeros(MAX_DP_POINTS, np.int32),
        "u_points": np.zeros((NUM_PATCHES + 1, MAX_DP_POINTS), np.float32),
        "v_points": np.zeros((NUM_PATCHES + 1, MAX_DP_POINTS), np.float32),
        "point_weights": np.zeros((NUM_PATCHES + 1, MAX_DP_POINTS), np.float32),
        "ann_labels": np.zeros((m, m), np.int32),
    }
