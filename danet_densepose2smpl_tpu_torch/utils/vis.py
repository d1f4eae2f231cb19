"""Visualization helpers for the demo and the training summaries (port of
the JAX package's `utils/vis.py`), in numpy: no cv2, no matplotlib.

`draw_skeleton` and `draw_points` give the uint8 pixels of the cv2 calls
the JAX helpers make (`cv2.line` with LINE_8, thickness 1, clipped to the
frame; `cv2.circle` of radius 2, filled; `cv2.drawMarker` with
MARKER_CROSS). Figures are tiles of panels side by side, each panel
scaled to a common height by an integer nearest-neighbour factor, written
as one PNG by `data/image_io.write_png`; there are no titles (the JAX
helpers' matplotlib figures have them).
"""

from __future__ import annotations

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.constants import IMG_NORM_MEAN, IMG_NORM_STD
from danet_densepose2smpl_tpu_torch.ops.structure import DP2SMPL_MAPPING, SMPL_EDGES

DEMO_PANELS = ("input", "predicted IUV", "rendered IUV (pred SMPL)", "24 partial IUV", "pred mesh",
               "pred mesh (side)")


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Undo ImageNet normalization -> [0, 1] RGB."""
    return np.clip(np.asarray(img) * IMG_NORM_STD + IMG_NORM_MEAN, 0, 1)


def iuv_to_rgb(iuv_img: np.ndarray) -> np.ndarray:
    """(H, W, 3) IUV image -> displayable RGB: the (I/24, U, V) channels
    as they are, clipped to [0, 1]."""
    return np.clip(np.asarray(iuv_img), 0, 1)


def part_grid(part_iuv: np.ndarray, cols: int = 6) -> np.ndarray:
    """(24, S, S, 3) partial IUV stack -> one tiled (4S x 6S, 3) image."""
    parts = np.asarray(part_iuv)
    k, s = parts.shape[0], parts.shape[1]
    rows = int(np.ceil(k / cols))
    canvas = np.zeros((rows * s, cols * s, 3), parts.dtype)
    for i in range(k):
        r, c = divmod(i, cols)
        canvas[r * s:(r + 1) * s, c * s:(c + 1) * s] = parts[i]
    return np.clip(canvas, 0, 1)


def heatmap_grid(heatmaps: np.ndarray, cols: int = 6) -> np.ndarray:
    """(S, S, 24) joint heatmaps -> one tiled grayscale-as-RGB grid image,
    each tile min-max scaled to [0, 1]."""
    hm = np.moveaxis(np.asarray(heatmaps), -1, 0)
    k, s = hm.shape[0], hm.shape[1]
    rows = int(np.ceil(k / cols))
    canvas = np.zeros((rows * s, cols * s), np.float32)
    for i in range(k):
        r, c = divmod(i, cols)
        tile = hm[i]
        rng = tile.max() - tile.min()
        canvas[r * s:(r + 1) * s, c * s:(c + 1) * s] = (tile - tile.min()) / rng if rng > 1e-9 else 0.0
    return np.repeat(canvas[..., None], 3, axis=-1)


def partial_iuv_images(part_iuv: np.ndarray) -> np.ndarray:
    """(24, S, S, 3, 7) cleaned partial IUV stacks -> (24, S, S, 3)
    displayable per-part IUV images, each part's 7 local channels mapped
    to global patch ids (`DP2SMPL_MAPPING`)."""
    from danet_densepose2smpl_tpu_torch.ops.iuvmap import iuv_map2img

    pi = torch.as_tensor(np.asarray(part_iuv))
    imgs = [iuv_map2img(pi[k, None, ..., 0, :], pi[k, None, ..., 1, :], pi[k, None, ..., 2, :],
                        ind_mapping=[0] + list(DP2SMPL_MAPPING[k]))[0].numpy()
            for k in range(pi.shape[0])]
    return np.stack(imgs)


# ---------------------------------------------------------------------------
# drawing, pixel for pixel as cv2 draws
# ---------------------------------------------------------------------------

def _clip_line(w: int, h: int, p1, p2):
    """cv2's `clipLine` (Cohen-Sutherland against [0, w-1] x [0, h-1], the
    intersections truncated toward zero). Returns the clipped end points,
    or None when the segment misses the frame."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def line_pixels(w: int, h: int, p1, p2) -> list:
    """The (x, y) pixels `cv2.line(img, p1, p2, color, 1, cv2.LINE_8)`
    sets on a (h, w) image: the clipped segment, walked left to right by
    cv2's 8-connected `LineIterator`."""
    clipped = _clip_line(w, h, (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1])))
    if clipped is None:
        return []
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:                                   # leftToRight
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    pts, x, y = [], x1, y1
    for _ in range(dx + 1):
        pts.append((x, y))
        diag = err < 0
        err += minus + (plus if diag else 0)
        if vert:                                   # y steps always, x on a diagonal move
            y += step_y
            x += 1 if diag else 0
        else:
            x += 1
            y += step_y if diag else 0
    return pts


def circle_pixels(w: int, h: int, center, radius: int) -> list:
    """The (x, y) pixels of `cv2.circle(img, center, radius, color, -1)`
    (filled, LINE_8) on a (h, w) image: cv2's midpoint spans, clipped."""
    cx, cy = int(center[0]), int(center[1])
    pts = set()
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1

    def span(y, xa, xb):
        if 0 <= y < h:
            pts.update((x, y) for x in range(max(xa, 0), min(xb, w - 1) + 1))

    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return sorted(pts)


def _paint(out: np.ndarray, pts: list, color) -> None:
    if pts:
        xs, ys = np.array(pts).T
        out[ys, xs] = color


def _color(color) -> np.ndarray:
    return np.array([int(255 * v) for v in color], np.uint8)


def draw_skeleton(img: np.ndarray, joints_px: np.ndarray, color=(0, 1.0, 0)) -> np.ndarray:
    """Overlay the 24-joint SMPL skeleton on an RGB [0,1] image: each bone
    a one-pixel line, each joint a filled disc of radius 2.

    joints_px: (24, 2) pixel coords (x, y)."""
    out = (np.asarray(img) * 255).astype(np.uint8).copy()
    h, w = out.shape[:2]
    c = _color(color)
    for p, ch in SMPL_EDGES:
        _paint(out, line_pixels(w, h, np.round(joints_px[p]).astype(int), np.round(joints_px[ch]).astype(int)), c)
    for j in joints_px:
        _paint(out, circle_pixels(w, h, np.round(j).astype(int), 2), c)
    return out.astype(np.float32) / 255.0


def draw_points(img: np.ndarray, pts_px: np.ndarray, color=(1.0, 0.2, 0.2), radius: int = 3) -> np.ndarray:
    """Overlay cross markers of size 2 * radius (e.g. the STN crop
    centres) on an RGB [0,1] image; points off the frame are skipped.
    pts_px: (N, 2) (x, y)."""
    out = (np.asarray(img) * 255).astype(np.uint8).copy()
    c = _color(color)
    h, w = out.shape[:2]
    for q in np.asarray(pts_px):
        x, y = int(round(float(q[0]))), int(round(float(q[1])))
        if 0 <= x < w and 0 <= y < h:             # cv2 draws +-markerSize / 2 = +-radius
            _paint(out, line_pixels(w, h, (x - radius, y), (x + radius, y)), c)
            _paint(out, line_pixels(w, h, (x, y - radius), (x, y + radius)), c)
    return out.astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def to_uint8(panel: np.ndarray) -> np.ndarray:
    """A [0, 1] RGB (or gray) panel -> uint8 RGB, round(255 * clip(x))."""
    p = np.asarray(panel, np.float64)
    if p.ndim == 2:
        p = np.repeat(p[..., None], 3, -1)
    return np.round(255.0 * np.clip(p, 0, 1)).astype(np.uint8)


def scale_to_height(panel: np.ndarray, height: int) -> np.ndarray:
    """Nearest-neighbour upscale of a panel by the integer factor that
    brings it to `height`; raises when there is none."""
    h = panel.shape[0]
    if height % h:
        raise ValueError(f"a panel of height {h} does not scale to {height} by an integer factor")
    f = height // h
    return np.repeat(np.repeat(panel, f, axis=0), f, axis=1)


def tile(rows: list, height: int) -> np.ndarray:
    """Rows of panels -> one uint8 RGB image: each panel `to_uint8`, scaled
    to `height`, the panels of a row side by side, the rows stacked
    (narrower rows padded with black at the right)."""
    strips = [np.concatenate([scale_to_height(to_uint8(p), height) for p in row], axis=1) for row in rows]
    width = max(s.shape[1] for s in strips)
    return np.concatenate([np.pad(s, ((0, 0), (0, width - s.shape[1]), (0, 0))) for s in strips], axis=0)


def demo_panels(
    image: np.ndarray,
    iuv_pred_img: np.ndarray,
    part_iuv_imgs: np.ndarray | None,
    rendered_iuv: np.ndarray | None,
    shaded_front: np.ndarray | None = None,
    shaded_side: np.ndarray | None = None,
) -> list:
    """The demo's panels as [(title, [0, 1] array)], in `DEMO_PANELS`
    order, those given only: the input (denormalized), the predicted IUV,
    the rendered IUV of the predicted SMPL, the 24-part grid, the shaded
    mesh from the front and from the side."""
    def gray(x):
        return None if x is None else np.repeat(np.asarray(x)[..., None], 3, -1)

    panels = (denormalize_image(image), iuv_to_rgb(iuv_pred_img),
              None if rendered_iuv is None else iuv_to_rgb(rendered_iuv),
              None if part_iuv_imgs is None else part_grid(part_iuv_imgs), gray(shaded_front), gray(shaded_side))
    return [(title, p) for title, p in zip(DEMO_PANELS, panels) if p is not None]


def demo_composite(
    image: np.ndarray,
    iuv_pred_img: np.ndarray,
    part_iuv_imgs: np.ndarray | None,
    rendered_iuv: np.ndarray | None,
    out_path: str,
    shaded_front: np.ndarray | None = None,
    shaded_side: np.ndarray | None = None,
) -> str:
    """Write the demo's figure: the `demo_panels`, left to right, each
    scaled to the input's height, as one PNG at `out_path`."""
    panels = demo_panels(image, iuv_pred_img, part_iuv_imgs, rendered_iuv, shaded_front, shaded_side)
    return save_rows([[p for _, p in panels]], out_path)


def save_rows(rows: list, out_path: str) -> str:
    """`tile` the rows of panels at the height of the first panel and
    write them as one PNG at `out_path`."""
    from danet_densepose2smpl_tpu_torch.data.image_io import write_png

    write_png(out_path, tile(rows, rows[0][0].shape[0]))
    return out_path
