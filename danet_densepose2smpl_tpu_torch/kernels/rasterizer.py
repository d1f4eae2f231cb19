"""Z-buffered flat-texture triangle rasterizer for the GT IUV images: the
CUDA kernel `csrc/rasterizer.cu`, its plain PyTorch versions, the camera
helpers and `IUVRenderer` (port of the JAX `kernels/rasterizer.py` and
`kernels/rasterizer_pallas.py`).

One hand-written kernel file serves four entry points, one per JAX function:

  rasterize_flat         K5's `rasterize_flat`, and K2 `rasterize_flat_pallas`
                         (the same contract)
  rasterize_flat_masked  K4 `rasterize_flat_pallas_bandrange(..., cull_mask)`:
                         faces marked in `cull_mask` take no part
  rasterize_flat_culled  K5's `rasterize_flat_culled`: on the card, the
                         masked raster with the face set and tie order of
                         the compacted prefix (see `culled_face_sets`)
  rasterize_flat_banded  K3 `rasterize_flat_pallas_banded`: the contract of
                         `rasterize_flat`; its plain version sorts faces by
                         y (`band_setup`) and skips chunks per tile

`render_shaded` (the demo's and the training vis's shaded mesh) calls
`rasterize_flat` once per image with a 1-channel face texture.

Each dispatches on the device and dtype of `verts_px` (`_kernel_takes`): an
fp32 CUDA tensor goes to the kernel, which launches or raises; a CPU tensor
and an fp64 one go to the entry's plain version, the tests' precision
running the same code on every device. The kernel's unit of work is the
(pixel centre, face) pair inside the face's `pixel_spans`, spread evenly
over the card, and the nearest face wins a 64-bit `atomicMin` of
`depth_key` (see the header of `csrc/rasterizer.cu`). The port
holds every entry to K5's formulas (`rasterize_flat`, `rasterizer.py:82-151`):
K2/K4 evaluate affine edge coefficients and z = za * inv_area, which round
differently on a few pixels in 10^4. Ties in z resolve to the lowest face
id (first-index argmin within a chunk, strict `<` across chunks); faces
marked `ties_last` lose every tie to unmarked ones.

Rounding, in fp32, is that of the JAX function as XLA compiles it: LLVM
fuses each edge function into fma(ex, dy, -(ey * dx)) and the depth into
fma(b2, z2, fma(b0, z0, b1 * z1)). The plain version computes those two
fused multiply-adds exactly (an fp32 product is exact in fp64) and the
kernel calls fmaf at the same places; without them a few pixels in 10^5,
where two faces' depths lie within an ulp, would pick the other face.
In fp64 there is no wider type to fuse in, so the plain version computes
the unfused expression.

Geometry: pixel (row i, col j) of the S-out map has centre (j + 0.5,
i + 0.5) in out-map units; x_out = x_pixel_orig * S / orig. The inside test
takes both windings; depth is the barycentric-interpolated screen z, with
z > 1e-6 required.
"""

from __future__ import annotations

import ctypes
import functools
import warnings

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.constants import FOCAL_LENGTH
from danet_densepose2smpl_tpu_torch.kernels.build import build
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import DensePoseAtlas, orient_faces

_BIG = 1e9
_EMPTY = 1e30                     # the empty box's sentinel extent
_EMPTY_KEY = 2 ** 63 - 1          # the emulation's empty key, above every depth_key (the kernel's is all ones, unsigned)
_TILE = 16                        # the banded plain version's tile of pixels (K3's)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

def camera_space(verts, cam, orig_size: float = 224.0, focal_length: float = FOCAL_LENGTH):
    """SMPL-space vertices -> camera space for the weak-perspective
    (s, tx, ty) camera: translate by (tx, ty, 2f / (orig * s))."""
    tz = 2.0 * focal_length / (orig_size * cam[:, 0] + 1e-9)
    t = torch.stack([cam[:, 1], cam[:, 2], tz], dim=-1)
    return verts + t[:, None, :]


def project_weak_perspective(verts, cam, orig_size: float = 224.0,
                             focal_length: float = FOCAL_LENGTH):
    """SMPL-space vertices + (s, tx, ty) -> pixel-space (x, y, z) in the
    orig_size image frame."""
    p = camera_space(verts, cam, orig_size, focal_length)
    f = focal_length * (orig_size / 224.0)
    c = orig_size / 2.0
    x = f * p[..., 0] / p[..., 2] + c
    y = f * p[..., 1] / p[..., 2] + c
    return torch.stack([x, y, p[..., 2]], dim=-1)


def dead_faces(verts_px, faces):
    """((B, F, 3, 3) corner gather, (B, F) True = cull): back-facing
    (projected signed area >= 0 on a pre-oriented mesh) or any corner at
    z <= 0 — the culled rasterizer's dead set."""
    tri = verts_px[:, faces, :]
    v0, v1, v2 = tri[:, :, 0, :2], tri[:, :, 1, :2], tri[:, :, 2, :2]
    area = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
        v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0])
    z_ok = (tri[..., 2] > 0).all(-1)
    return tri, (area >= 0) | ~z_ok


def backface_mask(verts, cam, faces, orig_size: float = 224.0, focal_length: float = 5000.0):
    """(B, F) True for faces whose outward normal points away from the
    camera (n . centroid > 0 in camera space); `verts` are SMPL-space."""
    p = camera_space(verts, cam, orig_size, focal_length)
    tri = p[:, faces, :]
    n = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0], dim=-1)
    centroid = tri.mean(dim=2)
    return torch.einsum("bfc,bfc->bf", n, centroid) > 0


def cull_budget(n_faces: int, chunk: int, budget_frac: float) -> int:
    """Faces the culled scan keeps: int(budget_frac * F) rounded up to a
    multiple of 1024, then up to a multiple of `chunk`
    (`rasterizer.py:249-250`)."""
    budget = -(-int(budget_frac * n_faces) // 1024) * 1024
    return -(-budget // chunk) * chunk


# ---------------------------------------------------------------------------
# plain versions (the JAX formulas op for op)
# ---------------------------------------------------------------------------

def _pixel_centers(s: int, dtype, device):
    """(1, S*S, 1, 2) pixel centres in out-map units."""
    px = torch.arange(s, dtype=dtype, device=device) + 0.5
    gy, gx = torch.meshgrid(px, px, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(1, s * s, 1, 2)


def _fma(a, b, c):
    """a * b + c with one rounding in fp32 (the fp32 product is exact in
    fp64); the plain two-rounding expression in fp64."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def _chunk_depths(cxy, cz, px, py):
    """(B, P, K) depth of each pixel in each face of one chunk, _BIG where
    the pixel is outside the face or the face is invalid (K5's formulas).

    cxy (B, K, 3, 2), cz (B, K, 3); px, py broadcast against (B, P, K)."""
    v0, v1, v2 = cxy[:, :, 0], cxy[:, :, 1], cxy[:, :, 2]
    area = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
        v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0])

    def edge(a, bb):
        ex = bb[..., 0] - a[..., 0]
        ey = bb[..., 1] - a[..., 1]
        return _fma(ex[:, None, :], py - a[:, None, :, 1], -(ey[:, None, :] * (px - a[:, None, :, 0])))

    w0, w1, w2 = edge(v1, v2), edge(v2, v0), edge(v0, v1)
    sgn = torch.sign(area)[:, None, :]
    inside = (w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
    big_area = area.abs() > 1e-12
    denom = torch.where(big_area, area, torch.ones_like(area))[:, None, :]
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    zpix = _fma(b2, cz[:, None, :, 2], _fma(b0, cz[:, None, :, 0], b1 * cz[:, None, :, 1]))
    valid = inside & big_area[:, None, :] & (zpix > 1e-6) & (cz > 0).all(-1)[:, None, :]
    return torch.where(valid, zpix, torch.full_like(zpix, _BIG))


def _zbuffer_scan(xy, z, pxy):
    """Scan face chunks, carrying the winning face's flat position.

    xy (B, NC, K, 3, 2), z (B, NC, K, 3), pxy (1, P, 1, 2). Returns (B, P)
    int64, NC*K for the background."""
    b, n_chunks, chunk = xy.shape[:3]
    p = pxy.shape[1]
    px, py = pxy[..., 0], pxy[..., 1]
    zbuf = torch.full((b, p), _BIG, dtype=xy.dtype, device=xy.device)
    bestid = torch.full((b, p), n_chunks * chunk, dtype=torch.long, device=xy.device)
    for ci in range(n_chunks):
        zmask = _chunk_depths(xy[:, ci], z[:, ci], px, py)
        zbest, best = zmask.min(dim=-1)          # first minimal index, as jnp.argmin
        better = zbest < zbuf
        zbuf = torch.where(better, zbest, zbuf)
        bestid = torch.where(better, ci * chunk + best, bestid)
    return bestid


def rasterize_flat_plain(verts_px, faces, face_tex, out_size: int, orig_size: float = 224.0,
                         chunk: int = 1024, skip=None, ties_last=None):
    """Plain version of `rasterize_flat` (`skip` (B, F) bool: faces that take
    no part; `ties_last` (B, F) bool: faces that lose exact-z ties to every
    unmarked face; the `rasterize_flat_masked` contract). `chunk` bounds the
    (B, S*S, chunk) temporaries and does not change the result."""
    b, s = verts_px.shape[0], out_size
    n_faces, c = faces.shape[0], face_tex.shape[-1]
    tri = verts_px[:, faces, :]
    if skip is not None:
        tri = torch.where(skip[..., None, None], tri.new_tensor([0.0, 0.0, -1.0]), tri)
    order = None
    if ties_last is not None:   # scan the marked faces after the others
        order = torch.argsort(ties_last.to(torch.uint8), dim=1, stable=True)
        tri = torch.gather(tri, 1, order[:, :, None, None].expand(b, n_faces, 3, 3))
    xy, z = tri[..., :2] * (s / orig_size), tri[..., 2]
    pad = (-n_faces) % chunk
    if pad:
        xy = torch.cat([xy, xy.new_zeros(b, pad, 3, 2)], dim=1)
        z = torch.cat([z, z.new_full((b, pad, 3), -1.0)], dim=1)
    n_chunks = (n_faces + pad) // chunk
    bestid = _zbuffer_scan(xy.reshape(b, n_chunks, chunk, 3, 2), z.reshape(b, n_chunks, chunk, 3),
                           _pixel_centers(s, verts_px.dtype, verts_px.device))
    if order is not None:
        looked = torch.gather(order, 1, bestid.clamp_max(n_faces - 1))
        bestid = torch.where(bestid >= n_faces, bestid, looked)
    table = torch.cat([face_tex, face_tex.new_zeros(pad + 1, c)], dim=0)
    return table[bestid].reshape(b, s, s, c)


def rasterize_flat_culled_plain(verts_px, faces, face_tex, out_size: int, orig_size: float = 224.0,
                                chunk: int = 1024, budget_frac: float = 0.55):
    """Plain version of `rasterize_flat_culled`: live faces compacted to a
    static prefix of `cull_budget` faces (stable sort, live first), the scan
    over that prefix, then the ids mapped back (`rasterizer.py:239-270`)."""
    b, s = verts_px.shape[0], out_size
    n_faces, c = faces.shape[0], face_tex.shape[-1]
    budget = cull_budget(n_faces, chunk, budget_frac)
    if budget >= n_faces:
        return rasterize_flat_plain(verts_px, faces, face_tex, out_size, orig_size, chunk)
    tri, dead = dead_faces(verts_px, faces)
    order = torch.argsort(dead.to(torch.uint8), dim=1, stable=True)
    keep = order[:, :budget]
    tri = torch.gather(tri, 1, keep[:, :, None, None].expand(b, budget, 3, 3))
    n_chunks = budget // chunk
    xy = (tri[..., :2] * (s / orig_size)).reshape(b, n_chunks, chunk, 3, 2)
    z = tri[..., 2].reshape(b, n_chunks, chunk, 3)
    bestid = _zbuffer_scan(xy, z, _pixel_centers(s, verts_px.dtype, verts_px.device))
    looked = torch.gather(order, 1, bestid.clamp_max(n_faces - 1))
    orig = torch.where(bestid >= budget, torch.full_like(looked, n_faces), looked)
    table = torch.cat([face_tex, face_tex.new_zeros(1, c)], dim=0)
    return table[orig].reshape(b, s, s, c)


def culled_face_sets(verts_px, faces, budget: int):
    """((B, F) skip, (B, F) ties_last) under which the full-order raster
    computes exactly the culled scan: the compacted prefix holds the live
    faces of live rank < budget, then (when fewer are live) the dead faces
    of dead rank < budget - #live, which still render if they pass the
    inside and z tests. Those filler faces follow every live face in the
    prefix, so they lose exact-z ties to live faces."""
    _, dead = dead_faces(verts_px, faces)
    live = ~dead
    live_rank = torch.cumsum(live, dim=1) - 1
    dead_rank = torch.cumsum(dead, dim=1) - 1
    n_live = live.sum(dim=1, keepdim=True)
    in_prefix = torch.where(live, live_rank < budget, dead_rank < budget - n_live)
    return ~in_prefix, dead & in_prefix


def band_setup(verts_px, faces, out_size: int, orig_size: float = 224.0):
    """(B, F) int64 face order of the banded raster: faces sorted by the
    mean y of their corners in out-map units (K3's `_band_setup`,
    `rasterizer_pallas.py:224-228`), with a stable sort so that the CPU and
    the card break ties alike."""
    y_center = (verts_px[:, faces, 1] * (out_size / orig_size)).mean(-1)
    return torch.argsort(y_center, dim=1, stable=True)


def face_boxes(xy, z):
    """(..., 4) fp32 boxes (xmin, xmax, ymin, ymax) of faces with corners
    xy (..., 3, 2) in out-map units and depths z (..., 3), widened by a
    pixel, as the kernel's face_setup writes them; the empty box
    (1e30, -1e30, 1e30, -1e30) for a face that can cover no pixel (area
    within 1e-12 of 0, or a corner at z <= 0)."""
    x, y = xy[..., 0], xy[..., 1]
    area = (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0]) - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0])
    valid = (area.abs() > 1e-12) & (z > 0).all(-1)
    box = torch.stack([x.min(-1).values.float() - 1.0, x.max(-1).values.float() + 1.0,
                       y.min(-1).values.float() - 1.0, y.max(-1).values.float() + 1.0], dim=-1)
    empty = torch.tensor([_EMPTY, -_EMPTY, _EMPTY, -_EMPTY], dtype=torch.float32, device=box.device)
    return torch.where(valid[..., None], box, empty)


def pixel_spans(xy, z, s: int, skip=None):
    """((..., 4) int64 (x0, y0, w, h), (...) int64 pair count w * h): the
    pixel centres (j + 0.5, i + 0.5), j in [x0, x0 + w) and i in [y0, y0 +
    h), that lie in each face's `face_boxes` box (one pixel wider than the
    face), clamped to the S x S image, as the kernel's face_setup computes
    them in fp32; an empty span for a face that can cover no pixel or is
    marked in `skip` (..., bool). The pair kernel enumerates exactly these
    pairs. A plain mirror of face_setup, which the wrapper does not call:
    the tests and chip_smoke.py hold the kernel's pair count against it."""
    box = face_boxes(xy, z)
    if skip is not None:
        box = torch.where(skip[..., None], box.new_tensor([_EMPTY, -_EMPTY, _EMPTY, -_EMPTY]), box)
    lo = (box[..., 0::2] - 0.5).ceil().clamp(0, s)                # (x0, y0)
    hi = ((box[..., 1::2] - 0.5).floor() + 1.0).clamp(0, s)        # exclusive ends
    size = (hi - lo).clamp_min(0)
    span = torch.cat([lo, size], dim=-1).to(torch.int64)
    return span, span[..., 2] * span[..., 3]


def depth_key(z, rank):
    """int64 key (bits of fp32 `z`) << 32 | `rank` of the kernel's z-buffer:
    for positive finite z and 0 <= rank < 2^31 the least key is the least
    (z, rank), as positive floats order as their bits. A plain mirror of the
    key raster_pairs forms, which the wrapper does not call: the tests pin
    its order and emulate the kernel with it (empty pixels hold
    `_EMPTY_KEY` there, as int64 has no all-ones maximum)."""
    bits = z.to(torch.float32).view(torch.int32).to(torch.int64)
    return (bits << 32) | rank.to(torch.int64)


def chunk_extents(box, chunk: int):
    """(B, ceil(F / chunk), 4) union of each run of `chunk` consecutive face
    boxes (B, F, 4): the extent the banded raster tests a tile against
    (the last run padded with empty boxes)."""
    b, n_faces = box.shape[:2]
    empty = box.new_tensor([_EMPTY, -_EMPTY, _EMPTY, -_EMPTY]).expand(b, (-n_faces) % chunk, 4)
    box = torch.cat([box, empty], dim=1).reshape(b, -1, chunk, 4)
    return torch.stack([box[..., 0].amin(-1), box[..., 1].amax(-1),
                        box[..., 2].amin(-1), box[..., 3].amax(-1)], dim=-1)


def rasterize_flat_banded_plain(verts_px, faces, face_tex, out_size: int, orig_size: float = 224.0,
                                chunk: int = 1024):
    """Plain version of `rasterize_flat_banded`, with the kernel's skipping.

    Faces in `band_setup` order are cut into chunks of `chunk`; each chunk's
    extent is the union of its `face_boxes`. Each 16x16 tile of pixels (K3's
    tile; 16 rows are a band) scans only the chunks whose extent
    meets the tile, and keeps the least (z, face id). A face that covers a
    pixel centre of the tile has a box, and so a chunk, that meets it: the
    output equals `rasterize_flat_plain`'s exactly."""
    b, s = verts_px.shape[0], out_size
    n_faces, c = faces.shape[0], face_tex.shape[-1]
    order = band_setup(verts_px, faces, s, orig_size)
    tri = torch.gather(verts_px[:, faces, :], 1, order[:, :, None, None].expand(b, n_faces, 3, 3))
    xy, z, ids = tri[..., :2] * (s / orig_size), tri[..., 2], order
    pad = (-n_faces) % chunk
    if pad:   # padding faces are invalid and carry the background id
        xy = torch.cat([xy, xy.new_zeros(b, pad, 3, 2)], dim=1)
        z = torch.cat([z, z.new_full((b, pad, 3), -1.0)], dim=1)
        ids = torch.cat([ids, ids.new_full((b, pad), n_faces)], dim=1)
    n_chunks = (n_faces + pad) // chunk
    extent = chunk_extents(face_boxes(xy, z), chunk)                                   # (B, NC, 4)
    xy, z = xy.reshape(b, n_chunks, chunk, 3, 2), z.reshape(b, n_chunks, chunk, 3)
    ids = ids.reshape(b, n_chunks, chunk)
    bestid = torch.full((b, s, s), n_faces, dtype=torch.long, device=verts_px.device)
    for y0 in range(0, s, _TILE):
        for x0 in range(0, s, _TILE):
            touch = ((extent[..., 1] >= x0) & (extent[..., 0] <= x0 + _TILE)
                     & (extent[..., 3] >= y0) & (extent[..., 2] <= y0 + _TILE))        # (B, NC)
            rows = torch.arange(y0, min(y0 + _TILE, s), dtype=xy.dtype, device=xy.device) + 0.5
            cols = torch.arange(x0, min(x0 + _TILE, s), dtype=xy.dtype, device=xy.device) + 0.5
            py, px = (t.reshape(1, -1, 1) for t in torch.meshgrid(rows, cols, indexing="ij"))
            zbuf = torch.full((b, py.shape[1]), _BIG, dtype=xy.dtype, device=xy.device)
            best = torch.full((b, py.shape[1]), n_faces, dtype=torch.long, device=xy.device)
            for ci in torch.nonzero(touch.any(0)).flatten().tolist():
                zmask = _chunk_depths(xy[:, ci], z[:, ci], px, py)
                zmask = torch.where(touch[:, ci, None, None], zmask, _BIG)
                zbest = zmask.amin(-1)
                hit = (zmask == zbest[..., None]) & (zbest < _BIG)[..., None]
                bid = torch.where(hit, ids[:, ci, None, :], n_faces).amin(-1)
                better = (zbest < zbuf) | ((zbest == zbuf) & (bid < best))
                zbuf = torch.where(better, zbest, zbuf)
                best = torch.where(better, bid, best)
            bestid[:, y0:y0 + _TILE, x0:x0 + _TILE] = best.reshape(b, len(rows), len(cols))
    table = torch.cat([face_tex, face_tex.new_zeros(1, c)], dim=0)
    return table[bestid]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library. Returns
    (library, compiler report)."""
    # no contracted products (and IEEE division, nvcc's default): every
    # rounding where the plain version has it
    lib, log = build("rasterizer.cu", ("-fmad=false",))
    lib.rasterize_flat.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_double]
                                   + [ctypes.c_void_p] * 6)
    lib.rasterize_flat.restype = ctypes.c_int
    return lib, log


def _kernel_takes(name, verts_px) -> bool:
    """Whether an entry runs the kernel: for an fp32 CUDA tensor. A CPU
    tensor and an fp64 one run the entry's plain version; another dtype on
    the card, or another device, raises."""
    if verts_px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {verts_px.device}")
    return verts_px.is_cuda and verts_px.dtype != torch.float64


def _launch(verts_px, faces, face_tex, out_size: int, orig_size: float, skip=None, ties_last=None,
            with_pairs=False):
    """Run csrc/rasterizer.cu on fp32 CUDA tensors. Returns (B, S, S, C) in
    face_tex's dtype, and with `with_pairs` also a (1,) int64 device tensor,
    the pairs the kernel enumerated (read it after the call: nothing here
    synchronizes)."""
    dt = verts_px.dtype
    if dt != torch.float32:
        raise TypeError(f"rasterizer kernel: unsupported dtype {dt}")
    if verts_px.dim() != 3 or verts_px.shape[-1] != 3:
        raise ValueError(f"rasterizer kernel: verts_px must be (B, V, 3), got {tuple(verts_px.shape)}")
    if faces.dim() != 2 or faces.shape[1] != 3 or face_tex.dim() != 2 \
            or face_tex.shape[0] != faces.shape[0]:
        raise ValueError(f"rasterizer kernel: faces {tuple(faces.shape)} / face_tex "
                         f"{tuple(face_tex.shape)} are not (F, 3) / (F, C)")
    b, v = verts_px.shape[:2]
    n_faces, c = face_tex.shape
    dev = verts_px.device
    masks = {k: m for k, m in (("skip", skip), ("ties_last", ties_last)) if m is not None}
    for name, t in (("faces", faces), ("face_tex", face_tex), *masks.items()):
        if t.device != dev:
            raise ValueError(f"rasterizer kernel: {name} on {t.device}, verts_px on {dev}")
    for name, m in masks.items():
        if tuple(m.shape) != (b, n_faces):
            raise ValueError(f"rasterizer kernel: {name} {tuple(m.shape)} is not (B, F) = {(b, n_faces)}")
    if b * n_faces >= 2 ** 31 or 2 * n_faces >= 2 ** 31 or (b + 1) * out_size ** 2 >= 2 ** 31 \
            or not 0 < out_size < 2 ** 15:
        raise ValueError("rasterizer kernel: B*F, 2F and (B+1)*S*S must fit an int32, and 0 < out_size < 2^15")
    verts_px = verts_px.contiguous()
    faces32 = faces.to(torch.int32).contiguous()
    tex = face_tex.to(dt).contiguous()
    codes = None   # bit 0: skip; bit 1: ties_last
    if masks:
        codes = torch.zeros((b, n_faces), dtype=torch.uint8, device=dev)
        if skip is not None:
            codes |= skip.to(torch.uint8)
        if ties_last is not None:
            codes |= ties_last.to(torch.uint8) << 1
    # scratch: an int4 span and a pair offset per (image, face), the image
    # totals and the z-buffer
    spans = torch.empty((b * n_faces, 4), dtype=torch.int32, device=dev)
    offsets = torch.empty(b * n_faces, dtype=torch.int64, device=dev)
    totals = torch.empty(b + 1, dtype=torch.int64, device=dev)
    zbuf = torch.empty(b * out_size * out_size, dtype=torch.int64, device=dev)
    out = torch.empty((b, out_size, out_size, c), dtype=dt, device=dev)
    lib, _ = load_library()
    with torch.cuda.device(dev):
        err = lib.rasterize_flat(
            verts_px.data_ptr(), faces32.data_ptr(), tex.data_ptr(),
            codes.data_ptr() if codes is not None else None, b, v, n_faces, out_size, c, out_size / orig_size,
            spans.data_ptr(), offsets.data_ptr(), totals.data_ptr(), zbuf.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: cudaError {err}")
    if with_pairs:
        return out.to(face_tex.dtype), totals[b:]
    return out.to(face_tex.dtype)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def rasterize_flat(verts_px, faces, face_tex, out_size: int, orig_size: float = 224.0,
                   chunk: int = 1024):
    """verts_px: (B, V, 3) pixel space (orig frame); faces: (F, 3) int;
    face_tex: (F, C). Returns (B, S, S, C) in face_tex's dtype, background
    0. `chunk` is the plain version's memory knob. Replaces K5's
    `rasterize_flat` and K2 `rasterize_flat_pallas`."""
    if not _kernel_takes("rasterize_flat", verts_px):
        return rasterize_flat_plain(verts_px, faces, face_tex, out_size, orig_size, chunk)
    out = _launch(verts_px, faces, face_tex, out_size, orig_size)
    rasterize_flat.launches += 1
    return out


def rasterize_flat_masked(verts_px, faces, face_tex, out_size: int, orig_size: float = 224.0,
                          cull_mask=None, chunk: int = 1024, ties_last=None):
    """`rasterize_flat` where faces marked in `cull_mask` (B, F) bool take
    no part. Replaces K4 `rasterize_flat_pallas_bandrange(..., cull_mask)`.
    `ties_last` (B, F) bool marks faces that lose exact-z ties to every
    unmarked face (the culled entry's filler faces)."""
    if not _kernel_takes("rasterize_flat_masked", verts_px):
        return rasterize_flat_plain(verts_px, faces, face_tex, out_size, orig_size, chunk, cull_mask,
                                    ties_last)
    out = _launch(verts_px, faces, face_tex, out_size, orig_size, cull_mask, ties_last)
    rasterize_flat_masked.launches += 1
    return out


def rasterize_flat_culled(verts_px, faces, face_tex, out_size: int, orig_size: float = 224.0,
                          chunk: int = 1024, budget_frac: float = 0.55):
    """Backface-culled raster for closed, consistently wound meshes (K5's
    `rasterize_flat_culled`): only the `cull_budget` lowest-id live faces
    take part; beyond that budget live faces are dropped silently (watch
    `IUVRenderer.live_fraction`). When the budget covers every face it is
    `rasterize_flat`, dead faces included. On the card: the kernel with
    `culled_face_sets`, through `rasterize_flat_masked`."""
    if not _kernel_takes("rasterize_flat_culled", verts_px):
        return rasterize_flat_culled_plain(verts_px, faces, face_tex, out_size, orig_size,
                                           chunk, budget_frac)
    budget = cull_budget(faces.shape[0], chunk, budget_frac)
    if budget >= faces.shape[0]:
        return rasterize_flat(verts_px, faces, face_tex, out_size, orig_size, chunk)
    skip, filler = culled_face_sets(verts_px, faces, budget)
    return rasterize_flat_masked(verts_px, faces, face_tex, out_size, orig_size, skip, chunk, filler)


def rasterize_flat_banded(verts_px, faces, face_tex, out_size: int, orig_size: float = 224.0,
                          chunk: int = 1024):
    """`rasterize_flat` through K3's design: faces in `band_setup` order,
    and each tile of pixels skips every chunk of faces whose extent misses
    it (the plain version; on the card, the pair kernel enumerates only the
    pixels in each face's box, in any face order). The same output as
    `rasterize_flat`, bit for bit. `chunk` is the plain
    version's chunk of faces. Replaces K3 `rasterize_flat_pallas_banded`."""
    if not _kernel_takes("rasterize_flat_banded", verts_px):
        return rasterize_flat_banded_plain(verts_px, faces, face_tex, out_size, orig_size, chunk)
    # the pair kernel's work does not depend on the order of the faces, and
    # on K3's y-order it measured no faster, before the sort's own time
    out = _launch(verts_px, faces, face_tex, out_size, orig_size)
    rasterize_flat_banded.launches += 1
    return out


rasterize_flat.launches = 0
rasterize_flat_masked.launches = 0
rasterize_flat_banded.launches = 0


class IUVRenderer:
    """GT IUV renderer: SMPL vertices + weak-perspective camera -> (B, S, S, 3)
    IUV image (I/24, U, V), background 0.

    backend names the JAX backend whose function is computed: 'xla'
    (`rasterize_flat`, or `rasterize_flat_culled` when culling), 'pallas'
    (`rasterize_flat`, no culling) or 'pallas_bandrange'
    (`rasterize_flat_masked` with `backface_mask` when culling). On a CUDA
    tensor every backend runs the kernel; on a CPU tensor, its plain
    version. cull_verts: template vertices (V, 3); when the faces orient
    with no conflicted edge, they are rewound outward and culling is on.
    """

    BACKENDS = ("xla", "pallas", "pallas_bandrange")

    def __init__(self, atlas: DensePoseAtlas, orig_size: int = 224, out_size: int = 56,
                 focal_length: float = FOCAL_LENGTH, backend: str = "xla", chunk: int = 1024,
                 cull_verts: np.ndarray | None = None, cull_budget_frac: float = 0.55):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown raster backend '{backend}' (supported: {self.BACKENDS})")
        self.atlas = atlas
        self.orig_size = float(orig_size)
        self.out_size = out_size
        self.focal_length = focal_length
        self.backend = backend
        self.chunk = chunk
        self.cull_budget_frac = float(cull_budget_frac)
        faces = atlas.faces
        self.cull = False
        if cull_verts is not None:
            oriented, conflicts = orient_faces(faces, np.asarray(cull_verts)[atlas.vert_mapping])
            if conflicts == 0:
                faces = oriented
                self.cull = True
            else:
                warnings.warn(
                    f"IUVRenderer: mesh orientation found {conflicts} conflicted edges; "
                    "backface culling disabled (exact rendering preserved)", stacklevel=2)
        self._host = {
            "vert_mapping": torch.as_tensor(atlas.vert_mapping.astype(np.int64)),
            "faces": torch.as_tensor(np.asarray(faces).astype(np.int64)),
            "face_tex": torch.as_tensor(atlas.face_textures),
        }
        self._on = {}

    def _tables(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = {k: v.to(device) for k, v in self._host.items()}
        return self._on[key]

    def project(self, verts, cam):
        """(the atlas tables on verts' device, atlas-order vertices, their
        pixel-space projection (B, V, 3))."""
        t = self._tables(verts.device)
        dp_verts = verts[:, t["vert_mapping"], :]
        return t, dp_verts, project_weak_perspective(dp_verts, cam, self.orig_size, self.focal_length)

    def live_fraction(self, verts, cam):
        """(B,) fraction of faces outside `dead_faces`; the culled raster
        drops live faces once this passes the budget."""
        t, _, verts_px = self.project(verts, cam)
        _, dead = dead_faces(verts_px, t["faces"])
        return 1.0 - dead.to(verts_px.dtype).mean(dim=-1)

    def __call__(self, verts, cam):
        """verts: (B, V, 3) SMPL vertices; cam: (B, 3). Returns (B, S, S, 3)
        in the atlas texture dtype (fp32)."""
        t, dp_verts, verts_px = self.project(verts, cam)
        faces, tex = t["faces"], t["face_tex"]
        args = (self.out_size, self.orig_size)
        if self.backend == "pallas":
            return rasterize_flat(verts_px, faces, tex, *args, self.chunk)
        if self.backend == "pallas_bandrange":
            mask = None
            if self.cull:
                mask = backface_mask(dp_verts, cam, faces, self.orig_size, self.focal_length)
            return rasterize_flat_masked(verts_px, faces, tex, *args, mask, self.chunk)
        if self.cull:
            return rasterize_flat_culled(verts_px, faces, tex, *args, self.chunk,
                                         self.cull_budget_frac)
        return rasterize_flat(verts_px, faces, tex, *args, self.chunk)


def _cross(a, b):
    """a x b over the last axis, each component a difference of two
    products taken as separate ops: the card rounds as the CPU does (no
    contraction into fused multiply-adds)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _dot3(a, b):
    """sum_i a_i b_i over a last axis of 3, as explicit products and sums
    (no TF32, no contraction)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def shaded_faces(verts, faces, cam, orig_size: float = 224.0, light_dir=(0.0, 0.0, -1.0),
                 ambient: float = 0.35, yaw_deg: float = 0.0):
    """`render_shaded`'s raster inputs: (verts_px (B, V, 3), the pixel-space
    projection after the optional yaw of `yaw_deg` about the mesh centre;
    shade (B, F), ambient + (1 - ambient) * |n . l| per face, double-sided).

    The rotation and the shading are explicit sums of products, so they
    never run in TF32 on the card. The mesh centre is summed in f64 and
    the shades are computed in f64, each then rounded to the vertices'
    dtype, so the card and the CPU agree on them (in fp32 the card's
    shades came an ulp off the CPU's on 4e-4 of the pixels); R is built
    from deg2rad(yaw) in the vertices' dtype, as JAX builds it (in fp32,
    cos(pi/2) is -4.4e-8)."""
    dtype = verts.dtype
    if yaw_deg:
        rad = torch.deg2rad(torch.tensor(float(yaw_deg), dtype=dtype))
        cy, sy = torch.cos(rad).item(), torch.sin(rad).item()
        center = verts.double().mean(dim=1, keepdim=True).to(dtype)
        x, y, z = (verts - center).unbind(-1)
        verts = torch.stack([x * cy + z * sy, y, z * cy - x * sy], dim=-1) + center
    tri = verts[:, faces, :].double()                                 # (B, F, 3, 3)
    n = _cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    n = n / torch.sqrt(_dot3(n, n)).clamp_min(1e-9)[..., None]
    light = torch.as_tensor(light_dir, dtype=torch.float64)
    light = (light / torch.linalg.norm(light)).to(verts.device)
    shade = ambient + (1.0 - ambient) * _dot3(n, light).abs()
    return project_weak_perspective(verts, cam, orig_size), shade.to(dtype)


def render_shaded(verts, faces, cam, out_size: int = 224, orig_size: float = 224.0,
                  light_dir=(0.0, 0.0, -1.0), ambient: float = 0.35, yaw_deg: float = 0.0,
                  chunk: int = 1024):
    """Lambert-shaded mesh render (the JAX `kernels/rasterizer.py::
    render_shaded`, the demo's shaded panels): flat per-face shading
    ambient + (1 - ambient) * |n . l| (double-sided), after an optional yaw
    of `yaw_deg` about the mesh centre for a side view (`shaded_faces`).
    verts: (B, V, 3) SMPL-space vertices; faces: (F, 3); cam: (B, 3).
    Returns (B, S, S) in [0, 1], background 0.

    One `rasterize_flat` call per image, as in JAX: each image has its own
    face shades, a 1-channel face texture. On a CUDA tensor each call is
    the raster kernel; on a CPU tensor, its plain version."""
    faces = torch.as_tensor(faces, device=verts.device).long()
    verts_px, shade = shaded_faces(verts, faces, cam, orig_size, light_dir, ambient, yaw_deg)
    outs = [rasterize_flat(verts_px[b:b + 1], faces, shade[b][:, None], out_size, orig_size, chunk)
            for b in range(verts.shape[0])]
    return torch.cat(outs, dim=0)[..., 0]
