"""The GT IUV raster of the training step, in plain PyTorch: a frozen copy
of the port's camera helpers, `rasterize_flat_plain`,
`rasterize_flat_culled_plain` and the `IUVRenderer` contract, without the
CUDA kernels. Pixel (row i, col j) of the S-out map has centre
(j + 0.5, i + 0.5) in out-map units; ties in z go to the lowest face id.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from port_bench.reference.constants import FOCAL_LENGTH
from port_bench.reference.smpl.densepose_atlas import DensePoseAtlas, orient_faces

_BIG = 1e9


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


class IUVRenderer:
    """GT IUV renderer: SMPL vertices + weak-perspective camera -> (B, S, S, 3)
    IUV image (I/24, U, V), background 0. With `cull_verts` (template
    vertices) whose faces orient with no conflicted edge, the faces are
    rewound outward and the culled raster runs; else the full one."""

    def __init__(self, atlas: DensePoseAtlas, orig_size: int = 224, out_size: int = 56,
                 focal_length: float = FOCAL_LENGTH, chunk: int = 1024,
                 cull_verts: np.ndarray | None = None, cull_budget_frac: float = 0.55):
        self.atlas = atlas
        self.orig_size = float(orig_size)
        self.out_size = out_size
        self.focal_length = focal_length
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
        if self.cull:
            return rasterize_flat_culled_plain(verts_px, faces, tex, *args, self.chunk,
                                               self.cull_budget_frac)
        return rasterize_flat_plain(verts_px, faces, tex, *args, self.chunk)
