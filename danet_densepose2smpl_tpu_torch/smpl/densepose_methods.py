"""DensePose flip symmetry (port of the JAX package's
`smpl/densepose_methods.py`, reference `utils/densepose_methods.py`).

`get_symmetric_densepose` mirrors sparse IUV annotations and the 14-part
mask with the patch symmetry list and the per-patch UV symmetry transform
images (`UV_symmetry_transforms.mat`). The tables load from the official
.mat; `synthetic_uv_symmetry` is a chart-mirror stand-in that keeps
asset-free pipelines runnable. The surface lookups `iuv_to_face_bc`
(chart point -> face and barycentrics) and `fbc_to_surface` (-> a 3D
point on the SMPL surface) are numpy copies of the JAX functions.

Warnings here are `warnings.warn` at one place each, so Python's default
filter shows each once per process.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np

# Left/right patch swaps (1-based patch ids), and 14-part mask label swaps
# (reference densepose_methods.py:26-28).
INDEX_SYMMETRY = np.array(
    [1, 2, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 18, 17, 20, 19, 22, 21, 24, 23],
    dtype=np.int32,
)
MASK_SYMMETRY = np.array([0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 14], dtype=np.int32)


class UVSymmetry(NamedTuple):
    u_transforms: np.ndarray  # (24, 256, 256)
    v_transforms: np.ndarray  # (24, 256, 256)
    # True for the chart-mirror stand-in (NOT real chart correspondence);
    # flipping with it warns, or raises under DANET_STRICT_DP_SYMMETRY=1.
    synthetic: bool = False


def load_uv_symmetry(mat_path: str) -> UVSymmetry:
    """Load the official `UV_symmetry_transforms.mat` (24 per-patch 256x256
    U/V lookup images, reference densepose_methods.py:29-30)."""
    from scipy.io import loadmat

    d = loadmat(mat_path)
    u = np.stack([np.asarray(d["U_transforms"][0, i]) for i in range(24)])
    v = np.stack([np.asarray(d["V_transforms"][0, i]) for i in range(24)])
    return UVSymmetry(u.astype(np.float32), v.astype(np.float32))


def find_uv_symmetry(path: str | None = None) -> UVSymmetry | None:
    """Resolve the official symmetry table: explicit `path` (raises when
    missing), then the DANET_UV_SYMMETRY environment variable, then the
    reference's location `data/UV_data/UV_symmetry_transforms.mat`.
    Returns None, with a warning that DP flip augmentation is off, when no
    table exists."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"UV symmetry table not found: {path}")
        return load_uv_symmetry(path)
    for cand in (os.environ.get("DANET_UV_SYMMETRY"), os.path.join("data", "UV_data", "UV_symmetry_transforms.mat")):
        if cand and os.path.exists(cand):
            return load_uv_symmetry(cand)
    warnings.warn(
        "UV_symmetry_transforms.mat not found (checked $DANET_UV_SYMMETRY and "
        "data/UV_data/). DensePose samples will NOT be flip-augmented; pass "
        "--uv_symmetry_path or set DANET_UV_SYMMETRY to restore reference "
        "augmentation parity.", stacklevel=2)
    return None


def synthetic_uv_symmetry() -> UVSymmetry:
    """Chart-mirror stand-in: U -> 1-U, V unchanged, per patch. NOT the
    true DensePose chart correspondence; tagged `synthetic=True` so the
    flip path warns or raises instead of silently producing wrong UV
    targets."""
    uu = np.linspace(0, 1, 256, dtype=np.float32)
    u_t = np.tile(1.0 - uu[None, :], (256, 1))        # value at (v_loc, u_loc)
    v_t = np.tile(np.linspace(0, 1, 256, dtype=np.float32)[:, None], (1, 256))
    return UVSymmetry(np.tile(u_t, (24, 1, 1)), np.tile(v_t, (24, 1, 1)), synthetic=True)


def get_symmetric_densepose(I, U, V, x, y, mask, sym: UVSymmetry):
    """Mirror sparse DensePose point annotations + the 256x256 part mask
    (reference densepose_methods.py:31-58). x is in bbox-relative 0..255."""
    if sym.synthetic:
        if os.environ.get("DANET_STRICT_DP_SYMMETRY") == "1":
            raise RuntimeError(
                "refusing to flip DensePose annotations with the synthetic "
                "chart-mirror table under DANET_STRICT_DP_SYMMETRY=1; supply "
                "the official UV_symmetry_transforms.mat")
        warnings.warn(
            "flipping DensePose annotations with the synthetic chart-mirror "
            "table: U->1-U is NOT the true chart correspondence; UV flip "
            "targets will deviate from the reference. Supply the official "
            "UV_symmetry_transforms.mat for parity.", stacklevel=2)
    I = np.asarray(I)
    U = np.asarray(U)
    V = np.asarray(V)
    I_sym = np.zeros_like(I)
    U_sym = np.zeros_like(U, dtype=np.float64)
    V_sym = np.zeros_like(V, dtype=np.float64)
    for patch in range(1, 25):
        sel = I == patch
        if not sel.any():
            continue
        I_sym[sel] = INDEX_SYMMETRY[patch - 1]
        u_loc = np.clip((U[sel] * 255).astype(np.int64), 0, 255)
        v_loc = np.clip((V[sel] * 255).astype(np.int64), 0, 255)
        U_sym[sel] = sym.u_transforms[patch - 1][v_loc, u_loc]
        V_sym[sel] = sym.v_transforms[patch - 1][v_loc, u_loc]

    mask_flip = np.fliplr(mask)
    mask_out = MASK_SYMMETRY[mask_flip]
    x_sym = mask_flip.shape[1] - np.asarray(x)
    return I_sym, U_sym, V_sym, x_sym, np.asarray(y), mask_out.astype(mask.dtype)


def iuv_to_face_bc(atlas, i_point: int, u_point: float, v_point: float):
    """Chart (I, U, V) -> (face index, barycentric coords), vectorized over
    the patch's faces: the first face whose 2D triangle holds the point,
    else the face of the nearest corner, with that corner's coordinate 1
    (reference IUV2FBC, densepose_methods.py:99-132). `atlas` is a
    `DensePoseAtlas`."""
    face_ids = np.flatnonzero(atlas.face_indices == i_point)
    tris = atlas.faces[face_ids]                               # (F, 3)
    pu = atlas.u_norm[tris]
    pv = atlas.v_norm[tris]
    p = np.array([u_point, v_point])

    a = np.stack([pu[:, 0], pv[:, 0]], axis=1)
    b = np.stack([pu[:, 1], pv[:, 1]], axis=1)
    c = np.stack([pu[:, 2], pv[:, 2]], axis=1)
    v0 = b - a
    v1 = c - a
    v2 = p[None, :] - a
    d00 = (v0 * v0).sum(1)
    d01 = (v0 * v1).sum(1)
    d11 = (v1 * v1).sum(1)
    d20 = (v2 * v0).sum(1)
    d21 = (v2 * v1).sum(1)
    denom = d00 * d11 - d01 * d01
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    r = (d11 * d20 - d01 * d21) / denom
    t = (d00 * d21 - d01 * d20) / denom
    inside = (r >= 0) & (t >= 0) & (r + t <= 1)
    if inside.any():
        k = int(np.flatnonzero(inside)[0])
        return int(face_ids[k]), float(1 - r[k] - t[k]), float(r[k]), float(t[k])

    d = np.stack([((a - p) ** 2).sum(1), ((b - p) ** 2).sum(1), ((c - p) ** 2).sum(1)])   # (3, F)
    corner, k = np.unravel_index(np.argmin(d), d.shape)
    bc = np.zeros(3)
    bc[corner] = 1.0
    return int(face_ids[k]), float(bc[0]), float(bc[1]), float(bc[2])


def fbc_to_surface(atlas, face_index: int, bc, vertices: np.ndarray) -> np.ndarray:
    """(face, barycentrics) + SMPL vertices (V, 3) -> the 3D surface point
    (reference FBC2PointOnSurface, densepose_methods.py:134-142)."""
    vert_ids = atlas.vert_mapping[atlas.faces[face_index]]
    return (vertices[vert_ids] * np.asarray(bc)[:, None]).sum(axis=0)
