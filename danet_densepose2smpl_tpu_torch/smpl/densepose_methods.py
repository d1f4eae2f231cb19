"""DensePose flip symmetry (port of the JAX package's
`smpl/densepose_methods.py`, reference `utils/densepose_methods.py`).

`get_symmetric_densepose` mirrors sparse IUV annotations and the 14-part
mask with the patch symmetry list and the per-patch UV symmetry transform
images (`UV_symmetry_transforms.mat`). The tables load from the official
.mat; `synthetic_uv_symmetry` is a chart-mirror stand-in that keeps
asset-free pipelines runnable. The surface lookups `iuv_to_face_bc` and
`fbc_to_surface` are not ported yet (ROADMAP item 18.3).

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
