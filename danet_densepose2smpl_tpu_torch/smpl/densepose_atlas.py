"""DensePose surface atlas (numpy): the re-indexed SMPL mesh with a patch
index and UV chart coordinates per face.

Copy of the JAX package's `smpl/densepose_atlas.py`: `DensePoseAtlas`
with its flat per-face texture (I/24, mean U, mean V), the loader of the
official `UV_Processed.mat`, `orient_faces`, the closed test mesh and the
synthetic atlases. Tests pin every table equal to the original.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from danet_densepose2smpl_tpu_torch.ops.structure import SMPL2DP_PART
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel


class DensePoseAtlas(NamedTuple):
    vert_mapping: np.ndarray   # (Nd,) int32 indices into SMPL vertices
    faces: np.ndarray          # (F, 3) int32 over the Nd re-indexed verts
    face_indices: np.ndarray   # (F,) int32 patch id 1..24
    u_norm: np.ndarray         # (Nd,) float32
    v_norm: np.ndarray         # (Nd,) float32

    @property
    def face_textures(self) -> np.ndarray:
        """(F, 3) flat texture (I/24, mean U, mean V) per face."""
        num_part = float(self.face_indices.max())
        u = self.u_norm[self.faces].mean(axis=1)
        v = self.v_norm[self.faces].mean(axis=1)
        return np.stack([self.face_indices / num_part, u, v], axis=1).astype(np.float32)


def orient_faces(faces: np.ndarray, verts: np.ndarray) -> tuple[np.ndarray, int]:
    """Return `(faces, conflicts)`: the face table rewound to a globally
    consistent outward winding, and the number of edges whose two incident
    faces could not be made consistent (0 on an orientable mesh; callers
    must treat nonzero as "culling unsafe").

    Winding consistency is what makes projected-signed-area backface culling
    valid in the rasterizer (kernels/rasterizer.py, culled entries); the
    official DensePose face table does not guarantee it. Orientation is
    propagated across shared edges (two adjacent faces must traverse their
    common edge in opposite directions), component by component, then each
    connected component is flipped so its signed volume w.r.t. the given
    reference vertices is positive (outward normals under the right-hand
    rule). Pure numpy, one-time at atlas build. Corner order within a face
    carries no other meaning here: flat textures are corner-order invariant
    and barycentric lookups stay paired with the reordered corners.
    """
    faces = np.asarray(faces, dtype=np.int64).copy()
    f = len(faces)
    # edge -> incident faces
    from collections import defaultdict

    edge2faces = defaultdict(list)
    for i, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            edge2faces[(min(u, v), max(u, v))].append(i)

    def directed_edges(tri):
        a, b, c = tri
        return ((a, b), (b, c), (c, a))

    visited = np.zeros(f, dtype=bool)
    component = np.full(f, -1, dtype=np.int64)
    n_comp = 0
    for seed in range(f):
        if visited[seed]:
            continue
        stack = [seed]
        visited[seed] = True
        component[seed] = n_comp
        while stack:
            i = stack.pop()
            own = set(directed_edges(faces[i]))
            for u, v in own:
                key = (min(u, v), max(u, v))
                for j in edge2faces[key]:
                    if j == i or visited[j]:
                        continue
                    # consistent orientation: neighbor must traverse the
                    # shared edge in the OPPOSITE direction
                    if (u, v) in directed_edges(faces[j]):
                        faces[j] = faces[j][::-1]
                    visited[j] = True
                    component[j] = n_comp
                    stack.append(j)
        n_comp += 1

    # flip whole components to positive signed volume (outward winding)
    tri = verts[faces]                                          # (F, 3, 3)
    vol6 = np.einsum("fi,fi->f", tri[:, 0], np.cross(tri[:, 1], tri[:, 2]))
    for comp in range(n_comp):
        sel = component == comp
        if vol6[sel].sum() < 0:
            faces[sel] = faces[sel][:, ::-1]

    # consistency audit: every manifold edge (exactly 2 incident faces) must
    # be traversed in opposite directions. Conflicts mean the mesh is
    # non-orientable or non-manifold there — callers should not backface-cull
    # with a conflicted orientation.
    conflicts = 0
    for (u, v), inc in edge2faces.items():
        if len(inc) != 2:
            conflicts += len(inc) > 2  # non-manifold edge
            continue
        d0 = (u, v) in directed_edges(faces[inc[0]])
        d1 = (u, v) in directed_edges(faces[inc[1]])
        conflicts += d0 == d1
    return faces.astype(np.int32), int(conflicts)


def load_densepose_atlas(mat_path: str) -> DensePoseAtlas:
    """Load the official UV_Processed.mat (scipy)."""
    from scipy.io import loadmat

    d = loadmat(mat_path)
    return DensePoseAtlas(
        vert_mapping=(d["All_vertices"].reshape(-1).astype(np.int64) - 1).astype(np.int32),
        faces=d["All_Faces"].astype(np.int32) - 1,
        face_indices=d["All_FaceIndices"].reshape(-1).astype(np.int32),
        u_norm=d["U_norm"].reshape(-1).astype(np.float32),
        v_norm=d["V_norm"].reshape(-1).astype(np.float32),
    )


def closed_test_mesh(num_verts: int = 6890, seed: int = 0):
    """(verts (V, 3), faces (F, 3)) — a closed orientable 2-manifold
    (UV-sphere topology, radii perturbed into a body-ish ellipsoid).

    The synthetic SMPL model's faces are a random triangle soup (fine for
    LBS/texture plumbing, meaningless as a surface), so backface culling —
    which is exact only on closed meshes — needs this fixture to be
    testable/benchable without the real watertight SMPL mesh (6890 verts,
    13776 faces, V−E+F=2). F here = 2*(rows−1)*cols ≈ 2*num_verts − O(√V),
    matching the real mesh's face/vertex ratio."""
    rng = np.random.RandomState(seed)
    # rows*cols + 2 poles ≈ num_verts
    rows = max(3, int(np.sqrt(max(num_verts - 2, 4))))
    cols = max(3, (num_verts - 2) // rows)
    theta = np.linspace(0, np.pi, rows + 2)[1:-1]              # exclude poles
    phi = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    r = 1.0 + 0.15 * rng.randn(rows, cols)                     # bumpy sphere
    # smooth the bumps a little so the surface stays embedded (no overlap)
    r = (r + np.roll(r, 1, 0) + np.roll(r, -1, 0) + np.roll(r, 1, 1) + np.roll(r, -1, 1)) / 5.0
    x = r * np.sin(t) * np.cos(p) * 0.35                       # body-ish extents
    y = r * np.cos(t) * 0.9
    z = r * np.sin(t) * np.sin(p) * 0.2
    grid = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    top = np.array([[0.0, 1.05, 0.0]])
    bot = np.array([[0.0, -1.05, 0.0]])
    verts = np.concatenate([grid, top, bot]).astype(np.float32)
    i_top, i_bot = len(grid), len(grid) + 1

    def vid(i, j):
        return i * cols + (j % cols)

    faces = []
    for i in range(rows - 1):
        for j in range(cols):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            faces.append((a, b, c))
            faces.append((b, d, c))
    for j in range(cols):  # pole caps
        faces.append((i_top, vid(0, j + 1), vid(0, j)))
        faces.append((i_bot, vid(rows - 1, j), vid(rows - 1, j + 1)))
    return verts, np.asarray(faces, dtype=np.int32)


def synthetic_densepose_atlas(model: SMPLModel, seed: int = 0) -> DensePoseAtlas:
    """Structurally valid atlas derived from an SMPL model: identity vertex
    mapping, the model's faces, patch ids from each face's dominant LBS
    joint (via SMPL2DP_PART), random chart UVs."""
    rng = np.random.RandomState(seed)
    nv = model.num_verts
    owner_joint = model.lbs_weights.argmax(axis=1)          # (V,)
    joint2patch = np.array([parts[0] for parts in SMPL2DP_PART], dtype=np.int32)
    face_owner = owner_joint[model.faces[:, 0]]
    return DensePoseAtlas(
        vert_mapping=np.arange(nv, dtype=np.int32),
        faces=model.faces.astype(np.int32),
        face_indices=joint2patch[face_owner],
        u_norm=rng.rand(nv).astype(np.float32),
        v_norm=rng.rand(nv).astype(np.float32),
    )


def closed_synthetic_atlas(num_verts: int = 6890, seed: int = 0):
    """(DensePoseAtlas, template verts (V, 3)) over `closed_test_mesh` — the
    culling-valid counterpart of `synthetic_densepose_atlas` (whose random
    triangle soup can never legitimately enable backface culling). Same
    vertex/face counts as the real watertight SMPL mesh at the default size
    (6890 verts, 13776 faces), so rasterizer benchmarks on it are
    shape-faithful to production with real assets. Patch ids 1..24 are
    assigned by vertical body band (any valid id layout works for the IUV
    texture plumbing); chart UVs are random like the soup atlas's."""
    rng = np.random.RandomState(seed)
    verts, faces = closed_test_mesh(num_verts, seed=seed)
    nv = len(verts)
    y = verts[faces[:, 0], 1]
    band = np.clip(((y - y.min()) / max(np.ptp(y), 1e-6) * 24).astype(np.int32), 0, 23)
    return DensePoseAtlas(
        vert_mapping=np.arange(nv, dtype=np.int32),
        faces=faces,
        face_indices=band + 1,
        u_norm=rng.rand(nv).astype(np.float32),
        v_norm=rng.rand(nv).astype(np.float32),
    ), verts
