"""Body-part / silhouette renderer for the LSP segmentation eval.

Port of the JAX package's `kernels/part_renderer.py`: one rasterizer pass
of the posed SMPL mesh at img_size x img_size with a 2-channel flat texture
[silhouette, part label] gives the foreground mask and the 6-part
segmentation of the reference's `utils/part_utils.py::PartRenderer`.
"""

from __future__ import annotations

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.constants import FOCAL_LENGTH
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import (
    project_weak_perspective,
    rasterize_flat,
    rasterize_flat_banded,
)
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel

# SMPL joint -> LSP 6-part label (1 head, 2 torso, 3 left arm, 4 right arm,
# 5 left leg, 6 right leg); used when the original cube_parts lookup is
# absent.
JOINT_TO_PART6 = np.array(
    [2, 5, 6, 2, 5, 6, 2, 5, 6, 2, 5, 6, 1, 3, 4, 1, 3, 4, 3, 4, 3, 4, 3, 4],
    dtype=np.int32,
)


def vertex_parts_from_lbs(model: SMPLModel) -> np.ndarray:
    """(V,) part labels 1..6 from each vertex's dominant LBS joint."""
    return JOINT_TO_PART6[np.asarray(model.lbs_weights).argmax(axis=1)]


def face_parts_from_assets(vertex_texture_file: str, cube_parts_file: str) -> np.ndarray:
    """(F,) part labels from the original SPIN assets: each face's constant
    RGB from vertex_texture.npy, floor(100 * rgb) looked up in the
    cube_parts.npy colour -> part cube (reference
    `utils/part_utils.py:17-21, 28-37`)."""
    tex = np.load(vertex_texture_file)
    cube = np.load(cube_parts_file)
    face_rgb = tex.reshape(tex.shape[1], -1, 3)[:, 0, :]       # (F, 3)
    idx = np.floor(100.0 * face_rgb).astype(np.int64)
    idx = np.clip(idx, 0, np.array(cube.shape[:3]) - 1)
    return cube[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.int32)


class PartRenderer:
    """SMPL vertices + weak-perspective camera -> (mask, parts) at
    img_size x img_size.

    `backend` names the JAX backend whose function is computed: 'auto' and
    'xla' run `rasterize_flat` (the JAX 'auto' picks the XLA scan), and
    'pallas_banded' runs `rasterize_flat_banded` (K3). Both compute the
    same image; on a CUDA tensor each launches its kernel, on a CPU tensor
    it runs its plain version. `face_parts` (from `face_parts_from_assets`)
    takes precedence over per-vertex labels (`vertex_parts`, else the
    LBS-argmax fallback) broadcast from each face's first corner."""

    BACKENDS = ("auto", "xla", "pallas_banded")

    def __init__(self, model: SMPLModel, vertex_parts: np.ndarray | None = None, img_size: int = 224,
                 focal_length: float = FOCAL_LENGTH, chunk: int = 2048, face_parts: np.ndarray | None = None,
                 backend: str = "auto"):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown part renderer backend '{backend}' (supported: {self.BACKENDS})")
        self.img_size = img_size
        self.focal_length = focal_length
        self.chunk = chunk
        self.backend = backend
        faces = np.asarray(model.faces)
        if face_parts is not None:
            face_part = np.asarray(face_parts, dtype=np.float32)
        else:
            parts = vertex_parts if vertex_parts is not None else vertex_parts_from_lbs(model)
            face_part = parts[faces[:, 0]].astype(np.float32)
        self._host = {"faces": torch.as_tensor(faces.astype(np.int64)),
                      "face_tex": torch.as_tensor(np.stack([np.ones_like(face_part), face_part], axis=1))}
        self._on = {}

    def _tables(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = {k: v.to(device) for k, v in self._host.items()}
        return self._on[key]

    def __call__(self, verts: torch.Tensor, cam: torch.Tensor):
        """verts (B, V, 3), cam (B, 3) -> (mask bool (B, S, S), parts int32
        (B, S, S))."""
        t = self._tables(verts.device)
        size = float(self.img_size)
        vpx = project_weak_perspective(verts, cam, size, self.focal_length)
        raster = rasterize_flat_banded if self.backend == "pallas_banded" else rasterize_flat
        img = raster(vpx, t["faces"], t["face_tex"], self.img_size, size, self.chunk)
        return img[..., 0] > 0.5, torch.round(img[..., 1]).to(torch.int32)
