"""SMPL arrays (numpy): model files and the synthetic body used where no
licensed model file is present.

Port of the JAX package's `smpl/loader.py`: `load_smpl_model` reads the
official `SMPL_*.pkl` (which pickles chumpy arrays and scipy sparse
matrices) without chumpy, or the `.npz` that `save_smpl_npz` writes;
`synthetic_smpl_model` gives the same arrays for the same seed (pinned by
tests). `to_torch` moves the arrays onto one device in one dtype.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.constants import JOINT_MAP_TO_EXTENDED
from danet_densepose2smpl_tpu_torch.ops.structure import NUM_SMPL_JOINTS

NUM_VERTS = 6890
NUM_SHAPE_BETAS = 10
NUM_POSE_BASIS = 9 * (NUM_SMPL_JOINTS - 1)  # 207
NUM_EXTRA_REGRESSED = 9   # SPIN's J_regressor_extra joints
NUM_VERTEX_JOINTS = 21    # face(5) + feet(6) + fingertips(10) surface joints

# Surface-vertex joint ids of the real 6890-vertex SMPL mesh, in output
# order: nose, reye, leye, rear, lear, LBigToe, LSmallToe, LHeel, RBigToe,
# RSmallToe, RHeel, then left and right fingertips (thumb..pinky).
SMPL_VERTEX_JOINT_IDS = np.array(
    [332, 6260, 2800, 4071, 583,
     3216, 3226, 3387, 6617, 6624, 6787,
     2746, 2319, 2445, 2556, 2673,
     6191, 5782, 5905, 6016, 6133],
    dtype=np.int32,
)


class SMPLModel(NamedTuple):
    """All arrays the LBS forward needs (numpy, or tensors after `to_torch`).

    Shapes (V = num vertices, usually 6890):
      v_template (V, 3); shapedirs (V, 3, 10); posedirs (V, 3, 207);
      J_regressor (24, V); lbs_weights (V, 24); faces (F, 3);
      vertex_joint_ids (21,); J_regressor_extra (9, V); joint_map (49,)
    """

    v_template: np.ndarray
    shapedirs: np.ndarray
    posedirs: np.ndarray
    J_regressor: np.ndarray
    lbs_weights: np.ndarray
    faces: np.ndarray
    vertex_joint_ids: np.ndarray
    J_regressor_extra: np.ndarray
    joint_map: np.ndarray

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]


def _to_dense(obj) -> np.ndarray:
    """Pickled chumpy arrays / scipy sparse matrices -> ndarray."""
    if hasattr(obj, "toarray"):  # scipy sparse
        return np.asarray(obj.toarray())
    if hasattr(obj, "x") and not isinstance(obj, np.ndarray):  # chumpy Ch
        return np.asarray(obj.x)
    return np.asarray(obj)


class _ChumpyFreeUnpickler(pickle.Unpickler):
    """Unpickles SMPL .pkl files without chumpy installed: a missing class
    becomes a shim that keeps its __dict__, from which `_to_dense` takes
    the ndarray (chumpy stores it as attribute `x`)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (), {"__setstate__": lambda self, s: self.__dict__.update(s)})


def load_smpl_model(path: str, j_regressor_extra_path: str | None = None,
                    gender: str | None = None) -> SMPLModel:
    """Load an SMPL model from a `.pkl` (official release) or `.npz` file.
    A directory resolves to `SMPL_{GENDER}.pkl` inside it (gender defaults
    to 'neutral')."""
    if os.path.isdir(path):
        path = os.path.join(path, f"SMPL_{(gender or 'neutral').upper()}.pkl")

    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=False))
        return SMPLModel(**{k: data[k] for k in SMPLModel._fields})

    with open(path, "rb") as f:
        raw = _ChumpyFreeUnpickler(io.BytesIO(f.read()), encoding="latin1").load()

    v_template = _to_dense(raw["v_template"]).astype(np.float32)
    shapedirs = _to_dense(raw["shapedirs"]).astype(np.float32)[..., :NUM_SHAPE_BETAS]
    posedirs = _to_dense(raw["posedirs"]).astype(np.float32).reshape(v_template.shape[0], 3, -1)
    if j_regressor_extra_path is not None:
        j_extra = np.load(j_regressor_extra_path).astype(np.float32)
    else:
        j_extra = np.zeros((NUM_EXTRA_REGRESSED, v_template.shape[0]), dtype=np.float32)
    return SMPLModel(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=_to_dense(raw["J_regressor"]).astype(np.float32),
        lbs_weights=_to_dense(raw["weights"]).astype(np.float32),
        faces=_to_dense(raw["f"]).astype(np.int32),
        vertex_joint_ids=SMPL_VERTEX_JOINT_IDS.copy(),
        J_regressor_extra=j_extra,
        joint_map=JOINT_MAP_TO_EXTENDED.copy(),
    )


def save_smpl_npz(model: SMPLModel, path: str) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in model._asdict().items()})


def to_torch(model: SMPLModel, device, dtype=torch.float32) -> SMPLModel:
    """The same model with float arrays as `dtype` tensors and integer arrays
    as int64 tensors, all on `device`."""
    def conv(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a, device=device).to(dtype)

    return SMPLModel(*(conv(a) for a in model))


def synthetic_smpl_model(num_verts: int = NUM_VERTS, seed: int = 0) -> SMPLModel:
    """A random but structurally valid SMPL model for tests and benches.

    Joint locations follow a plausible human-skeleton layout; vertices
    scatter around their governing joints; blend weights are a softmax over
    joint distance.
    """
    rng = np.random.RandomState(seed)

    # Rough T-pose skeleton (x right, y up, z forward), meters.
    joints = np.array(
        [
            [0.00, 0.00, 0.00],   # 0 pelvis
            [0.08, -0.06, 0.00],  # 1 l_hip
            [-0.08, -0.06, 0.00], # 2 r_hip
            [0.00, 0.11, 0.00],   # 3 spine1
            [0.10, -0.45, 0.00],  # 4 l_knee
            [-0.10, -0.45, 0.00], # 5 r_knee
            [0.00, 0.23, 0.00],   # 6 spine2
            [0.09, -0.85, -0.03], # 7 l_ankle
            [-0.09, -0.85, -0.03],# 8 r_ankle
            [0.00, 0.29, 0.00],   # 9 spine3
            [0.11, -0.91, 0.10],  # 10 l_foot
            [-0.11, -0.91, 0.10], # 11 r_foot
            [0.00, 0.48, 0.00],   # 12 neck
            [0.08, 0.40, 0.00],   # 13 l_collar
            [-0.08, 0.40, 0.00],  # 14 r_collar
            [0.00, 0.58, 0.02],   # 15 head
            [0.17, 0.42, 0.00],   # 16 l_shoulder
            [-0.17, 0.42, 0.00],  # 17 r_shoulder
            [0.43, 0.40, 0.00],   # 18 l_elbow
            [-0.43, 0.40, 0.00],  # 19 r_elbow
            [0.68, 0.40, 0.00],   # 20 l_wrist
            [-0.68, 0.40, 0.00],  # 21 r_wrist
            [0.76, 0.40, 0.00],   # 22 l_hand
            [-0.76, 0.40, 0.00],  # 23 r_hand
        ],
        dtype=np.float32,
    )

    owner = rng.randint(0, NUM_SMPL_JOINTS, size=num_verts)
    v_template = joints[owner] + rng.randn(num_verts, 3).astype(np.float32) * 0.05

    # J_regressor: rows average the vertices owned by each joint (sums to 1).
    J_regressor = np.zeros((NUM_SMPL_JOINTS, num_verts), dtype=np.float32)
    for j in range(NUM_SMPL_JOINTS):
        members = np.where(owner == j)[0]
        if members.size == 0:  # guarantee support
            members = rng.randint(0, num_verts, size=4)
        w = rng.rand(members.size).astype(np.float32)
        J_regressor[j, members] = w / w.sum()

    d = np.linalg.norm(v_template[:, None, :] - joints[None, :, :], axis=-1)
    lbs_weights = np.exp(-d / 0.07)
    # keep only 4 strongest influences like the real model
    cutoff = np.sort(lbs_weights, axis=1)[:, -4][:, None]
    lbs_weights = np.where(lbs_weights >= cutoff, lbs_weights, 0.0)
    lbs_weights = (lbs_weights / lbs_weights.sum(axis=1, keepdims=True)).astype(np.float32)

    shapedirs = (rng.randn(num_verts, 3, NUM_SHAPE_BETAS) * 0.01).astype(np.float32)
    posedirs = (rng.randn(num_verts, 3, NUM_POSE_BASIS) * 0.001).astype(np.float32)

    n_faces = max(num_verts * 2 - 4, 1)
    faces = rng.randint(0, num_verts, size=(n_faces, 3)).astype(np.int32)

    vertex_joint_ids = rng.choice(num_verts, size=NUM_VERTEX_JOINTS, replace=False).astype(np.int32)

    J_extra = np.zeros((NUM_EXTRA_REGRESSED, num_verts), dtype=np.float32)
    for j in range(NUM_EXTRA_REGRESSED):
        members = rng.choice(num_verts, size=8, replace=False)
        w = rng.rand(8).astype(np.float32)
        J_extra[j, members] = w / w.sum()

    return SMPLModel(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=J_regressor,
        lbs_weights=lbs_weights,
        faces=faces,
        vertex_joint_ids=vertex_joint_ids,
        J_regressor_extra=J_extra,
        joint_map=JOINT_MAP_TO_EXTENDED.copy(),
    )
