"""Batched SMPL forward (blendshapes + joint regression + LBS).

Counterpart of the JAX package's `smpl/model.py::smpl_forward` and
`smpl_forward_aa`. It runs in
the dtype of `betas` (fp32 when serving, f64 in the parity tests); the
millimeter accuracy budget rules out TF32, which PyTorch's matmuls leave off
unless a caller turns it on.

Output convention:
  vertices     (B, V, 3)
  joints       (B, 49, 3)  — SPIN 49-joint superset via joint_map
  smpl_joints  (B, 24, 3)  — the native kinematic joints (posed)
  joints_j19   (B, 19, 3)  — J24_TO_J19 subset of the GT 24
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from danet_densepose2smpl_tpu_torch.constants import J24_TO_J19
from danet_densepose2smpl_tpu_torch.ops.rotations import batch_rodrigues
from danet_densepose2smpl_tpu_torch.ops.structure import NUM_SMPL_JOINTS, SMPL_PARENT, device_table
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor
    joints: torch.Tensor
    smpl_joints: torch.Tensor
    joints_j19: torch.Tensor


def _rigid_transforms(rotmats: torch.Tensor, joints: torch.Tensor):
    """Forward-kinematics skinning transforms (B, 24, 3, 4) and the posed
    joint positions (B, 24, 3). rotmats: (B, 24, 3, 3) local rotations;
    joints: (B, 24, 3) rest joint locations."""
    parents = [int(p) for p in SMPL_PARENT]   # host ints for the chain below
    parent = device_table(SMPL_PARENT, joints.device)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parent[1:]]], dim=1)

    world_rot = [rotmats[:, 0]]
    world_t = [joints[:, 0]]
    for j in range(1, NUM_SMPL_JOINTS):
        p = parents[j]
        world_rot.append(world_rot[p] @ rotmats[:, j])
        world_t.append((world_rot[p] @ rel[:, j, :, None])[..., 0] + world_t[p])
    R_w = torch.stack(world_rot, dim=1)
    t_w = torch.stack(world_t, dim=1)

    # map rest-space points: subtract the rest joints rotated into the frame
    t_skin = t_w - (R_w @ joints[..., None])[..., 0]
    return torch.cat([R_w, t_skin[..., None]], dim=-1), t_w


def smpl_forward(
    model: SMPLModel,
    betas: torch.Tensor,
    rotmats: torch.Tensor,
    transl: torch.Tensor | None = None,
) -> SMPLOutput:
    """SMPL forward from rotation matrices.

    model: arrays as tensors (`smpl.loader.to_torch`) on the inputs' device;
    betas: (B, 10); rotmats: (B, 24, 3, 3) (joint 0 = global orient);
    transl: optional (B, 3) root translation.
    """
    dt = betas.dtype
    v_template = model.v_template.to(dt)
    b = betas.shape[0]

    # 1) shape blendshapes; 2) rest-pose joints
    v_shaped = v_template + torch.einsum("vck,bk->bvc", model.shapedirs.to(dt), betas)
    joints_rest = torch.einsum("jv,bvc->bjc", model.J_regressor.to(dt), v_shaped)

    # 3) pose blendshapes from the non-root rotations
    eye = torch.eye(3, dtype=dt, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(b, -1)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", model.posedirs.to(dt), pose_feat)

    # 4) kinematic chain + 5) linear blend skinning
    A, joints_world = _rigid_transforms(rotmats, joints_rest)
    T = torch.einsum("vj,bjcd->bvcd", model.lbs_weights.to(dt), A)
    verts = (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]

    if transl is not None:
        verts = verts + transl[:, None, :]
        joints_world = joints_world + transl[:, None, :]

    # 6) extended joint set: 24 kinematic + 21 surface + 9 extra-regressed,
    # then the 49-joint selection
    vertex_joints = verts[:, model.vertex_joint_ids]
    extra = torch.einsum("jv,bvc->bjc", model.J_regressor_extra.to(dt), verts)
    all_joints = torch.cat([joints_world, vertex_joints, extra], dim=1)
    joints49 = all_joints[:, model.joint_map]
    joints_j19 = joints49[:, 25:][:, device_table(J24_TO_J19, verts.device)]

    return SMPLOutput(
        vertices=verts, joints=joints49, smpl_joints=joints_world, joints_j19=joints_j19,
    )


def smpl_forward_aa(model: SMPLModel, betas: torch.Tensor, pose_aa: torch.Tensor,
                    transl: torch.Tensor | None = None) -> SMPLOutput:
    """SMPL forward from a 72-dim axis-angle pose (global orient first)."""
    b = pose_aa.shape[0]
    rotmats = batch_rodrigues(pose_aa.reshape(b * NUM_SMPL_JOINTS, 3))
    return smpl_forward(model, betas, rotmats.reshape(b, NUM_SMPL_JOINTS, 3, 3), transl)
