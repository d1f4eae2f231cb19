"""Loss assembly: DaNet outputs + batch GT -> total loss + per-term dict
(port of the JAX `train/objective.py`).

Batch keys (missing ones skip their terms): uv_image_gt (B, S, S, 3),
keypoints (B, 49, 3), pose_3d (B, 24, 4), target_smpl_kps (B, 24, 3),
target_cam (B, 3), opt_betas (B, 10), opt_rotmat (B, 24, 3, 3),
target_verts (B, V, 3), dp_dict, has_iuv / has_dp / has_pose_3d /
valid_fit (B,).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.config import DaNetConfig
from port_bench.reference.models import losses as L
from port_bench.reference.ops.imwarp import separable_crop_pixel_major
from port_bench.reference.ops.iuvmap import iuv_img2map
from port_bench.reference.ops.structure import DP2SMPL_MAPPING
from port_bench.reference.smpl.loader import SMPLModel
from port_bench.reference.smpl.model import smpl_forward


def _part_selection_tables():
    """One-hot channel-selection tables for `part_iuv_gt_crops`.

    Returns (M, Cnt): M (75, 24*21) maps the concatenated [u|v|i] 25-ch
    stacks to each part's flat 21-ch layout [u(7), v(7), i(7)] (slot 0 of
    u/v is the zero pad, slot 0 of i the background, filled separately;
    slots 1..6 the part's mapped patches); Cnt (25, 24) counts per part how
    many mapped index channels fire at a pixel (duplicates count twice).
    """
    mapping = np.asarray(DP2SMPL_MAPPING)
    n_parts, n_sel = mapping.shape
    c = 25
    m = np.zeros((3 * c, n_parts * 21), np.float32)
    cnt = np.zeros((c, n_parts), np.float32)
    for k in range(n_parts):
        for j in range(n_sel):
            m[mapping[k, j], k * 21 + 1 + j] = 1.0
            m[c + mapping[k, j], k * 21 + 8 + j] = 1.0
            m[2 * c + mapping[k, j], k * 21 + 15 + j] = 1.0
            cnt[mapping[k, j], k] += 1.0
    return m, cnt


_PART_SEL_M, _PART_SEL_CNT = _part_selection_tables()


def part_iuv_gt_crops(u_gt, v_gt, index_gt, theta, stop_grad: bool = True):
    """The 24-part simplified GT IUV crops with the predictor's STN thetas:
    per part its 6 mapped patch channels, a background channel (index stack
    only), cropped with the separable crop. The thetas are detached unless
    `stop_grad` is False (the 'iuv_gt' oracle's crops, through which the
    partial UV losses reach the trainable STN ratio/offset).

    u/v/index_gt: (B, S, S, 25); theta: (B, 24, 2, 3). Returns
    (B, 24, S, S, 3, 7)."""
    b, s = u_gt.shape[:2]
    dt, dev = u_gt.dtype, u_gt.device
    n_parts = _PART_SEL_CNT.shape[1]
    sel_m = torch.as_tensor(_PART_SEL_M, dtype=dt, device=dev)
    cnt_m = torch.as_tensor(_PART_SEL_CNT, dtype=dt, device=dev)
    uvi = torch.cat([u_gt, v_gt, index_gt], dim=-1)
    sel = torch.einsum("bhwc,cd->bhwd", uvi, sel_m).reshape(b, s, s, n_parts, 21)
    gi_sum = torch.einsum("bhwc,ck->bhwk", index_gt, cnt_m)
    bg = (gi_sum < 0.5).to(dt)
    sel = torch.cat([sel[..., :14], bg[..., None], sel[..., 15:]], dim=-1)
    if stop_grad:
        theta = theta.detach()
    centers = torch.stack([theta[..., 0, 2], theta[..., 1, 2]], dim=-1)
    crops = separable_crop_pixel_major(sel, centers, theta[..., 0, 0], s)
    return crops.reshape(b, n_parts, s, s, 3, 7)


def compute_losses(cfg: DaNetConfig, smpl: SMPLModel, out: dict, batch: dict,
                   pretrain_mode: bool = False, openpose_weight: float = 0.0,
                   gt_weight: float = 1.0):
    """Returns (total_loss, {name: value}) with the JAX package's names.
    `smpl` holds tensors on the batch's device (`smpl.loader.to_torch`)."""
    losses = {}
    raw = out["iuv_raw"]
    has_iuv = batch["has_iuv"]

    if "uv_image_gt" in batch:
        u_g, v_g, i_g, a_g = iuv_img2map(batch["uv_image_gt"])
        lu, lv, li, la = L.body_uv_losses(raw["u"], raw["v"], raw["index"], raw["ann"],
                                          u_g, v_g, i_g, a_g, has_iuv, cfg)
        losses.update(loss_U=lu, loss_V=lv, loss_IndexUV=li, loss_segAnn=la)
        if cfg.decomposed and "stn_theta" in raw:
            part_gt = part_iuv_gt_crops(u_g, v_g, i_g, raw["stn_theta"])
            lpu, lpv, lpi = L.partial_uv_losses(raw["part_iuv"], part_gt, has_iuv, cfg)
            losses.update(loss_pU=lpu, loss_pV=lpv, loss_pIndexUV=lpi)

    if "dp_dict" in batch:
        ldu, ldv, ldi, lda = L.dp_uvia_losses(raw["u"], raw["v"], raw["index"], raw["ann"],
                                              batch["dp_dict"], batch["has_dp"], cfg)
        losses.update(loss_Udp=ldu, loss_Vdp=ldv, loss_IndexUVdp=ldi, loss_segAnndp=lda)

    if cfg.decomposed and cfg.stn_kps_weights > 0 and "target_smpl_kps" in batch:
        losses["loss_roi"] = L.stn_losses(raw["stn_centers"], batch["target_smpl_kps"], cfg)
    if cfg.decomposed and cfg.stn_hm_weights > 0 and "target_smpl_kps" in batch and "heatmaps" in raw:
        losses["loss_stnhm"] = L.stn_heatmap_loss(raw["heatmaps"], batch["target_smpl_kps"], cfg)

    if pretrain_mode:
        return sum(losses.values()), losses

    pred_rotmat, pred_betas, pred_cam = out["pred_rotmat"], out["pred_shape"], out["pred_cam"]
    has_smpl = batch["valid_fit"]
    gt_rotmat, gt_betas = batch["opt_rotmat"], batch["opt_betas"]

    lp, lb = L.smpl_param_losses(pred_rotmat, pred_betas, gt_rotmat, gt_betas, has_smpl, cfg)
    losses.update(smpl_pose=lp, smpl_betas=lb)
    if cfg.orthogonal_weights > 0:
        losses["Rs_orth"] = L.orthogonal_loss(pred_rotmat, cfg)

    smpl_out = smpl_forward(smpl, pred_betas, pred_rotmat)
    kp2d = L.reproject(smpl_out.joints, pred_cam, float(cfg.img_size))
    losses["keypoints_2d"] = (L.keypoint_2d_loss(kp2d, batch["keypoints"], openpose_weight, gt_weight)
                              * cfg.proj_kps_weights)
    if "pose_3d" in batch:
        losses["keypoints_3d"] = (L.keypoint_3d_loss(smpl_out.joints, batch["pose_3d"],
                                                     batch["has_pose_3d"]) * cfg.kps3d_weights)
    if cfg.verts_weights > 0 and "target_verts" in batch:
        losses["smpl_verts"] = (L.vertex_loss(smpl_out.vertices, batch["target_verts"], has_smpl)
                                * cfg.verts_weights)
    losses["cam"], losses["cam_depth"] = L.cam_losses(pred_cam, batch["target_cam"], has_smpl)

    gt_rot_flat = gt_rotmat.reshape(gt_rotmat.shape[0], -1)
    for i, jr in enumerate(out.get("joint_rotation", [])):
        losses[f"joint_rotation{i}"] = L.aux_rotation_loss(jr, gt_rot_flat, has_smpl, cfg)
    jps = out.get("joint_position", [])
    if jps and cfg.joint_position_weights > 0:
        gt_joints = smpl_forward(smpl, gt_betas.detach(), gt_rotmat.detach()).smpl_joints
        for i, jp in enumerate(jps):
            losses[f"joint_position{i}"] = L.aux_position_loss(jp, gt_joints, has_smpl, cfg)

    return sum(losses.values()), losses
