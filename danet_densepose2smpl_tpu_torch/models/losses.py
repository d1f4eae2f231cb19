"""Training losses, mask-weighted over the fixed-shape batch (port of the
JAX `models/losses.py`, every function).

Maps are channels-last (B, H, W, C); validity flags are {0, 1} float masks
of shape (B,), and each loss keeps the reference's normalization with the
valid-sample restriction expressed as weights.

Inside `parallel.data_parallel(mesh)` each rank holds rows of the global
batch and every loss here is this rank's *share* of the global batch's
loss: a masked mean divides this rank's numerator by the denominator summed
over the ranks (`_safe_div`), a mean or a per-sample average divides by the
global count (`_mean`, `_global_batch`). The shares sum to the
single-process loss of the global batch, and so do their gradients.
"""

from __future__ import annotations

import torch

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.ops.imwarp import grid_sample_bilinear
from danet_densepose2smpl_tpu_torch.ops.keypoints import gaussian_heatmaps
from danet_densepose2smpl_tpu_torch.ops.projection import perspective_projection
from danet_densepose2smpl_tpu_torch.parallel.mesh import global_sum, world_size


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def _safe_div(num, den):
    """num / den, den summed over the ranks of a data-parallel step."""
    return num / torch.clamp_min(global_sum(den), 1e-12)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch (this rank's share of it)."""
    return x.sum() / (x.numel() * world_size())


def _global_batch(x: torch.Tensor) -> int:
    """The number of samples in the global batch of per-sample `x`."""
    return x.shape[0] * world_size()


def cross_entropy_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element CE with integer labels over the last logits axis, as a
    one-hot contraction. A label outside [0, K) selects nothing and gives
    CE = 0 (ignored, not clamped), which `F.cross_entropy` does not do."""
    logp = torch.log_softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    oh = (labels[..., None] == classes).to(logp.dtype)
    return -(logp * oh).sum(dim=-1)


def body_uv_losses(u_pred, v_pred, index_pred, ann_pred, u_gt, v_gt, index_gt, ann_gt,
                   has_iuv, cfg: DaNetConfig):
    """Dense IUV losses against the rendered GT: U/V smooth-l1 summed over
    foreground pixels of valid samples / full batch size; index and ann CE
    averaged over all pixels of valid samples. `index_gt` is one-hot."""
    b = _global_batch(u_pred)
    wpix = has_iuv.to(u_pred.dtype)[:, None, None]
    fg = (index_gt > 0).to(u_pred.dtype)
    loss_u = (smooth_l1(u_pred - u_gt) * fg * wpix[..., None]).sum() / b
    loss_v = (smooth_l1(v_pred - v_gt) * fg * wpix[..., None]).sum() / b

    ce_i = cross_entropy_int(index_pred, torch.argmax(index_gt, dim=-1))
    loss_index = _safe_div((ce_i * wpix).sum(), wpix.sum() * ce_i.shape[1] * ce_i.shape[2])
    loss_u = loss_u * cfg.point_regression_weights
    loss_v = loss_v * cfg.point_regression_weights

    loss_ann = None
    if ann_pred is not None:
        ce_a = cross_entropy_int(ann_pred, torch.argmax(ann_gt, dim=-1))
        loss_ann = _safe_div((ce_a * wpix).sum(), wpix.sum() * ce_a.shape[1] * ce_a.shape[2])
    return loss_u, loss_v, loss_index, loss_ann


def partial_uv_losses(part_pred, part_gt, has_iuv, cfg: DaNetConfig):
    """Per-part IUV losses averaged over the 24 parts. part_pred/part_gt:
    (B, 24, S, S, 3, 7); parts fold into the row axis."""
    b, p, s, _, _, k = part_pred.shape
    u_p, v_p, i_p = (part_pred[..., j, :].reshape(b, p * s, s, k) for j in range(3))
    u_g, v_g, i_g = (part_gt[..., j, :].reshape(b, p * s, s, k) for j in range(3))
    lu, lv, li, _ = body_uv_losses(u_p, v_p, i_p, None, u_g, v_g, i_g, None, has_iuv, cfg)
    return lu / p, lv / p, li


def dp_uvia_losses(u_pred, v_pred, index_pred, ann_pred, dp: dict, has_dp, cfg: DaNetConfig):
    """Sparse DensePose point losses: x, y (B, N) in heatmap pixels,
    i_points (B, N), u_points / v_points / point_weights (B, 25, N),
    ann_labels (B, H, W)."""
    hm = cfg.heatmap_size
    w = has_dp.to(u_pred.dtype)
    npts = dp["x"].shape[1]
    gx = (dp["x"] - hm / 2.0) * (2.0 / hm)
    gy = (dp["y"] - hm / 2.0) * (2.0 / hm)
    grid = torch.stack([gx, gy], dim=-1)[:, None, :, :]          # (B, 1, N, 2)

    def sample(m):
        return grid_sample_bilinear(m, grid)[:, 0]               # (B, N, C)

    interp_u, interp_v, interp_i = sample(u_pred), sample(v_pred), sample(index_pred)
    ce_pts = cross_entropy_int(interp_i, dp["i_points"])
    loss_ipoints = _safe_div((ce_pts * w[:, None]).sum(), w.sum() * npts) * cfg.part_weights

    uw = dp["point_weights"].transpose(1, 2)
    u_gt = dp["u_points"].transpose(1, 2)
    v_gt = dp["v_points"].transpose(1, 2)
    wexp = w[:, None, None]
    loss_upoints = (uw * smooth_l1(uw * (interp_u - u_gt)) * wexp).sum() * cfg.point_regression_weights
    loss_vpoints = (uw * smooth_l1(uw * (interp_v - v_gt)) * wexp).sum() * cfg.point_regression_weights

    ce_ann = cross_entropy_int(ann_pred, dp["ann_labels"])
    loss_ann = _safe_div((ce_ann * w[:, None, None]).sum(),
                         w.sum() * ce_ann.shape[1] * ce_ann.shape[2]) * cfg.index_weights
    return loss_upoints, loss_vpoints, loss_ipoints, loss_ann


def stn_losses(stn_centers, smpl_kps_gt, cfg: DaNetConfig):
    """Confidence-weighted smooth-l1 between the soft-argmax centres and the
    GT SMPL 2D keypoints (both in [-1, 1]), summed / batch size."""
    conf = smpl_kps_gt[..., 2]
    diff = smooth_l1(stn_centers - smpl_kps_gt[..., :2]).sum(-1)
    return (conf * diff).sum() / _global_batch(stn_centers) * cfg.stn_kps_weights


def stn_heatmap_loss(hm_pred, smpl_kps_gt, cfg: DaNetConfig):
    """Mean smooth-l1 between the heatmap head and Gaussian targets at the
    GT SMPL keypoints. hm_pred (B, H, W, 24); smpl_kps_gt (B, 24, 3)."""
    kps01 = smpl_kps_gt[..., :2].detach() * 0.5 + 0.5
    hm_gt, _ = gaussian_heatmaps(kps01, hm_pred.shape[1])
    return _mean(smooth_l1(hm_pred - hm_gt)) * cfg.stn_hm_weights


def _masked_mean_elems(err, mask_b):
    """Mean over the elements of valid samples."""
    w = mask_b.to(err.dtype).reshape((-1,) + (1,) * (err.dim() - 1))
    per_elem = err.numel() // err.shape[0]
    return _safe_div((err * w).sum(), w.sum() * per_elem)


def _l1_sum_over_samples(err, mask_b):
    """Sum of |err| over valid samples / number of valid samples."""
    w = mask_b.to(err.dtype).reshape((-1,) + (1,) * (err.dim() - 1))
    return _safe_div((err.abs() * w).sum(), mask_b.to(err.dtype).sum())


def smpl_param_losses(pred_rotmat, pred_betas, gt_rotmat, gt_betas, has_smpl, cfg: DaNetConfig):
    loss_pose = _masked_mean_elems((pred_rotmat - gt_rotmat) ** 2, has_smpl)
    loss_betas = _masked_mean_elems((pred_betas - gt_betas) ** 2, has_smpl)
    return loss_pose * cfg.smpl_pose_weights, loss_betas * cfg.smpl_betas_weights


def keypoint_2d_loss(pred_kp2d, gt_kp2d, openpose_weight, gt_weight):
    """Confidence-weighted MSE on normalized 2D keypoints, mean over the
    whole tensor; the first 25 (OpenPose) and the last 24 (GT) confidences
    are scaled by their weights."""
    conf = gt_kp2d[..., 2:3]
    conf = torch.cat([conf[:, :25] * openpose_weight, conf[:, 25:] * gt_weight], dim=1)
    return _mean(conf * (pred_kp2d - gt_kp2d[..., :2]) ** 2)


def keypoint_3d_loss(pred_joints49, gt_kp3d, has_kp3d):
    """Pelvis-centred confidence-weighted MSE on the 24 GT joints."""
    pred = pred_joints49[:, 25:, :]
    conf = gt_kp3d[..., -1:]
    gt = gt_kp3d[..., :3]
    gt = gt - ((gt[:, 2, :] + gt[:, 3, :]) / 2.0)[:, None, :]
    pred = pred - ((pred[:, 2, :] + pred[:, 3, :]) / 2.0)[:, None, :]
    return _masked_mean_elems(conf * (pred - gt) ** 2, has_kp3d)


def vertex_loss(pred_verts, gt_verts, has_smpl):
    return _masked_mean_elems((pred_verts - gt_verts).abs(), has_smpl)


def cam_losses(pred_cam, gt_cam, has_smpl):
    """L1 camera fit + positive-depth penalty."""
    loss_cam = _l1_sum_over_samples(pred_cam - gt_cam, has_smpl)
    loss_depth = _mean(torch.exp(-pred_cam[:, 0] * 10.0) ** 2)
    return loss_cam, loss_depth


def orthogonal_loss(pred_rotmat, cfg: DaNetConfig):
    """MSE between R R^T and the identity over all rotation matrices."""
    r = pred_rotmat.reshape(-1, 3, 3)
    rrt = torch.einsum("bij,bkj->bik", r, r)
    eye = torch.eye(3, dtype=rrt.dtype, device=rrt.device)
    return _mean((rrt - eye) ** 2) * cfg.orthogonal_weights


def aux_rotation_loss(pred_rot_flat, gt_rotmat_flat, has_smpl, cfg: DaNetConfig):
    return _masked_mean_elems((pred_rot_flat - gt_rotmat_flat) ** 2, has_smpl) * cfg.smpl_pose_weights


def aux_position_loss(pred_coords, gt_smpl_joints, has_smpl, cfg: DaNetConfig):
    return _l1_sum_over_samples(pred_coords - gt_smpl_joints, has_smpl) * cfg.joint_position_weights


def reproject(pred_joints, pred_cam, img_size: float, focal_length: float = 5000.0):
    """Weak-perspective reprojection to [-1, 1] image coordinates."""
    b = pred_joints.shape[0]
    tz = 2.0 * focal_length / (img_size * pred_cam[:, 0] + 1e-9)
    cam_t = torch.stack([pred_cam[:, 1], pred_cam[:, 2], tz], dim=-1)
    eye = torch.eye(3, dtype=pred_joints.dtype, device=pred_joints.device).expand(b, 3, 3)
    center = pred_joints.new_zeros(b, 2)
    return perspective_projection(pred_joints, eye, cam_t, focal_length, center) / (img_size / 2.0)
