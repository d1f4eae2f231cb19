"""In-step GT target preparation (port of the JAX
`train/prepare.py::prepare_targets`).

From the raw batch and the fits lookup: pseudo-fit merge, the SMPL mesh of
the fits, the batched WLS camera fit, projected target SMPL keypoints, the
weak-perspective target camera and the rendered GT IUV image. Everything
here is a detached target (JAX: `stop_gradient` at `prepare.py:67,90,97`),
so it runs without autograd.
"""

from __future__ import annotations

import torch

from port_bench.reference.config import Config
from port_bench.reference.ops.projection import estimate_translation, perspective_projection
from port_bench.reference.ops.rotations import batch_rodrigues
from port_bench.reference.smpl.loader import SMPLModel
from port_bench.reference.smpl.model import smpl_forward_aa


@torch.no_grad()
def prepare_targets(cfg: Config, smpl: SMPLModel, batch: dict, renderer=None,
                    is_itw: bool = False) -> dict:
    """Extend `batch` with the loss targets. Expects img, keypoints, pose,
    betas, has_smpl, has_dp, smpl_2dkps, opt_pose, opt_betas, opt_valid,
    is_dp_dataset; `smpl` holds tensors on the batch's device.

    The JAX function also fits a camera to the GT-pose mesh (`gt_cam_t`);
    nothing reads it, so it is not computed here."""
    img_res = float(cfg.danet.img_size)
    b = batch["img"].shape[0]
    gt_pose, gt_betas, has_smpl = batch["pose"], batch["betas"], batch["has_smpl"]

    # pseudo fits: extreme betas -> 0; GT overrides where available
    opt_betas = batch["opt_betas"]
    opt_betas = torch.where((opt_betas.abs() > 3).any(dim=-1, keepdim=True),
                            torch.zeros_like(opt_betas), opt_betas)
    m = has_smpl[:, None] > 0
    opt_pose = torch.where(m, gt_pose, batch["opt_pose"])
    opt_betas = torch.where(m, gt_betas, opt_betas)
    opt_out = smpl_forward_aa(smpl, opt_betas, opt_pose)

    kp = batch["keypoints"]
    kp_orig = torch.cat([0.5 * img_res * (kp[..., :2] + 1.0), kp[..., 2:]], dim=-1)
    opt_cam_t = estimate_translation(opt_out.joints, kp_orig, img_size=img_res)

    valid_fit = torch.maximum(batch["opt_valid"], has_smpl) if is_itw else has_smpl
    has_iuv = (1.0 - batch["is_dp_dataset"]) * valid_fit

    # target SMPL 2D keypoints in [-1, 1]: projected pseudo-GT joints for
    # rendered-IUV samples, the dataset's smpl_2dkps for DensePose samples
    dt, dev = opt_out.smpl_joints.dtype, opt_out.smpl_joints.device
    proj = perspective_projection(
        opt_out.smpl_joints, torch.eye(3, dtype=dt, device=dev).expand(b, 3, 3), opt_cam_t,
        5000.0, torch.full((b, 2), 0.5 * img_res, dtype=dt, device=dev))
    proj = proj / (0.5 * img_res) - 1.0
    target_kps = torch.cat([proj, (has_iuv > 0).to(proj.dtype)[:, None, None].expand(b, 24, 1)], dim=-1)
    target_kps = torch.where((batch["has_dp"] > 0)[:, None, None], batch["smpl_2dkps"], target_kps)

    # weak-perspective camera for the renderer
    tz = opt_cam_t[:, 2]
    target_cam = torch.stack([(2.0 * 5000.0 / img_res) / tz, opt_cam_t[:, 0], opt_cam_t[:, 1]], dim=-1)

    out = dict(batch)
    out.update(
        opt_pose=opt_pose,
        opt_betas=opt_betas,
        opt_rotmat=batch_rodrigues(opt_pose.reshape(b * 24, 3)).reshape(b, 24, 3, 3),
        target_verts=opt_out.vertices,
        target_cam=target_cam,
        target_smpl_kps=target_kps,
        valid_fit=valid_fit,
        has_iuv=has_iuv,
    )
    if renderer is not None:
        uv_gt = renderer(opt_out.vertices, target_cam)
        out["uv_image_gt"] = uv_gt * (has_iuv > 0).to(uv_gt.dtype)[:, None, None, None]
    return out
