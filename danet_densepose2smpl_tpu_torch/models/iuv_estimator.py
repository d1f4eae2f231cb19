"""IUV estimator: image -> global IUV maps + 24 partial IUV stacks (port
of the JAX `models/iuv_estimator.py`).

HRNet-W48 (or, with `iuv_regressor='resnet'`, the PoseResNet backbone:
256 channels) -> IUV heads (global U/V/Index/Ann + 24 joint heatmaps) ->
soft-argmax joint centres -> (train: centre jitter) -> part visibility ->
STN scales with the learned per-joint ratio/offset (train: scale jitter,
twice, as the reference) -> 24 part crops + grouped partial-IUV head. The
STN theta and scale are detached, as in JAX's 'iuv' mode. Without
`decomposed` (the GlobalPredictor model) it stops after the heads: no STN,
no part crops, no K1.

At eval the crop + head runs through `PartialIUVHead.fused`, whatever
`fused_part_head` says: on a CUDA tensor the hand-written kernel (K1), on a
CPU tensor its plain version. In train mode it is the JAX train path, the
separable crop + grouped conv as autograd ops (K1 has no backward).
Jitter noise comes in as uniforms in [0, 1) (`noise['center']` (B, 24, 2),
`noise['scale']` (2, B, 24)), so tests can hand both packages the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.nn.hrnet import HRNET_W48_STAGES, PoseHighResolutionNet
from danet_densepose2smpl_tpu_torch.nn.iuv_head import IUVPredictHead, nhwc
from danet_densepose2smpl_tpu_torch.nn.resnet import PoseResNet
from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights, separable_crop_concat
from danet_densepose2smpl_tpu_torch.ops.keypoints import soft_argmax_2d
from danet_densepose2smpl_tpu_torch.ops.structure import SMPL_CHILD2, SMPL_PARENT, smpl2dp_channel_mask

# Shipped STN crop parameters (reference learned_ratio.pkl), buffers in
# 'iuv' mode.
LEARNED_RATIO = np.array(
    [0.6827488, 1.2050959, 1.1849039, 1.3892102, 1.0949879, 1.0947448,
     1.6018374, 1.0222101, 1.0536219, 0.8735159, 0.35833353, 0.44389617,
     1.0155953, 1.2463734, 1.2582259, 0.5802805, 1.1734062, 1.2033107,
     1.1978842, 1.204344, 0.84852725, 0.8551517, 0.46325213, 0.3972259],
    dtype=np.float32,
)
LEARNED_OFFSET = np.array(
    [0.09105359, 0.02297057, 0.02257976, 0.2006476, 0.01430975, 0.01649577,
     0.11027719, 0.06102319, 0.06142722, 0.16606377, 0.7373183, 0.7548186,
     0.07830715, 0.15315747, 0.14974837, 0.25240502, 0.06382725, 0.06352104,
     0.046521, 0.0466027, 0.06009533, 0.05492286, 0.21719937, 0.21409516],
    dtype=np.float32,
)


def point_sample(maps: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample channel k of `maps` at point k.

    maps: (B, H, W, K); pts: (B, K, 2) normalized [-1, 1] (x, y),
    align_corners=False, zero padding. Returns (B, K).
    """
    b, h, w, k = maps.shape
    fx = (pts[..., 0] + 1.0) * (w / 2.0) - 0.5
    fy = (pts[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    ks = torch.arange(k, device=maps.device)[None, :]
    bs = torch.arange(b, device=maps.device)[:, None]

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = maps[bs, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long(), ks]
        return vals * valid.to(maps.dtype)

    top = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
    bot = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty


def crop_theta(center: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """2x3 affine theta mapping output coords g to input coords
    g*scale + center. center (..., 2), scale (...,)."""
    zeros = torch.zeros_like(scale)
    row0 = torch.stack([scale, zeros, center[..., 0]], dim=-1)
    row1 = torch.stack([zeros, scale, center[..., 1]], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def stn_affine_params(centers, ratio, offset, part_hidden=None, scale_jitter: float = 0.0,
                      scale_noise=None):
    """Per-part STN (theta, scale) from joint centres, both detached.

    Part 0 scales to the keypoint bounding box; the others to 2x the larger
    half-distance to parent/child; then the learned ratio/offset; hidden
    parts (except the root) fall back to 0.8x the box scale. With
    `scale_jitter` > 0, scale *= 1 + jitter * (u - 0.5) before and again
    after the fallback, u = scale_noise[0] and [1] (each (B, 24)).
    """
    centers = centers.detach()
    box_diag = centers.amax(dim=1) - centers.amin(dim=1)          # (B, 2)
    scale_box = box_diag.amax(dim=-1) / 2.0                       # (B,)
    child = torch.as_tensor(SMPL_CHILD2, device=centers.device, dtype=torch.long)
    parent = torch.as_tensor(SMPL_PARENT, device=centers.device, dtype=torch.long)
    d_child = torch.linalg.vector_norm(centers[:, child] - centers, dim=-1) / 2.0
    d_parent = torch.linalg.vector_norm(centers[:, parent] - centers, dim=-1) / 2.0
    scale = 2.0 * torch.maximum(d_child, d_parent)                # (B, 24)
    scale = torch.cat([scale_box[:, None], scale[:, 1:]], dim=1)
    scale = scale * F.relu(ratio)[None, :] + F.relu(offset)[None, :]
    jitter = scale_jitter > 0
    if jitter:
        scale = scale * (1 + scale_jitter * (scale_noise[0] - 0.5))
    if part_hidden is not None:
        hide = part_hidden.clone()
        hide[:, 0] = False  # root never falls back
        scale = torch.where(hide, 0.8 * scale_box[:, None], scale)
    if jitter:
        scale = scale * (1 + scale_jitter * (scale_noise[1] - 0.5))
    scale = scale.detach()
    return crop_theta(centers, scale), scale


class IUVEstimator(nn.Module):
    def __init__(self, cfg: DaNetConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.decomposed:
            self.register_buffer("learned_ratio", torch.as_tensor(LEARNED_RATIO.copy()))
            self.register_buffer("learned_offset", torch.as_tensor(LEARNED_OFFSET.copy()))
        if cfg.iuv_regressor == "hrnet":
            self.iuv_est = PoseHighResolutionNet(HRNET_W48_STAGES)
        else:
            self.iuv_est = PoseResNet(cfg.msres_num_layers)
        # the reference checkpoint keeps the heads inside the backbone's
        # namespace: img2iuv.iuv_est.final_pred.*
        self.iuv_est.final_pred = IUVPredictHead(self.iuv_est.out_channels, decomposed=cfg.decomposed)
        self.register_buffer(
            "part_mask_t", torch.as_tensor(smpl2dp_channel_mask().T.copy()), persistent=False,
        )

    def forward(self, image: torch.Tensor, noise: dict | None = None) -> dict:
        """image: (B, 3, H, W), channels_last; noise: the jitter uniforms
        (train mode with jitter only). Returns channels-last predictions:
        u/v/index (B, S, S, 25); ann (B, S, S, 15); heatmaps (B, S, S, 24);
        stn_centers (B, 24, 2) (before jitter); part_vis_scores (B, 24);
        stn_theta (B, 24, 2, 3); stn_scale (B, 24); part_iuv
        (B, 24, S, S, 3, 7); feats (B, S, S, C). Without `decomposed`, the
        maps of the heads and feats only."""
        c = self.cfg
        feats = self.iuv_est(image)
        out = self.iuv_est.final_pred(feats)
        # the kernel takes dense NHWC; a free view of the channels_last output
        feats_nhwc = nhwc(feats).contiguous()
        out["feats"] = feats_nhwc
        if not c.decomposed:
            return out

        hm = out["heatmaps"]
        s = hm.shape[1]
        centers = soft_argmax_2d(hm, temperature=10.0) / (0.5 * s) - 1.0
        out["stn_centers"] = centers
        if self.training and c.stn_center_jitter > 0:
            centers = centers + c.stn_center_jitter * (noise["center"] - 0.5)
        centers = centers.detach()

        part_hidden = None
        if c.stn_part_vis_score > 0:
            # max over the joint's patch channels of the one-hot cleaned index
            # map = the mask entry of the winning channel
            winner = torch.argmax(out["index"], dim=-1)            # (B, S, S)
            score_maps = self.part_mask_t.to(hm.dtype)[winner]      # (B, S, S, 24)
            scores = point_sample(score_maps, centers)
            part_hidden = scores < c.stn_part_vis_score
            out["part_vis_scores"] = scores

        theta, scale = stn_affine_params(
            centers, self.learned_ratio, self.learned_offset, part_hidden,
            scale_jitter=c.stn_scale_jitter if self.training else 0.0,
            scale_noise=noise["scale"] if self.training and c.stn_scale_jitter > 0 else None,
        )
        out["stn_theta"] = theta
        out["stn_scale"] = scale

        head = self.iuv_est.final_pred.predict_partial_iuv
        if self.training:
            crops = separable_crop_concat(feats_nhwc, theta[..., :, 2], theta[..., 0, 0], s)
            out["part_iuv"] = head(crops.permute(0, 3, 1, 2))
        else:
            hh, ww = feats_nhwc.shape[1:3]
            wy = _axis_weights(theta[..., 1, 2], theta[..., 0, 0], hh, s, feats.dtype)
            wx = _axis_weights(theta[..., 0, 2], theta[..., 0, 0], ww, s, feats.dtype)
            out["part_iuv"] = head.fused(feats_nhwc, wy, wx)
        return out
