"""IUV estimator: image -> global IUV maps + 24 partial IUV stacks (port
of the JAX `models/iuv_estimator.py`).

HRNet-W48 (or, with `iuv_regressor='resnet'`, the PoseResNet backbone:
256 channels) -> IUV heads (global U/V/Index/Ann + 24 joint heatmaps) ->
soft-argmax joint centres -> (train: centre jitter) -> part visibility ->
STN scales with the learned per-joint ratio/offset (train: scale jitter,
twice, as the reference) -> 24 part crops + grouped partial-IUV head. The
STN theta and scale are detached, as in JAX. Without `decomposed` (the
GlobalPredictor model) it stops after the heads: no STN, no part crops, no
K1.

In the feature input modes ('iuv_feat', 'iuv_gt_feat', 'feat') the part
crops of the backbone features are an output of their own (`part_feats`,
for the regressor), and the partial head runs on them as autograd ops in
eval too, as JAX does. Otherwise, at eval the crop + head runs through
`PartialIUVHead.fused`, whatever `fused_part_head` says: on a CUDA tensor
the hand-written kernel (K1), on a CPU tensor its plain version; in train
mode it is the JAX train path, the separable crop + grouped conv as
autograd ops (K1 has no backward); with `part_head_chunks` N > 1 they run
on N chunks of 24/N parts in turn (`chunked_crops_and_head`).
With `remat_backbone`, a train-mode forward recomputes the backbone in the
backward (`nn.layers.remat`): per HRNet module under `remat_scope`
'modules' and 'early' (`PoseHighResolutionNet(remat_modules=)`), else the
whole backbone in one checkpoint (the ResNet backbone under every scope,
as in JAX). `hrnet_pad_channels` builds the padded HRNet (64 output
channels: the heads, K1 and the feature modes' adapters take 64).
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
from danet_densepose2smpl_tpu_torch.nn.hrnet import HRNET_W48_STAGES, HRNET_W48_STAGES_PADDED, PoseHighResolutionNet
from danet_densepose2smpl_tpu_torch.nn.iuv_head import IUVPredictHead, nhwc
from danet_densepose2smpl_tpu_torch.nn.layers import remat
from danet_densepose2smpl_tpu_torch.nn.resnet import PoseResNet
from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights, separable_crop, separable_crop_concat
from danet_densepose2smpl_tpu_torch.ops.keypoints import soft_argmax_2d
from danet_densepose2smpl_tpu_torch.ops.structure import SMPL_CHILD2, SMPL_PARENT, device_table, smpl2dp_channel_mask
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate

# the input modes whose regressor takes the backbone features and their
# part crops
FEAT_MODES = ("iuv_feat", "iuv_gt_feat", "feat")

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
    """Per-part STN (theta, scale) from joint centres.

    Part 0 scales to the keypoint bounding box; the others to 2x the larger
    half-distance to parent/child; then the learned ratio/offset; hidden
    parts (except the root) fall back to 0.8x the box scale. With
    `scale_jitter` > 0, scale *= 1 + jitter * (u - 0.5) before and again
    after the fallback, u = scale_noise[0] and [1] (each (B, 24)). The
    centres and the kinematic scale are detached before the ratio/offset,
    as JAX stops them, so a trainable ratio/offset ('iuv_gt') gets the
    gradient of theta.
    """
    centers = centers.detach()
    box_diag = centers.amax(dim=1) - centers.amin(dim=1)          # (B, 2)
    scale_box = box_diag.amax(dim=-1) / 2.0                       # (B,)
    child = device_table(SMPL_CHILD2, centers.device)
    parent = device_table(SMPL_PARENT, centers.device)
    d_child = torch.linalg.vector_norm(centers[:, child] - centers, dim=-1) / 2.0
    d_parent = torch.linalg.vector_norm(centers[:, parent] - centers, dim=-1) / 2.0
    scale = 2.0 * torch.maximum(d_child, d_parent)                # (B, 24)
    scale = torch.cat([scale_box[:, None], scale[:, 1:]], dim=1).detach()
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
    return crop_theta(centers, scale), scale


def feat_crops_and_head(head, feats_nhwc: torch.Tensor, theta: torch.Tensor, s: int):
    """The feature modes' part crops and partial head: (part_feats
    (B, 24, S, S, C), part_iuv (B, 24, S, S, 3, 7)). The crops feed the
    regressor too, so they are a tensor of their own (autograd ops, the
    features keep their gradient); the head takes them in its grouped
    channel order, part-major (channel k*C + c), as JAX's
    `transpose(0, 2, 3, 1, 4)` gives them."""
    crops = separable_crop(feats_nhwc, theta[..., :, 2], theta[..., 0, 0], s)
    b = crops.shape[0]
    return crops, head(crops.permute(0, 2, 3, 1, 4).reshape(b, s, s, -1).permute(0, 3, 1, 2))


def chunked_crops_and_head(head, feats_nhwc: torch.Tensor, theta: torch.Tensor, s: int, chunks: int):
    """The train path's crop + partial head on `chunks` chunks of 24/N parts
    in turn, concatenated on the part axis (JAX's chunked branch, whose
    `optimization_barrier` orders the chunks; eager PyTorch runs them in
    loop order). Each chunk's crop intermediates are freed before the next
    chunk's are made; the crops the grouped conv keeps for the backward
    stay. The numbers are the one-shot path's; only the summation order of
    the features' gradient differs. Returns (B, 24, S, S, 3, 7)."""
    pc = head.num_parts // chunks
    outs = []
    for g in range(chunks):
        th = theta[:, g * pc:(g + 1) * pc]
        crops = separable_crop_concat(feats_nhwc, th[..., :, 2], th[..., 0, 0], s)
        outs.append(head(crops.permute(0, 3, 1, 2), start=g * pc, count=pc))
    return torch.cat(outs, dim=1)


class IUVEstimator(nn.Module):
    def __init__(self, cfg: DaNetConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.decomposed:
            self.register_buffer("learned_ratio", torch.as_tensor(LEARNED_RATIO.copy()))
            self.register_buffer("learned_offset", torch.as_tensor(LEARNED_OFFSET.copy()))
        per_module = cfg.remat_backbone and cfg.iuv_regressor == "hrnet" and cfg.remat_scope in ("modules", "early")
        # one checkpoint over the whole backbone: 'backbone', and the ResNet
        # backbone under every scope
        self.remat_whole = cfg.remat_backbone and not per_module
        if cfg.iuv_regressor == "hrnet":
            self.iuv_est = PoseHighResolutionNet(
                HRNET_W48_STAGES_PADDED if cfg.hrnet_pad_channels else HRNET_W48_STAGES,
                remat_modules=per_module, remat_skip_stages=(4,) if cfg.remat_scope == "early" else ())
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
        (B, 24, S, S, 3, 7); feats (B, S, S, C); in the feature modes
        part_feats (B, 24, S, S, C). Without `decomposed`, the maps of the
        heads and feats only. Spans: `danet.backbone`, the trunk;
        `danet.heads`, the rest (`heads`)."""
        with annotate("danet.backbone"):
            feats = remat(self.iuv_est, image) if self.remat_whole and self.training else self.iuv_est(image)
        with annotate("danet.heads"):
            return self.heads(feats, noise)

    def heads(self, feats: torch.Tensor, noise: dict | None) -> dict:
        """The global IUV heads, the STN crop parameters, and the part
        crops with the partial head, from the backbone's features."""
        c = self.cfg
        out = self.iuv_est.final_pred(feats)
        # the kernel and the crops take dense NHWC; a free view of the
        # channels_last output
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
        theta, scale = theta.detach(), scale.detach()
        out["stn_theta"] = theta
        out["stn_scale"] = scale

        head = self.iuv_est.final_pred.predict_partial_iuv
        if c.input_mode in FEAT_MODES:
            out["part_feats"], out["part_iuv"] = feat_crops_and_head(head, feats_nhwc, theta, s)
        elif self.training and c.part_head_chunks > 1:
            out["part_iuv"] = chunked_crops_and_head(head, feats_nhwc, theta, s, c.part_head_chunks)
        elif self.training:
            crops = separable_crop_concat(feats_nhwc, theta[..., :, 2], theta[..., 0, 0], s)
            out["part_iuv"] = head(crops.permute(0, 3, 1, 2))
        else:
            hh, ww = feats_nhwc.shape[1:3]
            wy = _axis_weights(theta[..., 1, 2], theta[..., 0, 0], hh, s, feats.dtype)
            wx = _axis_weights(theta[..., 0, 2], theta[..., 0, 0], ww, s, feats.dtype)
            out["part_iuv"] = head.fused(feats_nhwc, wy, wx)
        return out
