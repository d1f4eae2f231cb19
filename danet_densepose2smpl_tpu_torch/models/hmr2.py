"""HMR 2.0 (Goel et al., "Humans in 4D: Reconstructing and Tracking Humans
with Transformers", ICCV 2023, arXiv:2305.20091; github.com/shubham-goel/
4D-Humans) in eval: a ViT-H/16 trunk (`nn/vit.py`) on the crop's middle
256x192, and the SMPL transformer-decoder head (`nn/pose_transformer.py`)
with one zero query token (`TRANSFORMER_INPUT: zero`, `IEF_ITERS: 1`).

    model = HMR2(HMR2Config())
    out = model(images)   # (B, 256, 256, 3) normalized RGB, NHWC

`out` holds `para` (B, 229) in the port's layout (cam 3, betas 10, the 24
rotation matrices flattened), `pred_cam`, `pred_shape` and `pred_rotmat`
(B, 24, 3, 3; the global orientation first), so `serve.py::Predictor`
serves it as it serves DaNet. The mean parameters are the head's
`CONSTANTS`: under bf16 serving they stay fp32, and the mean addition and
the 6D-to-matrix conversion run in fp32. HMR 2.0 reads its 6D pose as two
rows (`ops/rotations.py::rot6d_rows_to_rotmat`), so the mean pose is the
identity in that reading, (1, 0, 0, 0, 1, 0) a joint; the mean camera and
shape are the port's (`default_mean_params`). Spans: `hmr2.backbone`
around the trunk, `hmr2.head` around the head.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from danet_densepose2smpl_tpu_torch.models.smpl_regressor import default_mean_params
from danet_densepose2smpl_tpu_torch.nn.layers import FP32Constants
from danet_densepose2smpl_tpu_torch.nn.pose_transformer import TransformerDecoder
from danet_densepose2smpl_tpu_torch.nn.vit import ViT
from danet_densepose2smpl_tpu_torch.ops.rotations import rot6d_rows_to_rotmat
from danet_densepose2smpl_tpu_torch.ops.structure import NUM_SMPL_JOINTS
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate

IDENTITY_6D_ROWS = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
NUM_BETAS = 10


@dataclass(frozen=True)
class HMR2Config:
    """The published sizes (4D-Humans' `vit()` and `SMPL_HEAD.
    TRANSFORMER_DECODER`); the patch (16, padded by 2), the LayerNorms'
    eps and the SMPL sizes are the architecture's own (`nn/vit.py`,
    `nn/pose_transformer.py`)."""

    image_size: int = 256   # the square crop a request carries; an eighth cut on each side
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16     # heads of 80
    mlp_dim: int = 5120
    dec_dim: int = 1024
    dec_depth: int = 6
    dec_heads: int = 8
    dec_dim_head: int = 64
    dec_mlp_dim: int = 1024

    @property
    def crop_cols(self) -> int:
        """Columns cut on each side (32 of 256: `x[..., 32:-32]`)."""
        return self.image_size // 8

    @property
    def trunk_hw(self) -> tuple:
        return self.image_size, self.image_size - 2 * self.crop_cols


class SMPLTransformerDecoderHead(FP32Constants):
    """The image tokens (B, N, embed_dim) -> cam (B, 3), betas (B, 10),
    rotmat (B, 24, 3, 3), the three fp32."""

    CONSTANTS = ("init_body_pose", "init_betas", "init_cam")

    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.transformer = TransformerDecoder(cfg.dec_dim, cfg.dec_depth, cfg.dec_heads, cfg.dec_dim_head,
                                              cfg.dec_mlp_dim, cfg.embed_dim)
        self.decpose = nn.Linear(cfg.dec_dim, 6 * NUM_SMPL_JOINTS)
        self.decshape = nn.Linear(cfg.dec_dim, NUM_BETAS)
        self.deccam = nn.Linear(cfg.dec_dim, 3)
        mean = default_mean_params()
        pose = np.tile(np.asarray(IDENTITY_6D_ROWS, dtype=np.float32), NUM_SMPL_JOINTS)
        self.register_buffer("init_body_pose", torch.as_tensor(pose)[None])
        self.register_buffer("init_betas", torch.as_tensor(mean.shape)[None])
        self.register_buffer("init_cam", torch.as_tensor(mean.cam)[None])

    def forward(self, context: torch.Tensor) -> tuple:
        b = context.shape[0]
        token = self.transformer(context.new_zeros(b, 1, 1), context)[:, 0]
        pose6d = self.decpose(token) + self.init_body_pose
        betas = self.decshape(token) + self.init_betas
        cam = self.deccam(token) + self.init_cam
        return cam, betas, rot6d_rows_to_rotmat(pose6d.view(b, NUM_SMPL_JOINTS, 6))


class HMR2(nn.Module):
    def __init__(self, cfg: HMR2Config = HMR2Config()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg.trunk_hw, cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.mlp_dim)
        self.smpl_head = SMPLTransformerDecoderHead(cfg)

    def forward(self, images: torch.Tensor) -> dict:
        """images (B, image_size, image_size, 3) normalized RGB, NHWC."""
        c = self.cfg.crop_cols
        x = images[:, :, c:images.shape[2] - c].permute(0, 3, 1, 2)
        with annotate("hmr2.backbone"):
            tokens = self.backbone(x)
        with annotate("hmr2.head"):
            cam, betas, rotmat = self.smpl_head(tokens)
        para = torch.cat([cam, betas, rotmat.flatten(1)], dim=1)
        return {"para": para, "pred_cam": cam, "pred_shape": betas, "pred_rotmat": rotmat}
