"""The plain reference of HMR 2.0 (Goel et al., "Humans in 4D:
Reconstructing and Tracking Humans with Transformers", ICCV 2023,
arXiv:2305.20091; github.com/shubham-goel/4D-Humans: `hmr2/models/
backbones/vit.py::vit`, `hmr2/models/heads/smpl_head.py::
SMPLTransformerDecoderHead`, `hmr2/models/components/pose_transformer.py`,
`hmr2/utils/geometry.py`), in eval, fp32, written from its equations in
plain `torch`: explicit matrix products and softmax for attention, no
fused attention, no kernel; it imports neither the port nor JAX.

The forward of (B, 256, 256, 3) normalized NHWC crops:

- the crop's columns 32:224 (`x[:, :, :, 32:-32]` in NCHW), 256x192;
- patch embedding Conv2d(3, 1280, 16, stride 16, padding 2): a 16x12 grid,
  192 tokens in row-major order; + `pos_embed[:, 1:] + pos_embed[:, :1]`
  (`pos_embed` (1, 193, 1280));
- 32 blocks, x += proj(MHSA(LN1(x))), x += fc2(GELU(fc1(LN2(x)))): LayerNorm
  eps 1e-6, `qkv` Linear(1280, 3840) with bias, 16 heads of 80, scale
  80^-0.5, MLP 1280 -> 5120 -> 1280, exact GELU; `last_norm`. The context
  is (B, 192, 1280);
- the head: a zero (B, 1, 1) token through `to_token_embedding`
  Linear(1, 1024), + `pos_embedding` (1, 1, 1024); 6 layers of three pre-LN
  sublayers, each added to the residual: self-attention (`to_qkv`
  Linear(1024, 1536) without bias, 8 heads of 64, `to_out.0` Linear(512,
  1024)), cross-attention to the context (`to_q` Linear(1024, 512), `to_kv`
  Linear(1280, 1024), both without bias, `to_out.0`), FeedForward (1024 ->
  1024 -> 1024, GELU); LayerNorm eps 1e-5; no norm after the last layer
  (`TransformerDecoder` has none);
- pose6d = decpose(t) + init_body_pose, betas = decshape(t) + init_betas,
  cam = deccam(t) + init_cam; rotations by HMR 2.0's 6D reading (two rows,
  `rot6d_rows_to_rotmat` here), the first the global orientation.

Departures from HMR 2.0:

- the mean parameters: SPIN's `smpl_mean_params.npz` is not in the
  repository; the mean pose is the identity in HMR 2.0's own reading,
  (1, 0, 0, 0, 1, 0) a joint (the port's DaNet mean pose, (1, 0, 0, 1, 0,
  0), read this way is a degenerate frame), the mean shape zeros and the
  mean camera (0.9, 0, 0);
- SMPL is the port's (`reference/smpl`), with 49 joints, not HMR 2.0's 44;
- `pred_cam_t` and the 2D projection are post-processing outside `para`
  and are not computed;
- drop-path and dropout are the identity in eval and are left out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F



def rot6d_rows_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """HMR 2.0's 6D reading (`hmr2/utils/geometry.py::rot6d_to_rotmat`), as
    written there: (..., 6) read as two rows `reshape(-1, 2, 3).permute(0,
    2, 1)`, Gram-Schmidt with `F.normalize`, the frame as columns;
    (..., 3, 3). (DaNet's reading, `ops/rotations.py::rot6d_to_rotmat`,
    takes a (3, 2) column pair.)"""
    m = x.reshape(-1, 2, 3).permute(0, 2, 1)
    a1, a2 = m[:, :, 0], m[:, :, 1]
    b1 = F.normalize(a1, dim=1)
    b2 = F.normalize(a2 - torch.einsum("bi,bi->b", b1, a2).unsqueeze(-1) * b1, dim=1)
    b3 = torch.linalg.cross(b1, b2, dim=1)
    return torch.stack((b1, b2, b3), dim=-1).reshape(x.shape[:-1] + (3, 3))


@dataclass(frozen=True)
class HMR2Config:
    """The published sizes; `crop_cols` (32 of 256) is an eighth of the
    crop on each side."""

    image_size: int = 256
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    dec_dim: int = 1024
    dec_depth: int = 6
    dec_heads: int = 8
    dec_dim_head: int = 64
    dec_mlp_dim: int = 1024

    @property
    def crop_cols(self) -> int:
        return self.image_size // 8


PATCH, PATCH_PADDING, VIT_EPS, DECODER_EPS = 16, 2, 1e-6, 1e-5
JOINTS, BETAS = 24, 10


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head attention of q (B, Lq, heads d) over k, v (B, Lk, heads d):
    (B, Lq, heads d)."""
    b, lq, inner = q.shape
    d = inner // heads
    q, k, v = (t.reshape(b, t.shape[1], heads, d).permute(0, 2, 1, 3) for t in (q, k, v))
    weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
    return torch.matmul(weights, v).permute(0, 2, 1, 3).reshape(b, lq, inner)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, PATCH, stride=PATCH, padding=PATCH_PADDING)


class ViTAttention(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.heads = cfg.num_heads
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(attention(q, k, v, self.heads))


class Mlp(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_dim)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=VIT_EPS)
        self.attn = ViTAttention(cfg)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=VIT_EPS)
        self.mlp = Mlp(cfg)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        width = cfg.image_size - 2 * cfg.crop_cols
        tokens = (cfg.image_size // PATCH) * (width // PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.embed_dim, eps=VIT_EPS)

    def forward(self, x):
        """x (B, 3, H, W) -> the context (B, tokens, embed_dim)."""
        x = self.patch_embed.proj(x)
        x = x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for block in self.blocks:
            x = block(x)
        return self.last_norm(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.norm(x), **kwargs)


class SelfAttention(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.heads = cfg.dec_heads
        inner = cfg.dec_heads * cfg.dec_dim_head
        self.to_qkv = nn.Linear(cfg.dec_dim, 3 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, cfg.dec_dim))

    def forward(self, x):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(attention(q, k, v, self.heads))


class CrossAttention(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.heads = cfg.dec_heads
        inner = cfg.dec_heads * cfg.dec_dim_head
        self.to_kv = nn.Linear(cfg.embed_dim, 2 * inner, bias=False)
        self.to_q = nn.Linear(cfg.dec_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, cfg.dec_dim))

    def forward(self, x, context):
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(attention(self.to_q(x), k, v, self.heads))


class FeedForward(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.net = nn.ModuleDict({"0": nn.Linear(cfg.dec_dim, cfg.dec_mlp_dim), "1": nn.GELU(),
                                  "3": nn.Linear(cfg.dec_mlp_dim, cfg.dec_dim)})

    def forward(self, x):
        return self.net["3"](self.net["1"](self.net["0"](x)))


class TransformerCrossAttn(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        dim, eps = cfg.dec_dim, DECODER_EPS
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim, SelfAttention(cfg), eps), PreNorm(dim, CrossAttention(cfg), eps),
                           PreNorm(dim, FeedForward(cfg), eps)])
            for _ in range(cfg.dec_depth))


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, cfg.dec_dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, cfg.dec_dim))
        self.transformer = TransformerCrossAttn(cfg)

    def forward(self, token, context):
        x = self.to_token_embedding(token) + self.pos_embedding
        for self_attn, cross_attn, ff in self.transformer.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class SMPLHead(nn.Module):
    CONSTANTS = ("init_body_pose", "init_betas", "init_cam")

    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.transformer = TransformerDecoder(cfg)
        self.decpose = nn.Linear(cfg.dec_dim, 6 * JOINTS)
        self.decshape = nn.Linear(cfg.dec_dim, BETAS)
        self.deccam = nn.Linear(cfg.dec_dim, 3)
        pose = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]).repeat(JOINTS)
        self.register_buffer("init_body_pose", pose[None])
        self.register_buffer("init_betas", torch.zeros(1, BETAS))
        self.register_buffer("init_cam", torch.tensor([[0.9, 0.0, 0.0]]))


class HMR2(nn.Module):
    def __init__(self, cfg: HMR2Config):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg)
        self.smpl_head = SMPLHead(cfg)

    def forward(self, images: torch.Tensor) -> dict:
        """images (B, H, W, 3) -> para (B, 229) = [cam 3, betas 10, the 24
        rotation matrices], pred_cam, pred_shape, pred_rotmat (B, 24, 3, 3)."""
        x = images.permute(0, 3, 1, 2)
        c = self.cfg.crop_cols
        context = self.backbone(x[:, :, :, c:x.shape[3] - c])
        head = self.smpl_head
        b = context.shape[0]
        token = torch.zeros(b, 1, 1, dtype=context.dtype, device=context.device)
        t = head.transformer(token, context)[:, 0]
        pose6d = head.decpose(t) + head.init_body_pose
        betas = head.decshape(t) + head.init_betas
        cam = head.deccam(t) + head.init_cam
        rotmat = rot6d_rows_to_rotmat(pose6d.reshape(b, JOINTS, 6))
        para = torch.cat([cam, betas, rotmat.reshape(b, -1)], dim=1)
        return {"para": para, "pred_cam": cam, "pred_shape": betas, "pred_rotmat": rotmat}
