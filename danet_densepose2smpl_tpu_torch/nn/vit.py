"""The ViT trunk of HMR 2.0 (ViTPose-H; 4D-Humans,
`hmr2/models/backbones/vit.py`), in eval: a padded patch embedding,
learned positions, pre-LN blocks and a last LayerNorm.

Module names follow 4D-Humans' state dict (`patch_embed.proj`,
`pos_embed`, `blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}`, `last_norm`), so a released checkpoint loads by name.
Fixed by the architecture: patches of 16 padded by 2 (ViTPose's `ratio`
1), `qkv` with a bias, LayerNorm eps 1e-6. Drop-path and dropout are the
identity in eval and are left out. The attention core goes through
`nn/attention.py::attend`, inside the span `vit.attention`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from danet_densepose2smpl_tpu_torch.nn.attention import attend
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate

PATCH = 16
PATCH_PADDING = 2
LN_EPS = 1e-6


class PatchEmbed(nn.Module):
    """Conv2d(3, dim, 16, stride 16, padding 2) -> (B, N, dim) tokens in
    row-major order of the grid: a 256x192 crop gives a 16x12 grid (192
    tokens), as `img_hw // 16`."""

    def __init__(self, img_hw: tuple, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH, padding=PATCH_PADDING)
        self.num_patches = (img_hw[0] // PATCH) * (img_hw[1] // PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention: `qkv` Linear(dim, 3 dim) (q, k, v, each
    heads x head size), `attend`, `proj` Linear(dim, dim)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        with annotate("vit.attention"):
            out = attend(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """x + attn(norm1(x)), then x + mlp(norm2(x)); exact (erf) GELU."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, 3, H, W) -> (B, N, dim): patches, + positions, `depth` blocks,
    `last_norm`. `pos_embed` holds a class token's row first, as the
    pretrained model does; the patches take `pos_embed[:, 1:] +
    pos_embed[:, :1]` (summed once, then added to the tokens)."""

    def __init__(self, img_hw: tuple, dim: int, depth: int, heads: int, mlp_dim: int):
        super().__init__()
        self.patch_embed = PatchEmbed(img_hw, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.patch_embed.num_patches + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_dim) for _ in range(depth))
        self.last_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x) + (self.pos_embed[:, 1:] + self.pos_embed[:, :1])
        for block in self.blocks:
            x = block(x)
        return self.last_norm(x)
