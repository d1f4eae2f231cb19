"""The transformer decoder of HMR 2.0's SMPL head (4D-Humans,
`hmr2/models/components/pose_transformer.py`: `TransformerDecoder` over
`TransformerCrossAttn`, with LayerNorm), in eval.

Each layer applies three pre-LN sublayers in turn, each added to the
residual: self-attention over the query tokens, cross-attention to the
context (the image tokens), a FeedForward. No norm follows the last layer,
as in 4D-Humans; LayerNorm eps 1e-5. Module names follow its state dict
(`to_token_embedding`, `pos_embedding`, `transformer.layers.{i}.{0,1,2}.
{norm,fn}`, `fn.to_qkv`, `fn.to_q`, `fn.to_kv`, `fn.to_out.0`, `fn.net.0`,
`fn.net.3`). Dropout is the identity in eval and is left out; the
attention cores go through `nn/attention.py::attend`.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn

from danet_densepose2smpl_tpu_torch.nn.attention import attend

LN_EPS = 1e-5


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, heads d) -> (B, heads, L, d)."""
    b, n, _ = t.shape
    return t.view(b, n, heads, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, heads, L, d) -> (B, L, heads d)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.fn(self.norm(x), **kwargs)


class FeedForward(nn.Module):
    """Linear(dim, hidden), exact GELU, Linear(hidden, dim) (`net.0`,
    `net.3`, where 4D-Humans has its dropouts between)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(OrderedDict([("0", nn.Linear(dim, hidden)), ("1", nn.GELU()),
                                              ("3", nn.Linear(hidden, dim))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class SelfAttention(nn.Module):
    """`to_qkv` Linear(dim, 3 heads d) without bias, `attend`, `to_out.0`
    Linear(heads d, dim)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out(_merge(attend(q, k, v)))


class CrossAttention(nn.Module):
    """`to_q` Linear(dim, heads d) of the tokens, `to_kv` Linear(context
    dim, 2 heads d) of the context, both without bias, `attend`, `to_out.0`
    Linear(heads d, dim)."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = (_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))
        return self.to_out(_merge(attend(_heads(self.to_q(x), self.heads), k, v)))


class TransformerCrossAttn(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, context_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim, SelfAttention(dim, heads, dim_head)),
                           PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
                           PreNorm(dim, FeedForward(dim, mlp_dim))])
            for _ in range(depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    """One query token of width 1 (B, 1, 1) and the (B, L, context_dim)
    context -> (B, 1, dim): `to_token_embedding` Linear(1, dim), +
    `pos_embedding`, the layers. (HMR 2.0's `TRANSFORMER_INPUT: zero`: one
    token, of width 1.)"""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, context_dim: int):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.transformer = TransformerCrossAttn(dim, depth, heads, dim_head, mlp_dim, context_dim)

    def forward(self, token: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        return self.transformer(self.to_token_embedding(token) + self.pos_embedding, context)
