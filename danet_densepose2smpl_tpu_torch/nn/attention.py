"""Attention for the port's transformers (`nn/vit.py`,
`nn/pose_transformer.py`): one entry, `attend(q, k, v)`, for the trunk's
self-attention and the decoder's self- and cross-attention.

The port picks the route itself, as `nn/layers.py::bn_act` does:

- fused: q, k and v on the card in bf16 or fp16, one dtype, with a head
  size that PyTorch's fused backends take (a multiple of 8, at most 256):
  `scaled_dot_product_attention` restricted to its fused backends (flash,
  cuDNN, memory-efficient). Where none of them takes the call it raises:
  it never falls back to the math backend unseen;
- plain: every other call (the CPU, fp32, f64): softmax(q kᵀ · d^-0.5) v,
  computed in promote(dtype, fp32) and cast back.

Each call counts 'attn.fused' or 'attn.plain' into the span recorder's
open item (`utils.profiling.count`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from danet_densepose2smpl_tpu_torch.utils.profiling import count

FUSED_DTYPES = (torch.bfloat16, torch.float16)
FUSED_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
MAX_FUSED_HEAD = 256


def fused_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether `attend` takes the fused route for these tensors."""
    d = q.shape[-1]
    return (q.is_cuda and q.dtype in FUSED_DTYPES and k.dtype == v.dtype == q.dtype
            and k.shape[-1] == v.shape[-1] == d and d % 8 == 0 and d <= MAX_FUSED_HEAD)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d)) v of q (B, heads, Lq, d), k and v
    (B, heads, Lk, d): (B, heads, Lq, d) in q's dtype."""
    if fused_route(q, k, v):
        count("attn.fused")
        with sdpa_kernel(FUSED_BACKENDS):
            return F.scaled_dot_product_attention(q, k, v)
    count("attn.plain")
    dt = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(scores.softmax(dim=-1), v.to(dt)).to(q.dtype)
