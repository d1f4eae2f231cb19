"""The precision the reference computes in: fp32 with TF32 off (the
reference itself), and the controls a step below a cell's stated
precision: 'tf32' (TF32 on, below fp32 with TF32 off) and, below bf16,
'fp8' (float8 e4m3): every convolution's and linear layer's input and
weight, and every module's output, rounded to it under a per-tensor
scale (amax to 448), and in training each of their gradients rounded
alike. (Rounding only the
matrix units' operands, and no gradient, left the control within 3x of
the bf16 port, which rounds every activation and, under autocast, the
convolutions' gradients.)"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.nn.gcn import GraphConv
from port_bench.reference.nn.iuv_head import PartialIUVHead

# the lower formats: (largest magnitude, rounding of the scaled values)
FORMATS = {"fp8": (448.0, lambda y: y.to(torch.float8_e4m3fn).float())}


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    top, rnd = FORMATS[kind]
    amax = x.abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return rnd(x.float() / scale).mul(scale).to(x.dtype)


class _Lowered(torch.autograd.Function):
    """Rounds the tensor in the forward and its gradient in the backward."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _round(x, kind)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.kind), None


def lower_round(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x rounded to the format `kind` under a per-tensor scale (amax to the
    format's largest magnitude), back in x's dtype; in training its
    gradient is rounded alike on the way back."""
    return _Lowered.apply(x, kind)


def _lowered_forward(m: nn.Module, kind: str):
    def rnd(t):
        return lower_round(t, kind)

    if isinstance(m, PartialIUVHead):
        def grouped(x, start=0, count=None):
            count = m.num_parts if count is None else count
            rows = slice(start * 3 * m.part_dim, (start + count) * 3 * m.part_dim)
            out = F.conv2d(rnd(x), rnd(m.weight)[rows], m.bias[rows], padding=m.padding, groups=count)
            return m._regroup(out, count)
        return grouped
    if type(m) is nn.Conv2d:
        return lambda x: m._conv_forward(rnd(x), rnd(m.weight), m.bias)
    if type(m) is nn.Linear:
        return lambda x: F.linear(rnd(x), rnd(m.weight), m.bias)
    if isinstance(m, GraphConv):
        return lambda x, adj: (torch.matmul(adj, rnd(x)) @ rnd(m.weight)) + m.bias
    return None


@contextlib.contextmanager
def computed_in(kind: str, model: nn.Module):
    """The reference `model` computes in `kind` ('fp32', 'tf32' or one of
    FORMATS) inside the block."""
    if kind not in ("fp32", "tf32", *FORMATS):
        raise ValueError(f"unknown precision '{kind}'")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = kind == "tf32"
    patched, hooks = [], []
    if kind in FORMATS:
        def round_output(module, args, out):
            if torch.is_tensor(out) and out.is_floating_point():
                return lower_round(out, kind)
            return None

        for m in model.modules():
            fwd = _lowered_forward(m, kind)
            if fwd is not None:
                m.forward = fwd
                patched.append(m)
            if not list(m.children()) or fwd is not None:
                hooks.append(m.register_forward_hook(round_output))
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        for m in patched:
            del m.forward
        for h in hooks:
            h.remove()
