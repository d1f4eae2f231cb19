"""Graph convolution over the 24-joint skeleton (port of the JAX `nn/gcn.py`).

GraphConv is `adj @ x @ W + b`; the GCN stack interleaves BatchNorm over
the node axis + ReLU. Names follow the reference: gc.{i}, act.{i}.0.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from port_bench.reference.nn.layers import BN_EPS, BatchNorm1d


def normalize_undigraph(A: torch.Tensor) -> torch.Tensor:
    """D^-1/2 A D^-1/2 with a zero-degree guard."""
    deg = A.sum(dim=-2)
    dinv = torch.where(deg > 0, deg.clamp_min(torch.finfo(deg.dtype).tiny) ** -0.5,
                       torch.zeros_like(deg))
    return dinv[..., :, None] * A * dinv[..., None, :]


class GraphConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        # x: (B, N, F); adj: (N, N). Promotes as JAX does: an fp32 adjacency
        # lifts bf16 features (and then the bf16 weights) to fp32.
        dt = torch.promote_types(adj.dtype, x.dtype)
        y = torch.matmul(adj.to(dt), x.to(dt))
        dt = torch.promote_types(dt, self.weight.dtype)
        return y.to(dt) @ self.weight.to(dt) + self.bias.to(dt)


class GCN(nn.Module):
    """Stacked GraphConv + BatchNorm1d(nodes) + ReLU."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int,
                 num_nodes: int = 24):
        super().__init__()
        dims = [out_dim] if num_layers == 1 else [hidden_dim] * (num_layers - 1) + [out_dim]
        ins = [in_dim] + dims[:-1]
        self.gc = nn.ModuleList(GraphConv(i, o) for i, o in zip(ins, dims))
        self.act = nn.ModuleList(
            nn.Sequential(BatchNorm1d(num_nodes, eps=BN_EPS), nn.ReLU(inplace=True))
            for _ in dims
        )

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        for gc, act in zip(self.gc, self.act):
            x = act(gc(x, adj))
        return x
