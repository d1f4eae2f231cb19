"""Batched Procrustes alignment and reconstruction error (PA-MPJPE).

Port of the JAX package's `ops/procrustes.py`: one batched
`torch.linalg.svd` over the (..., 3, 3) covariances. The contractions are
an eval metric and run in full precision: `full_fp32` keeps TF32 off on the
card whatever the caller set.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """fp32 matrix products and cuDNN convolutions in full fp32 (no TF32;
    PyTorch lets cuDNN use TF32 by default) inside the block; the previous
    settings come back after it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def similarity_align(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Optimal similarity transform (scale, R, t) of S1 onto S2.

    S1, S2: (..., N, 3) point sets. Returns the aligned S1_hat, shaped as
    S1. A zero-variance S1 (a padded sample) gives scale 0, not NaN.
    """
    with full_fp32():
        mu1 = S1.mean(dim=-2, keepdim=True)
        mu2 = S2.mean(dim=-2, keepdim=True)
        X1 = S1 - mu1
        X2 = S2 - mu2
        var1 = (X1 ** 2).sum(dim=(-2, -1)).clamp_min(1e-12)

        K = torch.einsum("...ni,...nj->...ij", X1, X2)
        U, _, Vh = torch.linalg.svd(K)
        V = Vh.transpose(-1, -2)
        detsign = torch.sign(torch.linalg.det(torch.einsum("...ij,...kj->...ik", U, V)))
        Z = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape).clone()
        Z[..., -1, -1] = detsign
        R = torch.einsum("...ij,...jk,...lk->...il", V, Z, U)

        scale = torch.einsum("...ij,...ji->...", R, K) / var1
        t = mu2 - scale[..., None, None] * torch.einsum("...ij,...nj->...ni", R, mu1)
        return scale[..., None, None] * torch.einsum("...ij,...nj->...ni", R, X1 + mu1) + t


def reconstruction_error(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Per-sample PA-MPJPE: mean joint distance after Procrustes alignment.
    S1, S2: (B, N, 3). Returns (B,)."""
    S1_hat = similarity_align(S1, S2)
    return torch.sqrt(((S1_hat - S2) ** 2).sum(dim=-1)).mean(dim=-1)
