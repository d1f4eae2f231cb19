"""Evaluation metrics: MPJPE / PA-MPJPE and streaming segmentation scores.

Port of the JAX package's `eval/metrics.py::compute_mpjpe` and
`SegmentationScores`. The scores accumulate on the tensors' device in
int64 and reach the host only when read. (The COCO OKS AP code is host
numpy for `eval_coco`; it waits for a later slice.)
"""

from __future__ import annotations

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.ops.procrustes import reconstruction_error


def compute_mpjpe(pred: torch.Tensor, gt: torch.Tensor):
    """Per-sample MPJPE and PA-MPJPE (meters). pred / gt: (B, J, 3)."""
    mpjpe = torch.sqrt(((pred - gt) ** 2).sum(-1)).mean(-1)
    return mpjpe, reconstruction_error(pred, gt)


class SegmentationScores:
    """Streaming accuracy and per-class F1 of label maps.

    `update(pred, gt, keep=None)` adds one pair of integer maps (any equal
    shapes, any device): accuracy counts pred == gt over every pixel; the
    true/false positive and false negative counts of classes 0..n-1 take
    only the pixels where `keep` is True (all when None). Labels outside
    0..n-1 count toward accuracy only. The counts live in one int64
    confusion matrix on the device of the first update."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        n = num_classes + 1          # the last row / column: any other label
        self.confusion = torch.zeros((n, n), dtype=torch.int64)
        self.correct = torch.zeros((), dtype=torch.int64)
        self.total = 0

    def update(self, pred: torch.Tensor, gt: torch.Tensor, keep: torch.Tensor | None = None):
        if self.confusion.device != gt.device:
            self.confusion = self.confusion.to(gt.device)
            self.correct = self.correct.to(gt.device)
        n = self.num_classes
        pred, gt = pred.reshape(-1).long(), gt.reshape(-1).long()
        self.correct += (pred == gt).sum()
        self.total += gt.numel()
        p = torch.where((pred >= 0) & (pred < n), pred, n)
        g = torch.where((gt >= 0) & (gt < n), gt, n)
        cell = g * (n + 1) + p
        if keep is not None:            # dropped pixels go to a bin past the matrix
            cell = torch.where(keep.reshape(-1), cell, (n + 1) ** 2)
        counts = torch.zeros((n + 1) ** 2 + 1, dtype=torch.int64, device=gt.device)
        counts.scatter_add_(0, cell, torch.ones_like(cell))
        self.confusion += counts[:-1].reshape(n + 1, n + 1)

    def counts(self):
        """(tp, fp, fn) as float64 numpy arrays of length num_classes."""
        c = self.confusion.cpu().numpy().astype(np.float64)
        n = self.num_classes
        tp = np.diag(c)[:n]
        return tp, c[:, :n].sum(0) - tp, c[:n, :].sum(1) - tp

    @property
    def accuracy(self) -> float:
        return float(int(self.correct) / max(self.total, 1))

    @property
    def f1(self) -> np.ndarray:
        tp, fp, fn = self.counts()
        return 2 * tp / np.maximum(2 * tp + fp + fn, 1e-9)
