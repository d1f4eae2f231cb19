"""IUV prediction heads (port of the JAX `nn/iuv_head.py`).

`IUVPredictHead` is the reference's `final_pred`: four 3x3 conv heads over
the backbone features — U (25), V (25), patch index (25), ann index (15) —
and a 24-joint heatmap head (3 Bottlenecks + conv). With `decomposed` it
also holds `predict_partial_iuv`, the grouped partial-IUV head.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.constants import ANN_CHANNELS, IUV_CHANNELS
from port_bench.reference.nn.layers import Bottleneck, ResLayer, conv


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (free for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1)


class PartialIUVHead(nn.Conv2d):
    """Grouped partial-IUV head: one groups=24 3x3 conv over the 24 part
    crops, mapping each part's C channels to 3 x part_dim.

    `forward` takes the crops concatenated along channels (B, 24*C, S, S),
    or those of a chunk of parts;
    returns (B, 24, S, S, 3, part_dim).
    """

    def __init__(self, in_per_part: int, part_dim: int = 7, num_parts: int = 24):
        super().__init__(in_per_part * num_parts, 3 * part_dim * num_parts, 3,
                         padding=1, groups=num_parts)
        self.part_dim = part_dim
        self.num_parts = num_parts

    def _regroup(self, out: torch.Tensor, parts: int) -> torch.Tensor:
        # (B, K*3*D, S, S) -> (B, K, S, S, 3, D)
        b, _, s, _ = out.shape
        return out.reshape(b, parts, 3, self.part_dim, s, s).permute(0, 1, 4, 5, 2, 3)

    def forward(self, part_feats: torch.Tensor, start: int = 0, count: int | None = None) -> torch.Tensor:
        """`part_feats` holds the crops of parts start .. start+count-1
        (all 24 by default); the conv takes those parts' slice of the
        weights and bias (JAX `PartialIUVHead(part_slice=(start, count))`)."""
        if count is None or count == self.num_parts:
            return self._regroup(super().forward(part_feats), self.num_parts)
        oc = 3 * self.part_dim
        rows = slice(start * oc, (start + count) * oc)
        out = F.conv2d(part_feats, self.weight[rows], self.bias[rows], padding=self.padding, groups=count)
        return self._regroup(out, count)


class IUVPredictHead(nn.Module):
    """Input (B, C, H, W) features. Returns NHWC maps: u/v/index
    (B, H, W, 25), ann (B, H, W, 15), heatmaps (B, H, W, 24)."""

    def __init__(self, feat_dim: int, num_joints: int = 24, decomposed: bool = True):
        super().__init__()
        self.predict_u = conv(feat_dim, IUV_CHANNELS, 3, bias=True)
        self.predict_v = conv(feat_dim, IUV_CHANNELS, 3, bias=True)
        self.predict_ann_index = conv(feat_dim, ANN_CHANNELS, 3, bias=True)
        self.predict_uv_index = conv(feat_dim, IUV_CHANNELS, 3, bias=True)
        self.predict_hm = nn.Sequential(
            ResLayer(Bottleneck, feat_dim, feat_dim // 4, 3),
            conv(feat_dim, num_joints, 3, bias=True),
        )
        if decomposed:
            self.predict_partial_iuv = PartialIUVHead(feat_dim)

    def forward(self, feats: torch.Tensor) -> dict:
        return {
            "u": nhwc(self.predict_u(feats)),
            "v": nhwc(self.predict_v(feats)),
            "index": nhwc(self.predict_uv_index(feats)),
            "ann": nhwc(self.predict_ann_index(feats)),
            "heatmaps": nhwc(self.predict_hm(feats)),
        }
