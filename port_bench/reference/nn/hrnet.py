"""HRNet-W48 backbone (port of the JAX `nn/hrnet.py`).

stem (2x stride-2 conv) -> layer1 (4 Bottlenecks @64) -> 3 multi-resolution
stages of BasicBlocks with full cross-resolution fusion; the output is the
highest-resolution branch (48 ch at stride 4 = 56x56 for a 224 input).
Fusion upsampling is nearest. Names follow the reference checkpoint:
conv1/bn1/conv2/bn2/layer1, transition{t}.{i}, stage{t}.{m}.branches.{b},
stage{t}.{m}.fuse_layers.{i}.{j}.

A frozen copy of the port's `nn/hrnet.py`, without rematerialisation.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.nn.layers import BasicBlock, BNReLU, Bottleneck, ResLayer, bn, conv

# (num_modules, num_branches, num_blocks per branch, channels per branch)
HRNET_W48_STAGES = (
    (1, 2, (4, 4), (48, 96)),
    (4, 3, (4, 4, 4), (48, 96, 192)),
    (3, 4, (4, 4, 4, 4), (48, 96, 192, 384)),
)

class HRModule(nn.Module):
    """One multi-resolution module: per-branch residual blocks + full fusion."""

    def __init__(self, num_branches: int, num_blocks: Sequence[int],
                 channels: Sequence[int], multi_scale_output: bool = True):
        super().__init__()
        ch = channels
        self.branches = nn.ModuleList(
            ResLayer(BasicBlock, ch[b], ch[b], num_blocks[b]) for b in range(num_branches)
        )
        n_out = num_branches if multi_scale_output else 1
        self.fuse_layers = nn.ModuleList()
        for i in range(n_out):
            row = nn.ModuleList()
            for j in range(num_branches):
                if j > i:
                    # lower-res -> i: 1x1 conv + BN, then nearest upsample
                    row.append(nn.Sequential(
                        conv(ch[j], ch[i], 1), bn(ch[i]),
                        nn.Upsample(scale_factor=2 ** (j - i), mode="nearest"),
                    ))
                elif j < i:
                    # higher-res -> i: (i-j) stride-2 3x3 convs, ReLU between
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        cout = ch[i] if last else ch[j]
                        seq = [conv(ch[j], cout, 3, 2), bn(cout)]
                        if not last:
                            seq.append(nn.ReLU(inplace=True))
                        steps.append(nn.Sequential(*seq))
                    row.append(nn.Sequential(*steps))
                else:
                    row.append(nn.Identity())
            self.fuse_layers.append(row)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for row in self.fuse_layers:
            acc = None
            for f, y in zip(row, ys):
                y = f(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class PoseHighResolutionNet(nn.Module):
    """HRNet; returns the highest-resolution branch, (B, C0, H/4, W/4).

    `stages` takes the JAX package's spec tuples."""

    def __init__(self, stages: Sequence = HRNET_W48_STAGES):
        super().__init__()
        self.stages = tuple(stages)
        self.conv1 = conv(3, 64, 3, 2)
        self.bn1 = bn(64)
        self.conv2 = conv(64, 64, 3, 2)
        self.bn2 = bn(64)
        self.layer1 = ResLayer(Bottleneck, 64, 64, 4)      # -> 256 ch

        prev = (256,)
        for s_idx, (num_modules, num_branches, num_blocks, channels) in enumerate(self.stages):
            t = s_idx + 1
            trans = nn.ModuleList()
            for i in range(num_branches):
                if i < len(prev):
                    # adapt an existing branch (identity when widths agree)
                    trans.append(BNReLU(prev[i], channels[i], 3) if prev[i] != channels[i]
                                 else nn.Identity())
                else:
                    # spawn the new lowest branch from the last one
                    trans.append(nn.Sequential(BNReLU(prev[-1], channels[i], 3, 2)))
            setattr(self, f"transition{t}", trans)
            last_stage = s_idx == len(self.stages) - 1
            setattr(self, f"stage{t + 1}", nn.ModuleList(
                HRModule(num_branches, num_blocks, channels,
                         multi_scale_output=not (last_stage and m == num_modules - 1))
                for m in range(num_modules)
            ))
            prev = channels
        self.out_channels = self.stages[-1][3][0]

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s_idx, (_, num_branches, _, _) in enumerate(self.stages):
            t = s_idx + 1
            trans = getattr(self, f"transition{t}")
            xs = [trans[i](xs[i] if i < len(xs) else xs[-1]) for i in range(num_branches)]
            for module in getattr(self, f"stage{t + 1}"):
                xs = module(xs)
        return xs[0]
