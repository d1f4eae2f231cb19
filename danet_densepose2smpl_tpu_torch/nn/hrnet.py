"""HRNet-W48 backbone (port of the JAX `nn/hrnet.py`).

stem (2x stride-2 conv) -> layer1 (4 Bottlenecks @64) -> 3 multi-resolution
stages of BasicBlocks with full cross-resolution fusion; the output is the
highest-resolution branch (48 ch at stride 4 = 56x56 for a 224 input).
Fusion upsampling is nearest. Names follow the reference checkpoint:
conv1/bn1/conv2/bn2/layer1, transition{t}.{i}, stage{t}.{m}.branches.{b},
stage{t}.{m}.fuse_layers.{i}.{j}.

`HRNET_W48_STAGES_PADDED` (`hrnet_pad_channels`) widens the 48/96-channel
branches to 64/128; a W48 checkpoint zero-padded into it gives the W48
outputs (the extra channels carry zero weights and stay 0). With
`remat_modules`, a train-mode forward checkpoints the stem's `layer1` and
each `HRModule` on its own (`nn.layers.remat`), as the JAX package's
`remat_scope` 'modules' does, and keeps the activations of the stages in
`remat_skip_stages` ('early': (4,)); the stem convs and the transitions
always keep theirs.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from danet_densepose2smpl_tpu_torch.nn.layers import BasicBlock, BNReLU, Bottleneck, ResLayer, bn, conv, remat

# (num_modules, num_branches, num_blocks per branch, channels per branch)
HRNET_W48_STAGES = (
    (1, 2, (4, 4), (48, 96)),
    (4, 3, (4, 4, 4), (48, 96, 192)),
    (3, 4, (4, 4, 4, 4), (48, 96, 192, 384)),
)

# the JAX package's padded variant: 48 -> 64 and 96 -> 128 channels
HRNET_W48_STAGES_PADDED = (
    (1, 2, (4, 4), (64, 128)),
    (4, 3, (4, 4, 4), (64, 128, 192)),
    (3, 4, (4, 4, 4, 4), (64, 128, 192, 384)),
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

    `stages` takes the JAX package's spec tuples, so tests can build it
    narrow. `remat_modules` and `remat_skip_stages` (stage numbers as in
    the names, 2-4) act in train mode only."""

    def __init__(self, stages: Sequence = HRNET_W48_STAGES, remat_modules: bool = False,
                 remat_skip_stages: Sequence = ()):
        super().__init__()
        self.stages = tuple(stages)
        self.remat_modules = remat_modules
        self.remat_skip_stages = tuple(remat_skip_stages)
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
        per_module = self.remat_modules and self.training

        def run(block, stage, inputs):
            return remat(block, inputs) if per_module and stage not in self.remat_skip_stages else block(inputs)

        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [run(self.layer1, 1, x)]
        for s_idx, (_, num_branches, _, _) in enumerate(self.stages):
            t = s_idx + 1
            trans = getattr(self, f"transition{t}")
            xs = [trans[i](xs[i] if i < len(xs) else xs[-1]) for i in range(num_branches)]
            for module in getattr(self, f"stage{t + 1}"):
                xs = run(module, t + 1, xs)
        return xs[0]
