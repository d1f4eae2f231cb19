"""Residual building blocks of the reference (a frozen copy of the port's
`nn/layers.py` on one process, without rematerialisation).

Module and attribute names follow the reference checkpoint's state_dict
(conv1/bn1/conv2/bn2[/conv3/bn3], downsample.{0,1}, blocks of a layer as
`{i}`). BatchNorm eps is 1e-5, as flax's default; in train mode its
running variance takes the biased batch variance, as flax's does (see
`FlaxRunningVar`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """Conv with the 'same' padding kernel // 2 of the JAX `layers.conv`."""
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=bias)


class FlaxRunningVar:
    """BatchNorm mixin: in train mode, update `running_var` with the biased
    batch variance, as flax does (torch's own update takes the unbiased
    one, a factor n/(n-1) that is large at the regressor's 1x1 and 2x2
    maps). The momentum is already flax's: torch 0.1 = flax 0.9.

    F.batch_norm writes (1-m)*rv + m*var*n/(n-1); handing it rv/k,
    k = (n-1)/n, and keeping k times its result turns that into
    (1-m)*rv + m*var without another pass over the activations."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            if x.dtype != self.weight.dtype and not torch.is_autocast_enabled(x.device.type):
                return _eval_bn_promoted(self, x)
            return super().forward(x)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(f"BatchNorm in train mode needs more than one value per channel, got {n}")
        k = (n - 1) / n
        # a scaled copy: autograd may save the tensor F.batch_norm updates
        running_var = self.running_var / k
        y = F.batch_norm(x, self.running_mean, running_var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(running_var * k)
            self.num_batches_tracked.add_(1)
        return y


def _eval_bn_promoted(m, x):
    """Eval BatchNorm with flax's dtype flow for mixed inputs (fp32
    activations into bf16 statistics and parameters):
    (x - mean) * (rsqrt(var + eps) * scale) + bias, the rsqrt and scale
    product in the statistics' dtype, the rest promoted."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(m.running_var + m.eps) * m.weight
    return (x - m.running_mean.reshape(shape)) * mul.reshape(shape) + m.bias.reshape(shape)


class BatchNorm2d(FlaxRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm1d(FlaxRunningVar, nn.BatchNorm1d):
    pass


def bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS)


class BNReLU(nn.Sequential):
    """Conv -> BN -> ReLU as a Sequential (torch keys `.0`, `.1`)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__(conv(cin, cout, kernel, stride), bn(cout), nn.ReLU(inplace=True))


def _downsample(cin: int, cout: int, stride: int, groups: int) -> nn.Sequential | None:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(conv(cin, cout, 1, stride, groups=groups), bn(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 1):
        super().__init__()
        g = groups
        self.conv1 = conv(inplanes * g, planes * g, 3, stride, groups=g)
        self.bn1 = bn(planes * g)
        self.conv2 = conv(planes * g, planes * g, 3, groups=g)
        self.bn2 = bn(planes * g)
        self.downsample = _downsample(inplanes * g, planes * g, stride, g)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 1):
        super().__init__()
        g = groups
        self.conv1 = conv(inplanes * g, planes * g, 1, groups=g)
        self.bn1 = bn(planes * g)
        self.conv2 = conv(planes * g, planes * g, 3, stride, groups=g)
        self.bn2 = bn(planes * g)
        self.conv3 = conv(planes * g, planes * 4 * g, 1, groups=g)
        self.bn3 = bn(planes * 4 * g)
        self.downsample = _downsample(inplanes * g, planes * 4 * g, stride, g)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + r)


class ResLayer(nn.Sequential):
    """`num_blocks` residual blocks; the first carries the stride. `inplanes`
    and `planes` count channels per group."""

    def __init__(self, block, inplanes: int, planes: int, num_blocks: int,
                 stride: int = 1, groups: int = 1):
        blocks = []
        for i in range(num_blocks):
            blocks.append(block(inplanes, planes, stride if i == 0 else 1, groups))
            inplanes = planes * block.expansion
        super().__init__(*blocks)
        self.out_channels = inplanes * groups


# depth -> (block class, per-stage block counts)
RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)
