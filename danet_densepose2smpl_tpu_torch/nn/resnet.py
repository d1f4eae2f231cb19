"""ResNet variants (port of the JAX `nn/resnet.py`): the PoseResNet IUV
backbone, the SmplResNet regressors and the grouped LimbResLayers."""

from __future__ import annotations

import torch
import torch.nn as nn

from danet_densepose2smpl_tpu_torch.nn.layers import RESNET_SPEC, ResLayer, bn, bn_act, conv, max_pool_3x3_s2


def deconv_layer(cin: int, cout: int) -> list:
    """ConvTranspose k=4 s=2 p=1 (doubles H and W) + BN + ReLU, as three
    modules of the reference's `deconv_layers` Sequential."""
    return [nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False), bn(cout), nn.ReLU(inplace=True)]


class PoseResNet(nn.Module):
    """ResNet trunk (Bottleneck ResNet-50 by default; BasicBlock for 18/34)
    + 3 deconv layers -> a 256-channel stride-4 feature map (56x56 for a 224
    input). Names follow the reference checkpoint: conv1/bn1/layer1-4 and
    `deconv_layers.{0,3,6}` (convs), `{1,4,7}` (BatchNorms). The IUV heads
    attach as `final_pred`, as for the HRNet backbone."""

    def __init__(self, resnet_nums: int = 50, deconv_filters: tuple = (256, 256, 256)):
        super().__init__()
        block, layers = RESNET_SPEC[resnet_nums]
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = bn(64)
        self.layer1 = ResLayer(block, 64, 64, layers[0])
        self.layer2 = ResLayer(block, self.layer1.out_channels, 128, layers[1], stride=2)
        self.layer3 = ResLayer(block, self.layer2.out_channels, 256, layers[2], stride=2)
        self.layer4 = ResLayer(block, self.layer3.out_channels, 512, layers[3], stride=2)
        ch, deconvs = self.layer4.out_channels, []
        for f in deconv_filters:
            deconvs += deconv_layer(ch, f)
            ch = f
        self.deconv_layers = nn.Sequential(*deconvs)
        self.out_channels = ch

    def forward(self, x):
        x = max_pool_3x3_s2(bn_act(self.bn1, self.conv1(x), relu=True))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        d = self.deconv_layers
        for i in range(0, len(d), 3):   # (deconv, BN, ReLU) triples
            x = bn_act(d[i + 1], d[i](x), relu=True)
        return x


class SmplResNet(nn.Module):
    """ResNet trunk + optional global-average-pooled linear head.

    num_classes=0 returns features only; truncate in {0, 1, 2} removes the
    last stages. Returns (cls (B, num_classes) or None, features)."""

    def __init__(self, resnet_nums: int, in_channels: int = 64, num_classes: int = 229,
                 last_stride: int = 2, truncate: int = 0):
        super().__init__()
        block, layers = RESNET_SPEC[resnet_nums]
        self.truncate = truncate
        self.conv1 = conv(in_channels, 64, 7, 2)
        self.bn1 = bn(64)
        self.layer1 = ResLayer(block, 64, 64, layers[0])
        self.layer2 = ResLayer(block, self.layer1.out_channels, 128, layers[1], stride=2)
        ch = self.layer2.out_channels
        if truncate < 2:
            self.layer3 = ResLayer(block, ch, 256, layers[2], stride=2)
            ch = self.layer3.out_channels
        if truncate < 1:
            self.layer4 = ResLayer(block, ch, 512, layers[3], stride=last_stride)
            ch = self.layer4.out_channels
        self.out_channels = ch
        self.num_classes = num_classes
        if num_classes > 0:
            self.final_layer = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = max_pool_3x3_s2(bn_act(self.bn1, self.conv1(x), relu=True))
        x = self.layer2(self.layer1(x))
        if self.truncate < 2:
            x = self.layer3(x)
        if self.truncate < 1:
            x = self.layer4(x)
        cls = self.final_layer(x.mean(dim=(2, 3))) if self.num_classes > 0 else None
        return cls, x


class LimbResLayers(nn.Module):
    """Grouped (24-part) ResNet layer4 + per-part global average pooling.

    Input (B, 24*inplanes, H, W) concatenated part features; output
    (B, 24, outplanes * expansion) pooled per-part rotation features."""

    def __init__(self, resnet_nums: int, inplanes: int, outplanes: int, groups: int = 24):
        super().__init__()
        block, layers = RESNET_SPEC[resnet_nums]
        self.groups = groups
        self.layer4 = ResLayer(block, inplanes, outplanes, layers[3], stride=2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.layer4(x).mean(dim=(2, 3))
        return pooled.reshape(x.shape[0], self.groups, -1)
