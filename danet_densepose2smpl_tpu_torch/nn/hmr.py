"""HMR / SPIN baseline (port of the JAX `nn/hmr.py`): a ResNet-50 trunk,
global pooling, then 3 iterative-error-feedback steps of (concat [feature,
pose, shape, cam] -> fc1 1024 -> dropout -> fc2 1024 -> dropout -> residual
decoders), the 6D pose turned into rotation matrices. `cli.eval
--regressor hmr` runs it.

Names are the reference checkpoint's (torchvision's ResNet names, fc1, fc2,
decpose, decshape, deccam), so a released SPIN checkpoint loads name for
name; its `init_*` mean-parameter buffers are not part of this module (the
caller passes the mean parameters). Dropout acts in train mode only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from danet_densepose2smpl_tpu_torch.nn.layers import Bottleneck, ResLayer, bn, bn_act, conv, max_pool_3x3_s2
from danet_densepose2smpl_tpu_torch.ops.rotations import rot6d_to_rotmat

NPOSE = 24 * 6


class HMR(nn.Module):
    def __init__(self, n_iter: int = 3):
        super().__init__()
        self.n_iter = n_iter
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = bn(64)
        self.layer1 = ResLayer(Bottleneck, 64, 64, 3)
        self.layer2 = ResLayer(Bottleneck, 256, 128, 4, stride=2)
        self.layer3 = ResLayer(Bottleneck, 512, 256, 6, stride=2)
        self.layer4 = ResLayer(Bottleneck, 1024, 512, 3, stride=2)
        self.fc1 = nn.Linear(2048 + NPOSE + 13, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, NPOSE)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)
        self.drop = nn.Dropout(0.5)

    def forward(self, image: torch.Tensor, init_pose: torch.Tensor, init_shape: torch.Tensor,
                init_cam: torch.Tensor):
        """image: (B, H, W, 3) normalized RGB; init_*: the mean parameters,
        broadcastable to (B, 144), (B, 10), (B, 3). Returns (rotmats
        (B, 24, 3, 3), shape (B, 10), cam (B, 3))."""
        b = image.shape[0]
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = max_pool_3x3_s2(bn_act(self.bn1, self.conv1(x), relu=True))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        xf = x.mean(dim=(2, 3))                                        # (B, 2048)
        pose = init_pose.to(xf.dtype).expand(b, NPOSE)
        shape = init_shape.to(xf.dtype).expand(b, 10)
        cam = init_cam.to(xf.dtype).expand(b, 3)
        for _ in range(self.n_iter):
            xc = self.drop(self.fc1(torch.cat([xf, pose, shape, cam], dim=1)))
            xc = self.drop(self.fc2(xc))
            pose = self.decpose(xc) + pose
            shape = self.decshape(xc) + shape
            cam = self.deccam(xc) + cam
        rotmats = rot6d_to_rotmat(pose.reshape(b * 24, 6)).reshape(b, 24, 3, 3)
        return rotmats, shape, cam
