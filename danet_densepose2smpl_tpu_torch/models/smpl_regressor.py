"""Decomposed SMPL parameter regressor, 'gcn' strategy (port of the JAX
`models/smpl_regressor.py::DecomposedPredictor`).

body net (cam + shape) over the 75-ch global IUV map; limb net over the 24
partial IUV stacks; grouped layer4 -> per-part rotation features; rot2pos
GCN, learned-edge refinement GCN, pos2rot GCN; grouped 6D pose heads added
to the mean pose. Names follow the reference checkpoint
(`iuv2smpl.smpl_para_Outs.*`). The aux heads `pose_regressors.0` and
`coord_regressors.{0,1}` feed the train-only `joint_rotation` and
`joint_position` outputs; at eval they are not computed.

The constant tables (mean cam/shape, mean pose, the three adjacencies) stay
at least fp32 whatever dtype the module is cast to, as the JAX package's
jnp constants do: in a bf16 module the mean-pose add, the GCN adjacency
products and every layer after them run in fp32, as JAX's type promotion
has them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.nn.gcn import GCN, normalize_undigraph
from danet_densepose2smpl_tpu_torch.nn.layers import BNReLU
from danet_densepose2smpl_tpu_torch.nn.resnet import LimbResLayers, SmplResNet
from danet_densepose2smpl_tpu_torch.ops.rotations import rot6d_to_rotmat
from danet_densepose2smpl_tpu_torch.ops.structure import (
    pos2rot_adjacency,
    refine_edge_mask,
    rot2pos_adjacency,
)


class MeanParams(NamedTuple):
    """SPIN mean parameters (cam 3, shape 10, pose 24x6D)."""

    cam: np.ndarray
    shape: np.ndarray
    pose6d: np.ndarray


def default_mean_params() -> MeanParams:
    """T-pose / unit-scale fallback: identity rotations in 6D, zero shape,
    cam scale 0.9."""
    pose = np.tile(np.array([1, 0, 0, 1, 0, 0], dtype=np.float32), 24)
    return MeanParams(
        cam=np.array([0.9, 0.0, 0.0], dtype=np.float32),
        shape=np.zeros(10, dtype=np.float32),
        pose6d=pose,
    )


def load_mean_params(path: str | None) -> MeanParams:
    """SPIN's smpl_mean_params.npz (keys pose (144,), shape, cam), or
    `default_mean_params()` for None."""
    if path is None:
        return default_mean_params()
    d = np.load(path)
    return MeanParams(
        cam=np.asarray(d["cam"], dtype=np.float32).reshape(3),
        shape=np.asarray(d["shape"], dtype=np.float32).reshape(10),
        pose6d=np.asarray(d["pose"], dtype=np.float32).reshape(24 * 6),
    )


class Conv1x1BNRelu(BNReLU):
    """1x1 conv -> BN -> ReLU adapter (torch keys `.0`, `.1`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)


class PartwiseDense(nn.Sequential):
    """Per-part linear head: a groups=P 1x1 conv over the (B, P*C, 1, 1)
    stack of per-part features (the reference's Sequential(pool, conv), so
    the weight sits at `.1`). Takes and returns (B, P, C) / (B, P, O)."""

    def __init__(self, in_dim: int, out_dim: int, num_parts: int = 24):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(in_dim * num_parts, out_dim * num_parts, 1, groups=num_parts))
        self.num_parts = num_parts

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        conv = self[1]
        dt = torch.promote_types(x.dtype, conv.weight.dtype)   # einsum promotion in JAX
        y = F.conv2d(x.reshape(b, -1, 1, 1).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     groups=conv.groups)
        return y.reshape(b, self.num_parts, -1)


class DecomposedPredictor(nn.Module):
    CONSTANTS = ("mean_cam_shape", "mean_pose", "r2p_A", "p2r_A", "A_mask")

    def __init__(self, cfg: DaNetConfig, mean_params: MeanParams):
        super().__init__()
        r = cfg.refinement
        f = r.feat_dim
        self.position_heads = cfg.joint_position_weights > 0
        self.body_net = nn.Sequential(
            *Conv1x1BNRelu(75, 64),
            SmplResNet(cfg.glo_num_layers, in_channels=64, num_classes=13),
        )
        self.limb_net = nn.Sequential(
            *Conv1x1BNRelu(21, 64),
            SmplResNet(cfg.limb_num_layers, in_channels=64, num_classes=0, truncate=1),
        )
        self.limb_reslayer = LimbResLayers(
            cfg.limb_num_layers, self.limb_net[3].out_channels, f, groups=24,
        )
        part_dim = self.limb_reslayer.layer4.out_channels // 24
        self.r2p_gcn = GCN(part_dim, f, f, 1)
        self.refine_gcn = GCN(f, 2 * f, f, r.gcn_num_layer)
        self.p2r_gcn = GCN(f, f, f, 1)
        self.edge_importance = nn.Parameter(torch.ones(1, 24, 24))
        self.pose_regressors = nn.ModuleList(PartwiseDense(f, 6) for _ in range(2))
        self.coord_regressors = nn.ModuleList(PartwiseDense(f, 3) for _ in range(2))

        def const(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32))

        mp = mean_params
        self.register_buffer("mean_cam_shape", const(np.concatenate([mp.cam, mp.shape]))[None],
                             persistent=False)
        self.register_buffer("mean_pose", const(mp.pose6d)[None], persistent=False)
        self.register_buffer("r2p_A", const(rot2pos_adjacency()), persistent=False)
        self.register_buffer("p2r_A", const(pos2rot_adjacency()), persistent=False)
        self.register_buffer("A_mask", const(refine_edge_mask()), persistent=False)

    def _apply(self, fn, recurse=True):
        # keep the constant tables at promote(fp32, target dtype): .to(bf16)
        # moves them but leaves them fp32, .double() makes them f64
        kept = {name: self._buffers[name] for name in self.CONSTANTS}
        super()._apply(fn, recurse)
        for name, t in kept.items():
            moved = self._buffers[name]
            self._buffers[name] = t.to(device=moved.device,
                                       dtype=torch.promote_types(torch.float32, moved.dtype))
        return self

    def _to_rotmat_flat(self, pose6d: torch.Tensor) -> torch.Tensor:
        b = pose6d.shape[0]
        pose = pose6d.reshape(b, 144) + self.mean_pose
        return rot6d_to_rotmat(pose.reshape(b * 24, 6)).reshape(b, 216)

    def forward(self, iuv_map: torch.Tensor, part_iuv_map: torch.Tensor) -> dict:
        """iuv_map: (B, 75, S, S) channels_last; part_iuv_map:
        (B, 24, S, S, 3, 7). Returns {'para': (B, 229) = [cam 3, shape 10,
        rotmats 216], 'joint_rotation': [...], 'joint_position': [...]}; the
        two lists are filled in train mode only."""
        b = iuv_map.shape[0]
        out = {"joint_rotation": [], "joint_position": []}
        global_para, _ = self.body_net(iuv_map)
        global_para = global_para + self.mean_cam_shape

        s = part_iuv_map.shape[2]
        limb_in = part_iuv_map.reshape(b * 24, s, s, -1).permute(0, 3, 1, 2)
        _, limb_feat = self.limb_net(limb_in)
        hs = limb_feat.shape[-1]
        rot_feats = self.limb_reslayer(limb_feat.reshape(b, -1, hs, hs))   # (B, 24, F)
        if self.training:
            out["joint_rotation"].append(self._to_rotmat_flat(self.pose_regressors[0](rot_feats)))

        pos_init = self.r2p_gcn(rot_feats, self.r2p_A)
        positions = self.training and self.position_heads
        if positions:
            out["joint_position"].append(self.coord_regressors[0](pos_init))
        ei = self.edge_importance[0]
        graph_A = self.A_mask * F.relu(ei)
        eye = torch.eye(24, dtype=graph_A.dtype, device=ei.device)
        pos_refined = pos_init + self.refine_gcn(pos_init, normalize_undigraph(eye + graph_A))
        if positions:
            out["joint_position"].append(self.coord_regressors[1](pos_refined))
        rot_refined = self.p2r_gcn(pos_refined, self.p2r_A)

        local_pose = self.pose_regressors[1](rot_refined)                    # (B, 24, 6)
        out["para"] = torch.cat([global_para, self._to_rotmat_flat(local_pose)], dim=1)
        return out
