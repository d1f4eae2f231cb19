"""The SMPL parameter regressor of the reference: a frozen copy of the
port's `models/smpl_regressor.py::DecomposedPredictor` under the 'gcn'
strategies (the configurations' 'gcn'; 'gcn_direct' as it comes).

Body net (cam + shape) over the 75-ch global IUV map; limb net over the
24 partial IUV stacks; grouped layer4 -> per-part rotation features; the
rot2pos GCN, the learned-edge refinement GCN, the pos2rot GCN, and grouped
6D pose heads added to the mean pose. The aux heads feed the train-only
`joint_rotation` and `joint_position` outputs. Names follow the reference
checkpoint (`iuv2smpl.smpl_para_Outs.*`). The constant tables stay at
least fp32 whatever dtype the module is cast to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.config import DaNetConfig
from port_bench.reference.nn.gcn import GCN, normalize_undigraph
from port_bench.reference.nn.layers import BNReLU
from port_bench.reference.nn.resnet import LimbResLayers, SmplResNet
from port_bench.reference.ops.rotations import rot6d_to_rotmat
from port_bench.reference.ops.structure import pos2rot_adjacency, refine_edge_mask, rot2pos_adjacency

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


def input_channels(input_mode: str, feat_channels: int) -> tuple[int, int]:
    """The (body net, limb net) input channels of an input mode, with
    `feat_channels` the backbone's width: the IUV maps (75) and the 3x7
    part stacks (21); with the backbone features and their part crops
    after them in the *_feat modes; the features alone in 'feat'; the
    cleaned index map (25) and index stacks (7) in 'seg'."""
    c = feat_channels
    return {"iuv": (75, 21), "iuv_gt": (75, 21), "iuv_feat": (75 + c, 21 + c),
            "iuv_gt_feat": (75 + c, 21 + c), "feat": (c, c), "seg": (25, 7)}[input_mode]


def _concat(parts, dim: int, weight: torch.Tensor) -> torch.Tensor:
    """The given inputs concatenated along `dim`, in at least the dtype of
    the adapter's `weight`, as JAX promotes them (the GT render's fp32
    maps reach an f64 model)."""
    parts = [t for t in parts if t is not None]
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
    return x.to(torch.promote_types(x.dtype, weight.dtype))


class DecomposedPredictor(nn.Module):
    CONSTANTS = ("mean_cam_shape", "mean_pose", "r2p_A", "p2r_A", "A_mask")

    def __init__(self, cfg: DaNetConfig, mean_params: MeanParams, feat_channels: int = 0):
        super().__init__()
        r = cfg.refinement
        body_cin, limb_cin = input_channels(cfg.input_mode, feat_channels)
        f = r.feat_dim
        self.strategy = cfg.refine_strategy
        self.refine_on = r.refine_on
        self.stack_num = r.stack_num
        self.position_heads = (cfg.joint_position_weights > 0 and r.pos_intersupv
                               and self.strategy == "gcn")
        self.body_net = nn.Sequential(
            *Conv1x1BNRelu(body_cin, 64),
            SmplResNet(cfg.glo_num_layers, in_channels=64, num_classes=13),
        )
        self.limb_net = nn.Sequential(
            *Conv1x1BNRelu(limb_cin, 64),
            SmplResNet(cfg.limb_num_layers, in_channels=64, num_classes=0, truncate=1),
        )
        self.limb_reslayer = LimbResLayers(
            cfg.limb_num_layers, self.limb_net[3].out_channels, f, groups=24,
        )
        part_dim = self.limb_reslayer.layer4.out_channels // 24
        if self.strategy in ("gcn", "gcn_direct"):
            if self.strategy == "gcn":
                self.r2p_gcn = GCN(part_dim, f, f, 1)
            if self.refine_on:
                self.refine_gcn = GCN(f, 2 * f, f, r.gcn_num_layer)
                self.edge_importance = nn.Parameter(torch.ones(1, 24, 24))
            if self.strategy == "gcn":
                self.p2r_gcn = GCN(f, f, f, 1)
            self.pose_regressors = nn.ModuleList(PartwiseDense(f, 6) for _ in range(2))
            if self.position_heads:
                self.coord_regressors = nn.ModuleList(
                    PartwiseDense(f, 3) for _ in range(2 if self.refine_on else 1))
        else:
            raise ValueError(f"the reference regressor refines by 'gcn' or 'gcn_direct', not '{self.strategy}'")

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

    def forward(self, iuv_map: torch.Tensor | None, part_iuv_map: torch.Tensor | None,
                global_feats: torch.Tensor | None = None, part_feats: torch.Tensor | None = None) -> dict:
        """iuv_map: (B, 75, S, S) channels_last (the cleaned index map
        (B, 25, S, S) in 'seg', None in 'feat'); part_iuv_map:
        (B, 24, S, S, 3, 7) (the index stacks (B, 24, S, S, 7) in 'seg', None
        in 'feat'); global_feats (B, C, S, S) and part_feats
        (B, 24, S, S, C): the backbone features and their part crops in the
        feature modes, after the IUV channels. Returns {'para': (B, 229) =
        [cam 3, shape 10, rotmats 216], 'joint_rotation': [...],
        'joint_position': [...]}; the two lists are filled in train mode
        only."""
        body_in = _concat((iuv_map, global_feats), 1, self.body_net[0].weight)
        b = body_in.shape[0]
        out = {"joint_rotation": [], "joint_position": []}
        global_para, _ = self.body_net(body_in)
        global_para = global_para + self.mean_cam_shape

        if part_iuv_map is not None:
            part_iuv_map = part_iuv_map.reshape(*part_iuv_map.shape[:4], -1)
        part_in = _concat((part_iuv_map, part_feats), -1, self.limb_net[0].weight)   # (B, 24, S, S, Cin)
        s = part_in.shape[2]
        limb_in = part_in.reshape(b * 24, s, s, -1).permute(0, 3, 1, 2)
        _, limb_feat = self.limb_net(limb_in)
        hs = limb_feat.shape[-1]
        rot_feats = self.limb_reslayer(limb_feat.reshape(b, -1, hs, hs))   # (B, 24, F)
        smpl_pose = self._gcn_refine(rot_feats, out)
        dt = torch.promote_types(global_para.dtype, smpl_pose.dtype)
        out["para"] = torch.cat([global_para.to(dt), smpl_pose.to(dt)], dim=1)
        return out

    def _gcn_refine(self, rot_feats: torch.Tensor, out: dict) -> torch.Tensor:
        gcn = self.strategy == "gcn"
        if self.training:
            out["joint_rotation"].append(self._to_rotmat_flat(self.pose_regressors[0](rot_feats)))

        pos_init = self.r2p_gcn(rot_feats, self.r2p_A) if gcn else rot_feats
        positions = self.training and self.position_heads
        if positions:
            out["joint_position"].append(self.coord_regressors[0](pos_init))
        pos_refined = pos_init
        if self.refine_on:
            ei = self.edge_importance[0]
            graph_A = self.A_mask * F.relu(ei)
            eye = torch.eye(24, dtype=graph_A.dtype, device=ei.device)
            pos_refined = pos_init + self.refine_gcn(pos_init, normalize_undigraph(eye + graph_A))
            if positions:
                out["joint_position"].append(self.coord_regressors[1](pos_refined))
        rot_refined = self.p2r_gcn(pos_refined, self.p2r_A) if gcn else pos_refined

        local_pose = self.pose_regressors[1](rot_refined)                    # (B, 24, 6)
        return self._to_rotmat_flat(local_pose)
