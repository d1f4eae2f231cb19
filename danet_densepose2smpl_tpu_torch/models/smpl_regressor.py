"""SMPL parameter regressors (port of the JAX `models/smpl_regressor.py`).

`DecomposedPredictor`: body net (cam + shape) over the 75-ch global IUV
map; limb net over the 24 partial IUV stacks (other inputs in the
ablation modes, see `input_channels`); grouped layer4 -> per-part
rotation features; then the refinement strategy, as the JAX package has it:
  - 'gcn': rot2pos GCN, learned-edge refinement GCN, pos2rot GCN;
  - 'gcn_direct': the refinement GCN alone on the rotation features;
  - 'lstm': per-joint rot2pos MLPs swept down the kinematic branches,
    Bi-LSTMs along six root-anchored chains (the trunk chain's final
    carries seed the chains that branch off it), (parent, self, child)
    aggregation and a shared pos2rot MLP;
  - 'lstm_direct': the Bi-LSTMs on the rotation features, with 9-channel
    rotation heads and no mean pose;
and grouped 6D pose heads added to the mean pose. `refine_on=False` drops
the refinement GCN, `pos_intersupv=False` the coordinate heads. The aux
heads feed the train-only `joint_rotation` and `joint_position` outputs
(at eval they are not computed), except 'lstm_direct', which emits its
first head's rotations in eval mode too, as the JAX package does.

`GlobalPredictor` (`decomposed=False`): one ResNet on the body net's input
(the 75-ch IUV map in 'iuv') -> 229 params.

Names follow the reference checkpoint (`iuv2smpl.smpl_para_Outs.*`); the
GlobalPredictor, whose reference names are not known, is named after the
JAX package's flax tree. The Bi-LSTMs are `torch.nn.LSTM`s, as the
reference's (the JAX package runs flax's `nn.RNN` there, no Pallas).

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
from danet_densepose2smpl_tpu_torch.nn.layers import BNReLU, FP32Constants, bn, conv
from danet_densepose2smpl_tpu_torch.nn.resnet import LimbResLayers, SmplResNet
from danet_densepose2smpl_tpu_torch.ops.rotations import rot6d_to_rotmat
from danet_densepose2smpl_tpu_torch.ops.structure import (
    SMPL_CHILD2,
    SMPL_PARENT,
    pos2rot_adjacency,
    refine_edge_mask,
    rot2pos_adjacency,
)

# Kinematic-branch orders of the LSTM strategies (copies of the JAX
# package's, pinned equal by tests/test_torch_archs.py): the limb branches
# of the rot2pos sweep, and the root-anchored chains the Bi-LSTMs run along.
LIMB_BRANCHES = (
    (0, 3, 6, 9, 12, 15),
    (13, 16, 18, 20, 22),
    (14, 17, 19, 21, 23),
    (1, 4, 7, 10),
    (2, 5, 8, 11),
)
LSTM_CHAINS = (
    (0, 3, 6, 9),
    (12, 15),
    (9, 13, 16, 18, 20, 22),
    (9, 14, 17, 19, 21, 23),
    (0, 1, 4, 7, 10),
    (0, 2, 5, 8, 11),
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


class MLP1x1(nn.Sequential):
    """conv1x1 -> BN -> ReLU -> conv1x1 -> BN -> ReLU over (B, N, C) node
    features, the node axis folded into the batch, so BatchNorm normalizes
    over the B*N samples (torch keys `.0/.1/.3/.4`, as the reference's
    Sequential)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__(conv(cin, hidden, 1, bias=True), bn(hidden), nn.ReLU(inplace=True),
                         conv(hidden, cout, 1, bias=True), bn(cout), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return super().forward(x.reshape(b * n, c, 1, 1)).reshape(b, n, -1)


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


class GlobalPredictor(nn.Module):
    """One ResNet on the body input -> para (B, 229) = [cam 3, shape 10,
    rotmats 216] read as they come (no mean params, no 6D), as the JAX
    package's. Modules named after its flax tree: `Conv1x1BNRelu_0`,
    `conv_body`."""

    def __init__(self, cfg: DaNetConfig, feat_channels: int = 0):
        super().__init__()
        self.Conv1x1BNRelu_0 = Conv1x1BNRelu(input_channels(cfg.input_mode, feat_channels)[0], 64)
        self.conv_body = SmplResNet(cfg.glo_num_layers, in_channels=64, num_classes=229)

    def forward(self, iuv_map: torch.Tensor | None, global_feats: torch.Tensor | None = None) -> dict:
        """iuv_map: (B, 75, S, S) channels_last (the index map (B, 25, S, S)
        in 'seg', None in 'feat'); global_feats: the backbone features
        (B, C, S, S) in the feature modes, after the IUV channels. Returns
        {'para'}."""
        adapter = self.Conv1x1BNRelu_0
        para, _ = self.conv_body(adapter(_concat((iuv_map, global_feats), 1, adapter[0].weight)))
        return {"para": para}


class DecomposedPredictor(FP32Constants):
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
                               and self.strategy in ("gcn", "lstm"))
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
        elif self.strategy in ("lstm", "lstm_direct"):
            direct = self.strategy == "lstm_direct"
            # the reference's Bi-LSTMs: lstm(x (B, T, F), (h0, c0)) returns
            # (y (B, T, 2F), (h, c)), each carry (2, B, F), forward first
            self.limb_lstm = nn.ModuleList(
                nn.ModuleList(nn.LSTM(f, f, batch_first=True, bidirectional=True) for _ in range(5))
                for _ in range(r.stack_num))
            heads = [PartwiseDense(f, 9 if direct else 6)]
            heads += [PartwiseDense(2 * f, 9) if direct else PartwiseDense(f, 6) for _ in range(r.stack_num)]
            self.pose_regressors = nn.ModuleList(heads)
            if not direct:
                self.rot2pos = nn.ModuleList(
                    nn.ModuleList(MLP1x1(2 * f, 512, f) for _ in range(24)) for _ in range(r.stack_num))
                self.pos2rot = nn.ModuleList(MLP1x1(6 * f, 1024, f) for _ in range(r.stack_num))
            if self.position_heads:   # stack s: 2s before the Bi-LSTMs, 2s + 1 after
                self.coord_regressors = nn.ModuleList(
                    PartwiseDense(f if i % 2 == 0 else 2 * f, 3) for i in range(2 * r.stack_num))
        else:
            raise ValueError(f"unknown refine strategy '{self.strategy}'")

        def const(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32))

        mp = mean_params
        self.register_buffer("mean_cam_shape", const(np.concatenate([mp.cam, mp.shape]))[None],
                             persistent=False)
        self.register_buffer("mean_pose", const(mp.pose6d)[None], persistent=False)
        self.register_buffer("r2p_A", const(rot2pos_adjacency()), persistent=False)
        self.register_buffer("p2r_A", const(pos2rot_adjacency()), persistent=False)
        self.register_buffer("A_mask", const(refine_edge_mask()), persistent=False)

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
        'joint_position': [...]}; the two lists are filled in train mode only
        (and 'lstm_direct''s first rotations at eval too)."""
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
        if self.strategy in ("gcn", "gcn_direct"):
            smpl_pose = self._gcn_refine(rot_feats, out)
        else:
            smpl_pose = self._lstm_refine(rot_feats, out)
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

    def _lstm_refine(self, rot_feats: torch.Tensor, out: dict) -> torch.Tensor:
        direct = self.strategy == "lstm_direct"
        b = rot_feats.shape[0]
        positions = self.training and self.position_heads

        init_pose = self.pose_regressors[0](rot_feats)
        if self.training or direct:
            out["joint_rotation"].append(init_pose.reshape(b, -1) if direct
                                         else self._to_rotmat_flat(init_pose))
        feats, smpl_pose = rot_feats, None
        for s_i in range(self.stack_num):
            if direct:
                # every stack starts again from the rotation features; only
                # the last stack's head survives
                pos = [rot_feats[:, i] for i in range(24)]
            else:
                # rot2pos sweep: a joint's MLP on (its parent's position,
                # its parent's rotation feature); the root first sees itself
                pos = [None] * 24
                pos[0] = feats[:, 0]
                for branch in LIMB_BRANCHES:
                    for ind in branch:
                        p = int(SMPL_PARENT[ind])
                        pos[ind] = self.rot2pos[s_i][ind](torch.cat([pos[p], feats[:, p]], -1)[:, None])[:, 0]
                if positions:
                    out["joint_position"].append(self.coord_regressors[2 * s_i](torch.stack(pos, 1)))

            # Bi-LSTMs along the six chains; the trunk chain's final carries
            # seed chains 1-3 (chain 1 runs the trunk's own LSTM again)
            lstms, refined = self.limb_lstm[s_i], [None] * 24
            y, carry = lstms[0](torch.stack([pos[i] for i in LSTM_CHAINS[0]], 1))
            for t, ind in enumerate(LSTM_CHAINS[0]):
                refined[ind] = y[:, t]
            for chain, lstm, init in zip(LSTM_CHAINS[1:], (lstms[0], lstms[1], lstms[2], lstms[3], lstms[4]),
                                         (carry, carry, carry, None, None)):
                y, _ = lstm(torch.stack([pos[i] for i in chain], 1), init)
                for t, ind in enumerate(chain):
                    # the root keeps the trunk's output; joint 9 heads chains
                    # 2 and 3, so chain 3's output wins
                    if ind != 0:
                        refined[ind] = y[:, t]
            # residual update in the doubled (bidirectional) width
            pos2 = [torch.cat([pos[i], pos[i]], -1) + refined[i] for i in range(24)]

            if direct:
                smpl_pose = self.pose_regressors[s_i + 1](torch.stack(pos2, 1)).reshape(b, -1)
                continue
            if positions:
                out["joint_position"].append(self.coord_regressors[2 * s_i + 1](torch.stack(pos2, 1)))
            tri = torch.stack([torch.cat([pos2[int(SMPL_PARENT[i])], pos2[i], pos2[int(SMPL_CHILD2[i])]], -1)
                               for i in range(24)], 1)                           # (B, 24, 6F)
            feats = self.pos2rot[s_i](tri)
            smpl_pose = self._to_rotmat_flat(self.pose_regressors[s_i + 1](feats))
        return smpl_pose
