"""DaNet in 'iuv' mode: image -> IUV -> SMPL parameters (port of the JAX
`models/danet.py::DaNet`), for serving (eval) and training.

In train mode the model draws PartDrop and STN jitter noise (or takes it
injected, see `draw_noise`), drops patches from the regressor's inputs, and
returns the JAX train outputs: `iuv_clean`, `part_iuv_clean` and the
regressor's `joint_rotation` / `joint_position` lists. Configurations
outside the slice raise `NotImplementedError` naming the ROADMAP item that
will port them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.models.iuv_estimator import IUVEstimator
from danet_densepose2smpl_tpu_torch.models.smpl_regressor import (
    DecomposedPredictor,
    MeanParams,
    default_mean_params,
)
from danet_densepose2smpl_tpu_torch.ops.iuvmap import iuvmap_clean
from danet_densepose2smpl_tpu_torch.ops.structure import DP2SMPL_MAPPING


def check_config(cfg: DaNetConfig) -> None:
    """Raise for configurations this port does not run yet."""
    unported = (
        (cfg.iuv_regressor != "hrnet", f"iuv_regressor='{cfg.iuv_regressor}'", 20),
        (cfg.input_mode != "iuv", f"input_mode='{cfg.input_mode}'", 20),
        (cfg.refine_strategy != "gcn", f"refine_strategy='{cfg.refine_strategy}'", 20),
        (not cfg.decomposed, "decomposed=False (GlobalPredictor)", 20),
        (cfg.hrnet_pad_channels, "hrnet_pad_channels", "'Deliberately not ported'"),
        (not cfg.refinement.refine_on or not cfg.refinement.pos_intersupv,
         "refinement without refine_on/pos_intersupv", 20),
    )
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet (ROADMAP.md queue 1, item {item})")


def check_train_config(cfg: DaNetConfig) -> None:
    """Raise for train-mode options this port does not run yet."""
    for bad, what in ((cfg.remat_backbone, "remat_backbone=True"),
                      (cfg.part_head_chunks > 1, f"part_head_chunks={cfg.part_head_chunks}")):
        if bad:
            raise NotImplementedError(
                f"{what} in train mode is not ported to PyTorch yet: port activation "
                "checkpointing or the chunked crop only if H100 memory calls for it "
                "(ROADMAP.md queue 1, item 13)")


def draw_noise(cfg: DaNetConfig, batch: int, generator: torch.Generator, device) -> dict:
    """The train-mode uniforms in [0, 1), fp32, drawn from `generator` on
    its own device: 'center' (B, 24, 2) and 'scale' (2, B, 24) for the STN
    jitter, 'partdrop' (B, 24). Only the ones the config uses."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=generator.device).to(device)

    noise = {}
    if cfg.stn_center_jitter > 0:
        noise["center"] = uniform(batch, 24, 2)
    if cfg.stn_scale_jitter > 0:
        noise["scale"] = uniform(2, batch, 24)
    if cfg.partdrop_rate > 0:
        noise["partdrop"] = uniform(batch, 24)
    return noise


def apply_partdrop_global(u, v, index, drop: torch.Tensor):
    """Zero the channels (patch i -> channel i+1) of dropped patches; the
    background channel is kept. u/v/index (B, S, S, 25); drop (B, 24)."""
    keep = 1.0 - drop.to(u.dtype)
    keep = torch.cat([torch.ones_like(keep[:, :1]), keep], dim=1)[:, None, None, :]
    return u * keep, v * keep, index * keep


def apply_partdrop_partial(part_iuv: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """Zero the channels of dropped patches in the partial stacks: local
    channel j+1 of part p carries patch DP2SMPL_MAPPING[p, j].
    part_iuv (B, 24, S, S, 3, 7)."""
    mapping = torch.as_tensor(DP2SMPL_MAPPING.astype("int64") - 1, device=drop.device)
    keep = 1.0 - drop[:, mapping].to(part_iuv.dtype)                     # (B, 24, 6)
    keep = torch.cat([torch.ones_like(keep[..., :1]), keep], dim=-1)     # (B, 24, 7)
    return part_iuv * keep[:, :, None, None, None, :]


def clean_part_stacks(part_iuv: torch.Tensor) -> torch.Tensor:
    """One-hot each part's 7-ch index stack and mask its U/V, the part axis
    folded into the batch. part_iuv: (B, P, S, S, 3, 7)."""
    b, p, s, _, _, k = part_iuv.shape
    u = part_iuv[..., 0, :].reshape(b * p, s, s, k)
    v = part_iuv[..., 1, :].reshape(b * p, s, s, k)
    idx = part_iuv[..., 2, :].reshape(b * p, s, s, k)
    cu, cv, ci, _ = iuvmap_clean(u, v, idx)
    return torch.stack([cu, cv, ci], dim=-2).reshape(b, p, s, s, 3, k)


class _SMPLRegressor(nn.Module):
    """Namespace holder so the predictor's keys read
    `iuv2smpl.smpl_para_Outs.*`, as in the reference checkpoint."""

    def __init__(self, predictor: nn.Module):
        super().__init__()
        self.smpl_para_Outs = predictor


class DaNet(nn.Module):
    """Full model. `forward(image_nhwc)` returns the JAX output dict: para
    (B, 229), pred_cam (B, 3), pred_shape (B, 10), pred_rotmat
    (B, 24, 3, 3), the estimator's maps under iuv_raw, the cleaned maps
    under iuv_clean and part_iuv_clean, and the joint_rotation and
    joint_position lists (filled in train mode). A new model is in eval
    mode."""

    def __init__(self, cfg: DaNetConfig | None = None, mean_params: MeanParams | None = None):
        super().__init__()
        cfg = cfg or DaNetConfig()
        check_config(cfg)
        self.cfg = cfg
        self.img2iuv = IUVEstimator(cfg)
        self.iuv2smpl = _SMPLRegressor(DecomposedPredictor(cfg, mean_params or default_mean_params()))
        super().train(False)

    def train(self, mode: bool = True):
        if mode:
            check_train_config(self.cfg)
        return super().train(mode)

    def forward(self, image: torch.Tensor, pretrain_mode: bool = False,
                generator: torch.Generator | None = None, noise: dict | None = None) -> dict:
        """image: (B, H, W, 3) normalized RGB. In train mode the jitter and
        PartDrop uniforms come from `noise` (see `draw_noise`) or are drawn
        from `generator`; `pretrain_mode` stops after the IUV estimator."""
        c = self.cfg
        b = image.shape[0]
        if self.training and noise is None:
            if generator is None and (c.stn_center_jitter > 0 or c.stn_scale_jitter > 0
                                      or c.partdrop_rate > 0):
                raise ValueError("DaNet in train mode draws its noise from an explicit "
                                 "torch.Generator: pass generator= or noise=")
            noise = draw_noise(c, b, generator, image.device) if generator is not None else {}
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        est = self.img2iuv(x, noise)
        u, v, index, ann = est["u"], est["v"], est["index"], est["ann"]
        part_iuv = est["part_iuv"]
        if self.training and c.partdrop_rate > 0:
            drop = noise["partdrop"] < c.partdrop_rate
            u, v, index = apply_partdrop_global(u, v, index, drop)
            part_iuv = apply_partdrop_partial(part_iuv, drop)

        u_cl, v_cl, index_cl, ann_cl = iuvmap_clean(u, v, index, ann)
        out = {"iuv_raw": est, "iuv_clean": (u_cl, v_cl, index_cl, ann_cl)}
        if pretrain_mode:
            return out
        iuv_map = torch.cat([u_cl, v_cl, index_cl], dim=-1).permute(0, 3, 1, 2)  # (B, 75, S, S)
        part_map = clean_part_stacks(part_iuv)
        out["part_iuv_clean"] = part_map
        smpl_out = self.iuv2smpl.smpl_para_Outs(iuv_map, part_map)
        out.update(smpl_out)
        para = smpl_out["para"]
        out["pred_cam"] = para[:, :3]
        out["pred_shape"] = para[:, 3:13]
        out["pred_rotmat"] = para[:, 13:].reshape(-1, 24, 3, 3)
        return out
