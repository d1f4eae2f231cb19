"""DaNet of the reference: a frozen copy of the port's `models/danet.py`
in the input mode the configurations state, 'iuv', with the decomposed
regressor: image -> IUV estimator -> cleaned IUV maps and part stacks ->
SMPL parameters. In train mode the model draws PartDrop and STN jitter
noise from a generator and returns the train outputs: `iuv_clean`,
`part_iuv_clean` and the regressor's `joint_rotation` / `joint_position`
lists.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from port_bench.reference.config import DaNetConfig
from port_bench.reference.models.iuv_estimator import IUVEstimator
from port_bench.reference.models.smpl_regressor import DecomposedPredictor, MeanParams, default_mean_params
from port_bench.reference.ops.iuvmap import iuvmap_clean
from port_bench.reference.ops.structure import DP2SMPL_MAPPING


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
    """Full model in 'iuv' mode. `forward(image_nhwc)` returns para
    (B, 229), pred_cam (B, 3), pred_shape (B, 10), pred_rotmat
    (B, 24, 3, 3), the estimator's maps under iuv_raw, the cleaned maps
    under iuv_clean and part_iuv_clean, and the joint_rotation and
    joint_position lists (filled in train mode). A new model is in eval
    mode."""

    def __init__(self, cfg: DaNetConfig | None = None, mean_params: MeanParams | None = None):
        super().__init__()
        cfg = cfg or DaNetConfig()
        if cfg.input_mode != "iuv" or not cfg.decomposed:
            raise ValueError("the reference DaNet runs input_mode 'iuv' with the decomposed regressor")
        self.cfg = cfg
        self.img2iuv = IUVEstimator(cfg)
        self.iuv2smpl = _SMPLRegressor(DecomposedPredictor(cfg, mean_params or default_mean_params(), 0))
        super().train(False)

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
        est = self.img2iuv(image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last), noise)
        out = {"iuv_raw": est}
        part_iuv = est["part_iuv"]
        u, v, index, ann = est["u"], est["v"], est["index"], est["ann"]
        if self.training and c.partdrop_rate > 0:
            drop = noise["partdrop"] < c.partdrop_rate
            u, v, index = apply_partdrop_global(u, v, index, drop)
            part_iuv = apply_partdrop_partial(part_iuv, drop)

        u_cl, v_cl, index_cl, ann_cl = iuvmap_clean(u, v, index, ann)
        out["iuv_clean"] = (u_cl, v_cl, index_cl, ann_cl)
        if pretrain_mode:
            return out
        body_in = torch.cat([u_cl, v_cl, index_cl], dim=-1).permute(0, 3, 1, 2)   # (B, 75, S, S)
        part_map = clean_part_stacks(part_iuv)
        out["part_iuv_clean"] = part_map
        out.update(self.iuv2smpl.smpl_para_Outs(body_in, part_map, None, None))
        para = out["para"] = out["para"].to(torch.promote_types(out["para"].dtype, torch.float32))
        out["pred_cam"] = para[:, :3]
        out["pred_shape"] = para[:, 3:13]
        out["pred_rotmat"] = para[:, 13:].reshape(-1, 24, 3, 3)
        return out
