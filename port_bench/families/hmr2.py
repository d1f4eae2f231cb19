"""The HMR 2.0 family: a ViT-H/16 trunk and an SMPL transformer-decoder
head (the port's `models/hmr2.py::HMR2` behind `serve.py::Predictor`; the
plain reference `port_bench/reference/models/hmr2.py`). A configuration
file holds the model's sizes under `hmr2` (HMR2Config's fields); the
CPU tests' `overrides` replace fields. Serving only. The interface is
`families/__init__.py`'s; the outputs and SMPL are DaNet's
(`families/danet.py::reference_outputs`)."""

from __future__ import annotations

import re

import torch
import torch.nn as nn

from port_bench.families.danet import reference_outputs  # noqa: F401 (the same outputs and SMPL)
from port_bench.harness.weights import derive_seed, fill_weights_, round_to_

kinds = ("serve_closed",)
# the head's readouts, near zero so the first predictions are the mean
# parameters, as a fresh HMR-style head
output_layers = re.compile(r"smpl_head\.(decpose|decshape|deccam)$")
left_to_construction = ()   # the mean parameters are the head's `CONSTANTS`


def leaves(model: nn.Module) -> list:
    """Every LayerNorm (scale in [0.5, 1], shift N(0, 0.01), as the
    generic BatchNorm draws), the trunk's positions N(0, 0.02) (4D-Humans'
    `trunc_normal_(std=.02)`) and the decoder's N(0, 1) (its
    `torch.randn`)."""
    out = []
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            out += [(m.weight, "u", 0.5, 0.5), (m.bias, "n", 0.01, 0.0)]
    return out + [(model.backbone.pos_embed, "n", 0.02, 0.0),
                  (model.smpl_head.transformer.pos_embedding, "n", 1.0, 0.0)]


def configs(config: dict, traffic: dict, overrides: dict | None = None) -> tuple:
    from danet_densepose2smpl_tpu_torch.models.hmr2 import HMR2Config
    from port_bench.reference.models.hmr2 import HMR2Config as ReferenceConfig

    fields = {**config["hmr2"], **(overrides or {})}
    return HMR2Config(**fields), ReferenceConfig(**fields)


def image_hw(cfg) -> tuple:
    return cfg.image_size, cfg.image_size


def reference_model(cfg, seed: int, device, served_dtype: torch.dtype = torch.float32):
    """The reference HMR 2.0 of `cfg` on `device` with the seed's weights,
    rounded to `served_dtype` (`round_to_`)."""
    from port_bench.reference.models.hmr2 import HMR2

    torch.manual_seed(derive_seed(seed, "module-init"))
    with torch.device(device):
        model = HMR2(cfg)
    drawn = fill_weights_(model, seed, leaves(model), output_layers, left_to_construction)
    return round_to_(drawn, served_dtype)


def port_server(cfg, ref_cfg, seed: int, dtype: torch.dtype, device, smpl):
    """The port's `Predictor.predict` serving `HMR2` with the seed's
    weights (the reference's state dict, loaded as a checkpoint)."""
    from danet_densepose2smpl_tpu_torch.models.hmr2 import HMR2
    from danet_densepose2smpl_tpu_torch.serve import Predictor
    from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel

    weights = reference_model(ref_cfg, seed, device).state_dict()
    with torch.device(device):
        model = HMR2(cfg)
    model.load_state_dict(weights)
    del weights
    return Predictor(device, dtype, model=model, smpl=SMPLModel(*smpl)).predict
