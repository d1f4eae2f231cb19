"""A toy model family that is not DaNet, for the tests of the family
interface (`port_bench/families/__init__.py`): a pre-LN transformer over
the patches of a non-square image, with a learned positional embedding,
and a query token that cross-attends to the image tokens and gives the
camera, the shape and 6D rotations, so `para` (B, 229) and then SMPL. The
port's `Predictor` serves it; the same module in fp32 is its reference.
Its LayerNorms, its free parameters and the attention's packed input
projection are drawn through `leaves`."""

from __future__ import annotations

import re

import torch
import torch.nn as nn

from port_bench.families.danet import reference_outputs  # noqa: F401 (the same outputs and SMPL)
from port_bench.harness.weights import derive_seed, fill_weights_, round_to_
from port_bench.reference.ops.rotations import rot6d_to_rotmat

kinds = ("serve_closed",)
output_layers = re.compile(r"head$")
left_to_construction = ()
IDENTITY_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


class Block(nn.Module):
    """x + attention(LN(x)), then x + MLP(LN(x)); attention by hand."""

    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.heads = heads
        self.ln1, self.ln2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.qkv, self.proj = nn.Linear(width, 3 * width), nn.Linear(width, width)
        self.mlp = nn.Sequential(nn.Linear(width, mlp), nn.GELU(), nn.Linear(mlp, width))

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(self.ln1(x)).view(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) * (d // self.heads) ** -0.5, dim=-1)
        x = x + self.proj((att @ v).transpose(1, 2).reshape(b, n, d))
        return x + self.mlp(self.ln2(x))


class ToyTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h, w = cfg["img_hw"]
        p, d = cfg["patch"], cfg["width"]
        self.patch = nn.Conv2d(3, d, p, stride=p)
        self.pos = nn.Parameter(torch.zeros(1, (h // p) * (w // p), d))
        self.blocks = nn.ModuleList(Block(d, cfg["heads"], cfg["mlp"]) for _ in range(cfg["blocks"]))
        self.norm = nn.LayerNorm(d)
        self.query = nn.Parameter(torch.zeros(1, 1, d))
        self.cross = nn.MultiheadAttention(d, cfg["heads"], batch_first=True)
        self.head = nn.Linear(d, 3 + 10 + 24 * 6)

    def forward(self, image):
        """image (B, H, W, 3) -> para (B, 229), pred_cam, pred_shape,
        pred_rotmat (B, 24, 3, 3)."""
        x = self.patch(image.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2) + self.pos
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        # a copy, not a view: FlopCounterMode's module tracker refuses a
        # module input that is a view of a parameter made under no_grad
        q = self.query.repeat(x.shape[0], 1, 1)
        q = q + self.cross(q, x, x, need_weights=True)[0]
        out = self.head(q[:, 0])
        cam, shape = out[:, :3], out[:, 3:13]
        rotmat = rot6d_to_rotmat(out[:, 13:].reshape(-1, 24, 6) + out.new_tensor(IDENTITY_6D))
        para = torch.cat([cam, shape, rotmat.flatten(1)], dim=1)
        return {"para": para, "pred_cam": cam, "pred_shape": shape, "pred_rotmat": rotmat}


def leaves(model: nn.Module) -> list:
    out = []
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            out += [(m.weight, "u", 0.5, 0.5), (m.bias, "n", 0.01, 0.0)]
        elif isinstance(m, nn.MultiheadAttention):
            out += [(m.in_proj_weight, "n", m.embed_dim ** -0.5, 0.0), (m.in_proj_bias, "n", 0.01, 0.0)]
    return out + [(model.pos, "n", 0.02, 0.0), (model.query, "n", 1.0, 0.0)]


def configs(config: dict, traffic: dict, overrides: dict | None = None) -> tuple:
    cfg = {**config["toy"], **(overrides or {})}
    return cfg, cfg


def image_hw(cfg: dict) -> tuple:
    return tuple(cfg["img_hw"])


def reference_model(cfg: dict, seed: int, device, served_dtype: torch.dtype = torch.float32):
    torch.manual_seed(derive_seed(seed, "module-init"))
    with torch.device(device):
        model = ToyTransformer(cfg)
    return round_to_(fill_weights_(model, seed, leaves(model), output_layers, left_to_construction), served_dtype)


def port_server(cfg: dict, ref_cfg: dict, seed: int, dtype: torch.dtype, device, smpl):
    from danet_densepose2smpl_tpu_torch.serve import Predictor
    from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel

    with torch.device(device):
        model = ToyTransformer(cfg)
    model.load_state_dict(reference_model(ref_cfg, seed, device).state_dict())
    return Predictor(device, dtype, model=model, smpl=SMPLModel(*smpl)).predict
