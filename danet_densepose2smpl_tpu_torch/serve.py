"""Serving: one request = one batch of images -> SMPL parameters and mesh.

`Predictor` is the counterpart of the JAX package's serving forward
(`bench.py::bench_inference.forward`, and `cli/demo.py` without the
rendering): DaNet eval, then SMPL LBS on the predicted shape and rotations.
The model lives on one explicit device in float32 or bfloat16; bf16 serving
casts parameters, BatchNorm statistics and activations to bf16 and keeps
the regressor's constant tables and SMPL in fp32. As in the JAX package's
bf16 path, the regressor's graph stages then promote to fp32, so `para`
comes out fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.nn.gcn import GraphConv
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel, synthetic_smpl_model, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward

SERVING_DTYPES = (torch.float32, torch.bfloat16)


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights and BatchNorm statistics for every layer.

    Conv, Linear and GraphConv weights are N(0, 1/fan_in) (activations of
    the full backbone stay in the hundreds, and the outputs vary with the
    image); biases N(0, 0.01); BN
    scale in [0.5, 1], shift N(0, 0.01), running mean N(0, 0.01), running
    variance in [0.5, 1]. Draws come from one `torch.Generator` on the CPU,
    in module order, so a seed gives the same weights on every device.
    """
    g = torch.Generator().manual_seed(seed)

    def fill(t, values):
        t.copy_(values.to(t.dtype))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            fill(m.weight, torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5)
            if m.bias is not None:
                fill(m.bias, torch.randn(m.bias.shape, generator=g) * 0.01)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            n = m.num_features
            fill(m.weight, 0.5 + 0.5 * torch.rand(n, generator=g))
            fill(m.bias, torch.randn(n, generator=g) * 0.01)
            fill(m.running_mean, torch.randn(n, generator=g) * 0.01)
            fill(m.running_var, 0.5 + 0.5 * torch.rand(n, generator=g))
        elif isinstance(m, GraphConv):
            fill(m.weight, torch.randn(m.weight.shape, generator=g) / m.weight.shape[0] ** 0.5)
            fill(m.bias, torch.randn(m.bias.shape, generator=g) * 0.01)
    return model


class Predictor:
    """DaNet + SMPL on one device.

    device: where the model and SMPL arrays live (required: no silent
    default); dtype: torch.float32 or torch.bfloat16; state_dict: weights to
    load (e.g. from `port.state_dict_from_flax`), else seeded random
    weights from `seed`.
    """

    def __init__(self, device, dtype: torch.dtype = torch.float32, cfg: DaNetConfig | None = None,
                 state_dict: dict | None = None, seed: int = 0, smpl: SMPLModel | None = None):
        if dtype not in SERVING_DTYPES:
            raise ValueError(f"serving dtype must be one of {SERVING_DTYPES}, got {dtype}")
        self.device = torch.device(device)
        self.dtype = dtype
        model = DaNet(cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            random_init_(model, seed)
        self.model = model.to(device=self.device, dtype=dtype, memory_format=torch.channels_last)
        self.smpl = to_torch(smpl if smpl is not None else synthetic_smpl_model(), self.device)

    @torch.inference_mode()
    def predict(self, images_nhwc) -> dict:
        """images_nhwc: (B, H, W, 3) normalized RGB (numpy or tensor).

        Returns para (B, 229), pred_cam (B, 3), pred_shape (B, 10),
        pred_rotmat (B, 24, 3, 3), vertices (B, V, 3) and joints (B, 49, 3),
        all fp32 (the regressor promotes to fp32 from its first graph
        stage, as JAX's bf16 path does)."""
        if isinstance(images_nhwc, np.ndarray):
            images_nhwc = torch.from_numpy(images_nhwc)
        x = images_nhwc.to(device=self.device, dtype=self.dtype)
        with record_function("serve.model"):
            out = self.model(x)
        with record_function("serve.smpl"):
            body = smpl_forward(self.smpl, out["pred_shape"].float(), out["pred_rotmat"].float())
        return {
            "para": out["para"],
            "pred_cam": out["pred_cam"],
            "pred_shape": out["pred_shape"],
            "pred_rotmat": out["pred_rotmat"],
            "vertices": body.vertices,
            "joints": body.joints,
        }
