"""Serving: one request = one batch of images -> SMPL parameters and mesh.

`Predictor` is the counterpart of the JAX package's serving forward
(`bench.py::bench_inference.forward`, and `cli/demo.py` without the
rendering): DaNet eval, then SMPL LBS on the predicted shape and rotations.
The model lives on one explicit device in float32 or bfloat16; bf16 serving
casts parameters, BatchNorm statistics and activations to bf16 and keeps
the regressor's constant tables and SMPL in fp32. As in the JAX package's
bf16 path, the regressor's graph stages then promote to fp32, so `para`
comes out fp32. fp32 serving runs without TF32 whatever the caller set:
under PyTorch's default (cuDNN convolutions in TF32) `para` came 0.088 off
the f64 result on an H100, outside the weight bridge's fp32 bar (atol 0.05,
rtol 1e-3); without TF32, 0.006 (`chip_smoke.py` phase 2).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn as nn

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.models.danet import GT_MODES, DaNet
from danet_densepose2smpl_tpu_torch.nn.gcn import GraphConv
from danet_densepose2smpl_tpu_torch.ops.procrustes import full_fp32
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel, synthetic_smpl_model, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate

SERVING_DTYPES = (torch.float32, torch.bfloat16)


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights and BatchNorm statistics for every layer.

    Conv, Linear, GraphConv and LSTM weights are N(0, 1/fan_in) (a
    transposed conv's fan-in counts the inputs one output sees; activations
    of the full backbone stay in the hundreds, and the outputs vary with
    the image); biases N(0, 0.01); BN
    scale in [0.5, 1], shift N(0, 0.01), running mean N(0, 0.01), running
    variance in [0.5, 1]. Draws come from one `torch.Generator` on the CPU,
    in module order, so a seed gives the same weights on every device.
    """
    g = torch.Generator().manual_seed(seed)

    def fill(t, values):
        t.copy_(values.to(t.dtype))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.ConvTranspose2d):   # weight (I, O, kh, kw), stride s: I kh kw / s^2
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel() // (m.stride[0] * m.stride[1])
            fill(m.weight, torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5)
            if m.bias is not None:
                fill(m.bias, torch.randn(m.bias.shape, generator=g) * 0.01)
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                scale = p.shape[1] ** -0.5 if name.startswith("weight") else 0.01
                fill(p, torch.randn(p.shape, generator=g) * scale)
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


def refuse_gt_modes(cfg: DaNetConfig, entry: str) -> None:
    """Raise for the input modes whose forward takes the GT IUV render:
    serving has none (the JAX package's eval and demo call the model
    without it and fail on an AssertionError)."""
    if cfg.input_mode in GT_MODES:
        raise ValueError(f"{entry} serves without ground truth, and input_mode='{cfg.input_mode}' takes the GT "
                         "IUV render in the forward: it trains (cli.train) but does not serve")


class Predictor:
    """DaNet + SMPL on one device.

    device: where the model and SMPL arrays live (required: no silent
    default); dtype: torch.float32 or torch.bfloat16; model: a built DaNet
    to serve (the eval CLIs pass the one `cli/common.build_model_and_params`
    loaded; it is moved and cast in place), else one built from `cfg` with
    `state_dict`'s weights (e.g. from `port.state_dict_from_flax`), else
    seeded random weights from `seed`. The GT input modes ('iuv_gt',
    'iuv_gt_feat') raise (`refuse_gt_modes`).
    """

    def __init__(self, device, dtype: torch.dtype = torch.float32, cfg: DaNetConfig | None = None,
                 state_dict: dict | None = None, seed: int = 0, smpl: SMPLModel | None = None,
                 model: nn.Module | None = None):
        if dtype not in SERVING_DTYPES:
            raise ValueError(f"serving dtype must be one of {SERVING_DTYPES}, got {dtype}")
        self.device = torch.device(device)
        self.dtype = dtype
        model_cfg = getattr(model, "cfg", None) if model is not None else cfg or DaNetConfig()
        if model_cfg is not None:   # HMR has no input mode
            refuse_gt_modes(model_cfg, "Predictor")
        if model is None:
            model = DaNet(cfg)
            if state_dict is not None:
                model.load_state_dict(state_dict)
            else:
                random_init_(model, seed)
        self.model = model.eval().to(device=self.device, dtype=dtype, memory_format=torch.channels_last)
        self.smpl = to_torch(smpl if smpl is not None else synthetic_smpl_model(), self.device)

    @torch.inference_mode()
    def run_model(self, images_nhwc) -> dict:
        """The DaNet outputs of (B, H, W, 3) normalized RGB (numpy or
        tensor): para (fp32) and the estimator's maps under iuv_raw (in the
        serving dtype; `iuv_raw['index']` holds the (B, S, S, 25) part-index
        logits), without SMPL."""
        if isinstance(images_nhwc, np.ndarray):
            images_nhwc = torch.from_numpy(images_nhwc)
        x = images_nhwc.to(device=self.device, dtype=self.dtype)
        fp32 = full_fp32() if self.dtype == torch.float32 else contextlib.nullcontext()
        with annotate("serve.model"), fp32:
            return self.model(x)

    @torch.inference_mode()
    def predict(self, images_nhwc) -> dict:
        """images_nhwc: (B, H, W, 3) normalized RGB (numpy or tensor).

        Returns para (B, 229), pred_cam (B, 3), pred_shape (B, 10),
        pred_rotmat (B, 24, 3, 3), vertices (B, V, 3) and joints (B, 49, 3),
        all fp32 (the regressor promotes to fp32 from its first graph
        stage, as JAX's bf16 path does)."""
        with annotate("serve.request"):
            out = self.run_model(images_nhwc)
            with annotate("serve.smpl"):
                body = smpl_forward(self.smpl, out["pred_shape"].float(), out["pred_rotmat"].float())
        return {
            "para": out["para"],
            "pred_cam": out["pred_cam"],
            "pred_shape": out["pred_shape"],
            "pred_rotmat": out["pred_rotmat"],
            "vertices": body.vertices,
            "joints": body.joints,
        }
