"""Seeded weights, made on the device in a few large calls.

The layout is the reference model's (`port_bench/reference`), which is
the checkpoint layout of the shipped model; the port loads the same state
dict through `load_state_dict`, as it loads a checkpoint. The draws follow
the distributions of the port's `serve.random_init_` (conv, linear and
graph-conv weights N(0, 1/fan_in), biases N(0, 0.01), BatchNorm scale and
running variance in [0.5, 1], shift and running mean N(0, 0.01)), so the
full backbone's activations stay in range and the outputs vary with the
image. The regressor's output layers (the body net's camera and shape
layer, the rotation and position heads) start near zero, as a fresh
HMR-style regressor does (weights at a hundredth of that scale, biases
0), so the first predictions are the mean parameters: without it a random
camera scale near 0 sends the reprojection loss to 1e13 and a bf16 step
to non-finite weights within two steps. One `randn` and one `rand` of the
total size, from a generator on the device seeded from the run's seed,
then a scale and a copy per leaf.
"""

from __future__ import annotations

import hashlib
import re

import torch
import torch.nn as nn

from port_bench.reference.nn.gcn import GraphConv


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use (`tags`) of the run's seed, so the streams
    of weights, images and noise never overlap."""
    text = ":".join(str(t) for t in (seed, *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


OUTPUT_LAYERS = re.compile(r"iuv2smpl\.smpl_para_Outs\.(body_net\.\d+\.final_layer|pose_regressors\.\d+\.1"
                           r"|coord_regressors\.\d+\.1)$")
OUTPUT_GAIN = 0.01


def _leaves(model: nn.Module):
    """(tensor, distribution, scale, shift) for every leaf that gets a draw:
    'n' normal, 'u' uniform in [0, 1)."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.ConvTranspose2d):   # weight (I, O, kh, kw), stride s: I kh kw / s^2
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel() // (m.stride[0] * m.stride[1])
            head = OUTPUT_LAYERS.match(name) is not None
            out.append((m.weight, "n", fan_in ** -0.5 * (OUTPUT_GAIN if head else 1.0), 0.0))
            if m.bias is not None:
                out.append((m.bias, "n", 0.0 if head else 0.01, 0.0))
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                out.append((p, "n", p.shape[1] ** -0.5 if name.startswith("weight") else 0.01, 0.0))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            out += [(m.weight, "u", 0.5, 0.5), (m.bias, "n", 0.01, 0.0),
                    (m.running_mean, "n", 0.01, 0.0), (m.running_var, "u", 0.5, 0.5)]
        elif isinstance(m, GraphConv):
            out += [(m.weight, "n", m.weight.shape[0] ** -0.5, 0.0), (m.bias, "n", 0.01, 0.0)]
    return out


@torch.no_grad()
def fill_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Draw `model`'s weights from `seed` on its device."""
    leaves = _leaves(model)
    device = leaves[0][0].device
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights"))
    sizes = {kind: sum(t.numel() for t, k, _, _ in leaves if k == kind) for kind in ("n", "u")}
    draws = {"n": torch.randn(sizes["n"], generator=gen, device=device),
             "u": torch.rand(sizes["u"], generator=gen, device=device)}
    at = {"n": 0, "u": 0}
    for t, kind, scale, shift in leaves:
        n = t.numel()
        t.copy_((draws[kind][at[kind]:at[kind] + n] * scale + shift).view_as(t))
        at[kind] += n
    return model


@torch.no_grad()
def round_to_(model: nn.Module, served_dtype: torch.dtype) -> nn.Module:
    """With a `served_dtype` below fp32 every floating leaf rounded to it
    and kept in fp32, so the reference holds exactly the values the port
    serves: all but the constant tables a module names in `CONSTANTS`
    (the regressor's mean parameters and adjacencies), which the port
    keeps in fp32 when it casts the model."""
    if served_dtype != torch.float32:
        kept = {id(m._buffers[name]) for m in model.modules() for name in getattr(m, "CONSTANTS", ())}
        for t in [*model.parameters(), *model.buffers()]:
            if t.is_floating_point() and id(t) not in kept:
                t.copy_(t.to(served_dtype).to(t.dtype))
    return model


def reference_model(cfg, seed: int, device, served_dtype: torch.dtype = torch.float32) -> nn.Module:
    """The reference DaNet of `cfg` on `device` with the seed's weights,
    rounded to `served_dtype` (`round_to_`)."""
    from port_bench.reference.models.danet import DaNet

    torch.manual_seed(derive_seed(seed, "module-init"))   # leaves without a draw (constants) alike each time
    with torch.device(device):
        model = DaNet(cfg.danet)
    return round_to_(fill_weights_(model, seed), served_dtype)
