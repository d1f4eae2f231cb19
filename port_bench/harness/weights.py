"""Seeded weights, made on the device in a few large calls.

The layout is the reference model's (`port_bench/reference`), which is
the checkpoint layout of the shipped model; the port loads the same state
dict through `load_state_dict`, as it loads a checkpoint. The generic
draws follow the distributions of the port's `serve.random_init_` (conv,
linear and graph-conv weights N(0, 1/fan_in), biases N(0, 0.01),
BatchNorm scale and running variance in [0.5, 1], shift and running mean
N(0, 0.01)), so the full backbone's activations stay in range and the
outputs vary with the image; a model family appends its own draws for
what these rules do not cover (`families/<family>.py::leaves`). The
family's output layers (`output_layers`: for DaNet the body net's camera
and shape layer, the rotation and position heads) start near zero, as a
fresh HMR-style regressor does (weights at a hundredth of that scale,
biases 0), so the first predictions are the mean parameters: without it
a random camera scale near 0 sends the reprojection loss to 1e13 and a
bf16 step to non-finite weights within two steps. One `randn` and one
`rand` of the total size, from a generator on the device seeded from the
run's seed, then a scale and a copy per leaf. A floating parameter or
buffer that gets no draw is a constant a module names in `CONSTANTS` or
one the family leaves to the constructor (`left_to_construction`); any
other raises, so a new model never runs on torch's default
initialisation unnoticed.
"""

from __future__ import annotations

import hashlib
from collections import Counter

import torch
import torch.nn as nn

from port_bench.reference.nn.gcn import GraphConv


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use (`tags`) of the run's seed, so the streams
    of weights, images and noise never overlap."""
    text = ":".join(str(t) for t in (seed, *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


OUTPUT_GAIN = 0.01


def _leaves(model: nn.Module, output_layers):
    """(tensor, distribution, scale, shift) for every leaf that the generic
    rules draw: 'n' normal, 'u' uniform in [0, 1); the modules whose names
    `output_layers` matches at a hundredth of the scale, biases 0."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.ConvTranspose2d):   # weight (I, O, kh, kw), stride s: I kh kw / s^2
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel() // (m.stride[0] * m.stride[1])
            head = output_layers.match(name) is not None
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


def _constants(model: nn.Module) -> set:
    """The ids of the constant tables that modules name in `CONSTANTS`."""
    return {id(m._buffers[name]) for m in model.modules() for name in getattr(m, "CONSTANTS", ())}


def _check_drawn(model: nn.Module, leaves: list, left_to_construction) -> None:
    """Raise where a tensor is drawn twice, or a floating parameter or
    buffer gets no draw and is neither a constant nor left to the
    constructor; the error names the tensors."""
    tensors = [*model.named_parameters(), *model.named_buffers()]
    names = {id(t): name for name, t in reversed(tensors)}
    drawn = Counter(id(t) for t, _, _, _ in leaves)
    twice = sorted(names.get(i, "?") for i, n in drawn.items() if n > 1)
    if twice:
        raise ValueError(f"drawn twice: {twice}")
    covered = set(drawn) | _constants(model)
    missing = [name for name, t in tensors
               if t.is_floating_point() and id(t) not in covered and name not in left_to_construction]
    if missing:
        raise ValueError(f"no draw for {missing}: draw them in the family's `leaves`, or name them in its "
                         f"`left_to_construction` or in a module's `CONSTANTS`")


@torch.no_grad()
def fill_weights_(model: nn.Module, seed: int, extra, output_layers, left_to_construction) -> nn.Module:
    """Draw `model`'s weights from `seed` on its device: the generic rules'
    leaves (`output_layers` near zero), then the family's `extra` ones."""
    leaves = _leaves(model, output_layers) + list(extra)
    _check_drawn(model, leaves, left_to_construction)
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
        kept = _constants(model)
        for t in [*model.parameters(), *model.buffers()]:
            if t.is_floating_point() and id(t) not in kept:
                t.copy_(t.to(served_dtype).to(t.dtype))
    return model
