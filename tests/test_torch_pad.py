"""The padded HRNet (`hrnet_pad_channels`: the 48/96-channel branches
widened to 64/128) against the JAX package: the stage spec equal to
JAX's; the padded DaNet's eval forward at 64 px (heatmap 16), B=2, f64,
from the same randomized flax variables (through `state_dict_from_flax`:
the W48 names, padded shapes) against JAX's padded DaNet, at the serving
slice's bars (tests/test_torch_slice.py); and the port's W48 weights
zero-padded into the padded model give the W48 model's outputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet
from danet_densepose2smpl_tpu.nn.hrnet import HRNET_W48_STAGES_PADDED as JAX_PADDED

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.nn.hrnet import HRNET_W48_STAGES_PADDED
from danet_densepose2smpl_tpu_torch.port import state_dict_from_flax
from danet_densepose2smpl_tpu_torch.serve import random_init_

from test_torch_config import jax_cfg
from test_torch_nn import randomize

torch.set_num_threads(1)
SIZE, BATCH = 64, 2
CFG = DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4)
PAD = DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, hrnet_pad_channels=True)
MAPS = ("u", "v", "index", "ann", "heatmaps", "stn_scale", "part_iuv")


def test_padded_stages_equal_jax():
    assert HRNET_W48_STAGES_PADDED == JAX_PADDED


def test_padded_danet_matches_jax_f64():
    """para atol 1e-6, rtol 1e-9; the estimator's maps and part stacks at
    the same bars; K1's width is 64."""
    variables = randomize(JDaNet(jax_cfg(PAD), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=5)
    x = np.random.RandomState(12).rand(BATCH, SIZE, SIZE, 3)
    jax.config.update("jax_enable_x64", True)
    try:
        jvars = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jout = jax.jit(JDaNet(jax_cfg(PAD), train=False).apply)(jvars, jnp.asarray(x))
        jout = jax.tree.map(np.asarray, jout)
    finally:
        jax.config.update("jax_enable_x64", False)

    model = DaNet(PAD)
    model.load_state_dict(state_dict_from_flax(variables, PAD), strict=True)
    model = model.double()
    assert model.img2iuv.iuv_est.out_channels == 64
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out["iuv_raw"]["feats"].shape == (BATCH, SIZE // 4, SIZE // 4, 64)
    np.testing.assert_allclose(out["para"].numpy(), jout["para"], atol=1e-6, rtol=1e-9)
    for k in MAPS:
        np.testing.assert_allclose(out["iuv_raw"][k].numpy(), jout["iuv_raw"][k], atol=1e-6, rtol=1e-9, err_msg=k)


def zero_padded(sd: dict, shapes: dict) -> dict:
    """Each tensor of `sd` in the leading corner of zeros of its shape in
    `shapes` (the padded channels come last in every axis)."""
    out = {}
    for k, t in sd.items():
        z = torch.zeros(shapes[k], dtype=t.dtype)
        z[tuple(slice(0, n) for n in t.shape)] = t
        out[k] = z
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_zero_padded_w48_weights_give_w48_outputs(train):
    """The W48 model's weights and BatchNorm statistics zero-padded into
    the padded topology: the extra channels stay 0, and para, the maps and
    the part stacks are the W48 model's within 1e-9 of each tensor's
    largest entry (the convs sum extra zeros in their own order). In train
    mode (PartDrop and jitter off) the batch statistics of a zero channel
    are 0 too."""
    quiet = dict(partdrop_rate=0.0, stn_center_jitter=0.0, stn_scale_jitter=0.0)
    w48 = random_init_(DaNet(DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, **quiet)), seed=3).double()
    padded = DaNet(DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, hrnet_pad_channels=True, **quiet)).double()
    shapes = {k: v.shape for k, v in padded.state_dict().items()}
    assert shapes != {k: v.shape for k, v in w48.state_dict().items()}
    padded.load_state_dict(zero_padded(w48.state_dict(), shapes), strict=True)
    x = torch.from_numpy(np.random.RandomState(13).rand(BATCH, SIZE, SIZE, 3))
    w48.train(train)
    padded.train(train)
    with torch.set_grad_enabled(train):
        want, got = w48(x), padded(x)
    assert torch.equal(got["iuv_raw"]["feats"][..., 48:], torch.zeros_like(got["iuv_raw"]["feats"][..., 48:]))
    pairs = [("feats", got["iuv_raw"]["feats"][..., :48], want["iuv_raw"]["feats"]), ("para", got["para"], want["para"])]
    errs = {k: ((g - w).abs().max() / w.abs().max()).item()
            for k, g, w in pairs + [(k, got["iuv_raw"][k], want["iuv_raw"][k]) for k in MAPS]}
    # para in train mode: the regressor's train-mode BatchNorms over B=2
    # magnify the maps' 1e-15 differences (observed 1.9e-9)
    assert max(errs.values()) <= 1e-9 or (train and errs.pop("para") <= 1e-7 and max(errs.values()) <= 1e-9), errs
