"""The chunked crop + partial head in training (`part_head_chunks` N > 1,
the option of `configs/danet_tpu_b128.yaml`): the port's train forward
against JAX's chunked train forward, and the port's chunked step against
its one-shot step, f64 on the CPU.

No JAX backward is compiled here. The chain that holds the chunked
gradients to JAX's: JAX's own `tests/test_danet_model.py::
test_part_head_chunks_training_grads_identical` holds its chunked gradients
to its one-shot ones; `tests/test_torch_train.py::
test_train_step_matches_jax_f64` holds the port's one-shot step to JAX's;
`test_chunked_step_equals_one_shot` below holds the port's chunked step to
its one-shot step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet

from danet_densepose2smpl_tpu_torch import port
from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig, SolverConfig
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

from test_torch_config import jax_cfg
from test_torch_nn import randomize

torch.set_num_threads(1)
SIZE, BATCH = 64, 4


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_chunked_train_forward_matches_jax(x64_mode, monkeypatch):
    """The train-mode forward with `part_head_chunks=3` at full HRNet-W48
    width, 64 px, B=4, f64, with the default PartDrop (0.3) and STN jitter
    (centre 0.1, scale 0.2): JAX's uniforms, recorded from
    `jax.random.uniform` inside its jitted forward, injected into the port.
    `part_iuv` (the chunks concatenated), its cleaned stacks, `para` and
    the updated BatchNorm statistics at f64 noise (rtol/atol 1e-9;
    statistics rtol 1e-9, atol 1e-10)."""
    cfg = DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, part_head_chunks=3)
    variables = randomize(JDaNet(jax_cfg(cfg), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=9)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    x = np.random.RandomState(12).rand(BATCH, SIZE, SIZE, 3)
    drawn, uniform = [], jax.random.uniform

    def recording_uniform(*args, **kwargs):
        drawn.append(uniform(*args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(jax.random, "uniform", recording_uniform)
    jmodel = JDaNet(jax_cfg(cfg), train=True)

    def forward(v, img, key):
        drawn.clear()
        out, upd = jmodel.apply(v, img, mutable=["batch_stats"],
                                rngs={"jitter": key, "partdrop": jax.random.fold_in(key, 1)})
        return out, upd["batch_stats"], list(drawn)

    jout, jstats, u = jax.jit(forward)(v64, jnp.asarray(x), jax.random.PRNGKey(2))
    assert [a.shape for a in u] == [(BATCH, 24, 2), (BATCH, 24), (BATCH, 24), (BATCH, 24)]
    noise = {"center": torch.from_numpy(np.array(u[0])),
             "scale": torch.from_numpy(np.stack([np.array(u[1]), np.array(u[2])])),
             "partdrop": torch.from_numpy(np.array(u[3]))}

    model = DaNet(cfg)
    model.load_state_dict(port.state_dict_from_flax(variables, cfg), strict=True)
    model = model.double().train()
    out = model(torch.from_numpy(x), noise=noise)
    assert out["iuv_raw"]["part_iuv"].shape == (BATCH, 24, SIZE // 4, SIZE // 4, 3, 7)
    for ours, theirs in ((out["iuv_raw"]["part_iuv"], jout["iuv_raw"]["part_iuv"]),
                         (out["part_iuv_clean"], jout["part_iuv_clean"]), (out["para"], jout["para"])):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=1e-9, atol=1e-9)
    stats = port.convert({"params": v64["params"], "batch_stats": jstats}, port.danet_rules(cfg))
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-9, atol=1e-10, err_msg=name)


def tiny_cfg(chunks: int) -> Config:
    """The `configs/danet_tiny_test.yaml` model (ResNet-18) at 64 px with
    `part_head_chunks=chunks`. The comparisons read the losses and the
    gradients, which the optimizer does not touch, so it steps with SGD
    (Adam's moments of the 50M f64 parameters cost 0.8 GB and seconds)."""
    return Config(danet=DaNetConfig(iuv_regressor="resnet", msres_num_layers=18, img_size=SIZE,
                                    heatmap_size=SIZE // 4, part_head_chunks=chunks),
                  solver=SolverConfig(optimizer="sgd"))


@pytest.fixture(scope="module")
def tiny_inputs():
    """The step's batch, SMPL model, renderer and seeded random f64 weights,
    made once for every chunk count."""
    cfg = tiny_cfg(1)
    raw = synthetic_raw_batch(cfg, BATCH, seed=6, num_dp_points=32)
    raw["has_dp"] = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    smpl = synthetic_smpl_model(500)
    weights = random_init_(DaNet(cfg.danet), seed=0).double().state_dict()
    return raw, smpl, IUVRenderer(synthetic_densepose_atlas(smpl), SIZE, SIZE // 4), weights


def tiny_step(chunks: int, inputs) -> tuple[dict, dict]:
    """One f64 step of `tiny_cfg(chunks)` at B=4 on `tiny_inputs` (its
    weights; default PartDrop and jitter from one seeded generator):
    (metrics, gradients)."""
    cfg = tiny_cfg(chunks)
    raw, smpl, renderer, weights = inputs
    model = DaNet(cfg.danet).double()
    model.load_state_dict(weights, strict=True)
    state = create_train_state(model, cfg)
    step = make_train_step(model, smpl, cfg, renderer=renderer)
    _, metrics = step(state, batch_to_device(raw, "cpu", torch.float64), torch.Generator().manual_seed(5))
    return {k: v.item() for k, v in metrics.items()}, {k: p.grad for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def one_shot(tiny_inputs):
    return tiny_step(1, tiny_inputs)


@pytest.mark.parametrize("chunks", [2, 3, 4])
def test_chunked_step_equals_one_shot(chunks, one_shot, tiny_inputs):
    """The chunked f64 step against the one-shot step from the same weights,
    batch and noise: every loss term rtol 1e-9, every gradient within 1e-9
    of its tensor's largest entry (+1e-12: the heatmap head's bias has a
    gradient of exactly 0 in exact arithmetic). Only the summation order of
    the features' gradient differs (the crops' backward arrives chunk by
    chunk)."""
    metrics, grads = tiny_step(chunks, tiny_inputs)
    ref_metrics, ref_grads = one_shot
    assert metrics.keys() == ref_metrics.keys() and ref_metrics["loss_pU"] > 0
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-9, atol=1e-12, err_msg=k)
    assert grads.keys() == ref_grads.keys()
    head = "img2iuv.iuv_est.final_pred.predict_partial_iuv.weight"
    assert float(ref_grads[head].abs().max()) > 0
    for k, g in ref_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0, atol=1e-9 * float(g.abs().max()) + 1e-12,
                                   err_msg=k)


def test_chunked_head_is_the_one_shot_head():
    """`PartialIUVHead` on a chunk of parts (its slice of the weights and
    bias, JAX's `part_slice`) equals the one-shot head's parts, f64."""
    head = DaNet(DaNetConfig(iuv_regressor="resnet", msres_num_layers=18)).img2iuv.iuv_est.final_pred \
        .predict_partial_iuv.double()
    crops = torch.from_numpy(np.random.RandomState(0).randn(2, head.in_channels, 8, 8))
    whole = head(crops)
    c = head.in_channels // 24
    for start, count in ((0, 8), (8, 8), (16, 8), (6, 6)):
        part = head(crops[:, start * c:(start + count) * c], start=start, count=count)
        np.testing.assert_allclose(part.detach().numpy(), whole[:, start:start + count].detach().numpy(),
                                   rtol=1e-12, atol=1e-12)
