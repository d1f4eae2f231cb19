"""The other architectures through the port's entry points on the CPU,
against the JAX package: one whole f64 training step (GT preparation, GT
IUV raster, train-mode forward, every loss, gradients) of the ResNet-18
DaNet and of its 'lstm' refinement, as `tests/test_torch_train.py` holds
the HRNet one; and `cli.eval --regressor hmr` beside the JAX CLI on one
reference-layout HMR checkpoint and one synthetic dataset."""

import dataclasses
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.cli import eval as jax_eval
from danet_densepose2smpl_tpu.kernels.rasterizer import IUVRenderer as JIUVRenderer
from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet
from danet_densepose2smpl_tpu.smpl.densepose_atlas import synthetic_densepose_atlas as jax_atlas
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl
from danet_densepose2smpl_tpu.train.prepare import prepare_targets as jax_prepare_targets
from danet_densepose2smpl_tpu.train.step import make_loss_fn

from danet_densepose2smpl_tpu_torch import port
from danet_densepose2smpl_tpu_torch.cli import eval as cli_eval
from danet_densepose2smpl_tpu_torch.config import Config
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch, write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.nn.hmr import HMR
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

from test_torch_archs import ARCHS, QUIET, SIZE, x64_mode  # noqa: F401 (a fixture)
from test_torch_config import jax_cfg
from test_torch_nn import randomize

torch.set_num_threads(1)
BATCH = 4   # as tests/test_torch_train.py: at B=2 the 1x1 BatchNorms see two values


@pytest.mark.parametrize("arch", ["resnet", "lstm"])
def test_train_step_matches_jax_f64(arch, x64_mode):  # noqa: F811
    """JAX's prepare_targets -> make_loss_fn -> value_and_grad against the
    port's `make_train_step`, from the same flax variables, B=4, f64,
    PartDrop and jitter off, the synthetic soup atlas. Bars, as
    `tests/test_torch_train.py`: every loss term rtol 1e-9; every gradient
    within 1e-9 of its tensor's largest entry plus 1e-12. 'lstm' within
    1e-7: each joint's rot2pos MLP normalizes over the B=4 samples alone
    (the GCN's BatchNorms over B*24), and 16 such layers along a limb
    branch magnify rounding; measured 6e-8 at B=4 and 4e-9 at B=8, with
    the losses still within 1e-9. torch's two LSTM biases (`bias_ih`,
    `bias_hh`) each get the gradient of flax's one bias (to 1e-12: torch
    sums the two apart)."""
    cfg = Config(danet=dataclasses.replace(ARCHS[arch], **QUIET))
    variables = randomize(JDaNet(jax_cfg(cfg.danet), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=9)
    raw = synthetic_raw_batch(cfg, BATCH, seed=6, num_dp_points=32)
    raw["has_dp"] = np.array([0.0, 1.0, 0.0, 1.0], np.float32)   # DensePose samples: sparse losses live

    jsmpl = jax_synthetic_smpl()
    jbatch = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), raw)
    prep = jax_prepare_targets(jax_cfg(cfg), jsmpl, jbatch, renderer=JIUVRenderer(jax_atlas(jsmpl), 64, 16))
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    loss_fn = make_loss_fn(JDaNet(jax_cfg(cfg.danet), train=True), jsmpl, jax_cfg(cfg))
    keys = jax.random.split(jax.random.PRNGKey(0))
    (total, (jlosses, jstats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, v64["batch_stats"], prep, keys[0], keys[1]), has_aux=True))(v64["params"])

    model = DaNet(cfg.danet)
    model.load_state_dict(port.state_dict_from_flax(variables, cfg.danet), strict=True)
    model = model.double()
    state = create_train_state(model, cfg)
    step = make_train_step(model, synthetic_smpl_model(), cfg,
                           renderer=IUVRenderer(synthetic_densepose_atlas(synthetic_smpl_model()), 64, 16))
    state, metrics = step(state, batch_to_device(raw, "cpu", torch.float64))

    assert set(metrics) == set(jlosses) | {"loss_total"}
    if arch == "lstm":   # the initial rotations and the positions before and after the Bi-LSTMs
        assert {"joint_rotation0", "joint_position0", "joint_position1"} <= set(metrics)
    for k, v in jlosses.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-9, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(metrics["loss_total"].item(), float(total), rtol=1e-9)

    grads = port.convert({"params": jgrads, "batch_stats": jstats}, port.danet_rules(cfg.danet))
    named = dict(model.named_parameters())
    bar = 1e-7 if arch == "lstm" else 1e-9
    for name, p in named.items():
        if "bias_hh" in name:
            torch.testing.assert_close(p.grad, named[name.replace("bias_hh", "bias_ih")].grad,
                                       rtol=1e-12, atol=1e-15)
            continue
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=bar * np.abs(g).max() + 1e-12, err_msg=name)


@pytest.fixture(scope="module")
def hmr_files(tmp_path_factory):
    """A reference-layout HMR checkpoint (with the `init_*` mean-parameter
    buffers the reference stores) and an H36M-P2 dataset; removed after."""
    d = tmp_path_factory.mktemp("cli_hmr")
    model = random_init_(HMR(), seed=12)
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    sd |= {"module.init_pose": torch.zeros(1, 144), "module.init_shape": torch.zeros(1, 10),
           "module.init_cam": torch.zeros(1, 3)}
    torch.save({"model": sd}, d / "hmr.pt")
    npz, img_dir = write_synthetic_dataset(str(d / "pose"), n=4, seed=1)
    yield {"pt": str(d / "hmr.pt"), "npz": npz, "img_dir": img_dir, "dir": d}
    shutil.rmtree(d, ignore_errors=True)


def test_cli_eval_hmr_matches_jax(hmr_files, capsys):
    """`cli.eval --regressor hmr --dataset h36m-p2` (224 px crops, B=2)
    beside the JAX CLI on the same file and dataset: the per-sample MPJPE
    and PA-MPJPE (--result_file) within 5e-4 mm and the summary lines within
    0.5 mm, as `tests/test_torch_cli_eval.py` holds DaNet's. Both run HMR in
    fp32 whatever --bf16 says: the port's --bf16 run gives the same
    numbers."""
    f = hmr_files
    argv = ["--cpu", "--regressor", "hmr", "--torch_checkpoint", f["pt"], "--num_verts", "500",
            "--batch_size", "2", "--npz", f["npz"], "--img_dir", f["img_dir"], "--dataset", "h36m-p2"]
    theirs, ours, ours16 = (str(f["dir"] / n) for n in ("jax.npz", "port.npz", "port_bf16.npz"))
    jax_eval.main(argv + ["--result_file", theirs])
    jout = capsys.readouterr().out
    res = cli_eval.main(argv + ["--result_file", ours])["pose"]
    out = capsys.readouterr().out
    cli_eval.main(argv + ["--result_file", ours16, "--bf16"])
    a, b, c = np.load(ours), np.load(theirs), np.load(ours16)
    np.testing.assert_array_equal(a["mpjpe"], res.mpjpe)
    for k in ("mpjpe", "pa_mpjpe"):
        assert a[k].shape == (4,) and np.isfinite(a[k]).all()
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-4, err_msg=k)
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    for line in ("MPJPE", "PA-MPJPE (rec. err)"):
        ours_mm = float(re.search(rf"^{re.escape(line)}: ([0-9.]+) mm$", out, re.M).group(1))
        theirs_mm = float(re.search(rf"^{re.escape(line)}: ([0-9.]+) mm$", jout, re.M).group(1))
        assert abs(ours_mm - theirs_mm) <= 0.5, (line, ours_mm, theirs_mm)
