"""The port's serving slice as a whole against the JAX package: full-width
HRNet-W48 DaNet + SMPL at 64 px (heatmap 16), B=2, in float64, loaded from
the same randomized flax variables; the weight bridge round trip through the
JAX package's `port.apply_rules`; import and dispatch guards."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet
from danet_densepose2smpl_tpu.port import apply_rules
from danet_densepose2smpl_tpu.port.danet_map import danet_rules as jax_danet_rules
from danet_densepose2smpl_tpu.port.convert import _flatten
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu.smpl.model import smpl_forward as jax_smpl_forward

from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import fused_part_predict
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.port import state_dict_from_flax
from danet_densepose2smpl_tpu_torch.serve import Predictor
from danet_densepose2smpl_tpu_torch.smpl.loader import to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward

from test_torch_config import jax_cfg
from test_torch_nn import randomize

torch.set_num_threads(1)
SIZE, BATCH = 64, 2
CFG = DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def flax_variables():
    """Randomized (f32) variables of the full-width JAX DaNet at 64 px."""
    return randomize(JDaNet(jax_cfg(CFG), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=7)


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _port_model(variables):
    model = DaNet(CFG)
    model.load_state_dict(state_dict_from_flax(variables, CFG), strict=True)
    return model


def test_slice_matches_jax_f64(flax_variables, x64_mode):
    """para and the SMPL vertices at the bar of tests/test_port_e2e.py."""
    x = np.random.RandomState(11).rand(BATCH, SIZE, SIZE, 3)
    smpl = synthetic_smpl_model()

    jmodel = JDaNet(jax_cfg(CFG), train=False)
    jvars = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), flax_variables)
    jout = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
    jsmpl = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                         if np.issubdtype(np.asarray(a).dtype, np.floating) else a, smpl)
    jverts = jax_smpl_forward(jsmpl, jout["pred_shape"], jout["pred_rotmat"]).vertices

    model = _port_model(flax_variables).double()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    verts = smpl_forward(to_torch(smpl, "cpu", torch.float64), out["pred_shape"], out["pred_rotmat"]).vertices

    assert out["para"].shape == (BATCH, 229) and verts.shape == (BATCH, 6890, 3)
    np.testing.assert_allclose(out["para"].numpy(), np.asarray(jout["para"]), atol=1e-6, rtol=1e-9)
    np.testing.assert_allclose(verts.numpy(), np.asarray(jverts), atol=1e-6, rtol=1e-9)
    # the STN decisions that feed the crops agree too
    np.testing.assert_allclose(out["iuv_raw"]["stn_scale"].numpy(),
                               np.asarray(jout["iuv_raw"]["stn_scale"]), atol=1e-9)


def test_weight_bridge_round_trip(flax_variables):
    """The port's state_dict goes through the JAX package's checkpoint map
    (`danet_rules`, reference checkpoint names) back to the flax variables
    it came from, exactly: every name and layout of the port is the
    reference checkpoint's."""
    sd = {k: v.numpy() for k, v in _port_model(flax_variables).state_dict().items()}
    back, report = apply_rules(sd, flax_variables, jax_danet_rules(jax_cfg(CFG)), strict=True)
    assert report["unconsumed_torch_keys"] == []
    assert report["unfilled_params"] == []
    for col in ("params", "batch_stats"):
        ours, theirs = _flatten(back[col]), _flatten(flax_variables[col])
        assert ours.keys() == theirs.keys()
        for path in theirs:
            np.testing.assert_array_equal(ours[path], theirs[path], err_msg="/".join(path))


def test_predictor_on_cpu_never_launches_the_kernel(flax_variables):
    """Serving on the CPU with converted weights: one request, the plain
    crop + head, outputs of the serving contract, no kernel launch."""
    predictor = Predictor("cpu", torch.float32, cfg=CFG,
                          state_dict=state_dict_from_flax(flax_variables, CFG))
    out = predictor.predict(np.random.RandomState(0).rand(3, SIZE, SIZE, 3).astype(np.float32))
    shapes = {"para": (3, 229), "pred_cam": (3, 3), "pred_shape": (3, 10),
              "pred_rotmat": (3, 24, 3, 3), "vertices": (3, 6890, 3), "joints": (3, 49, 3)}
    assert {k: tuple(v.shape) for k, v in out.items()} == shapes
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert fused_part_predict.launches == 0


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DaNet(DaNetConfig(hrnet_pad_channels=True))
    # the other backbone and regressors are ported (tests/test_torch_archs.py)
    for kw in ({"iuv_regressor": "resnet"}, {"refine_strategy": "lstm"}, {"decomposed": False}):
        DaNet(DaNetConfig(**kw))
    # train mode is ported; its memory options are not
    for kw in ({"part_head_chunks": 4}, {"remat_backbone": True}):
        with pytest.raises(NotImplementedError, match="train mode"):
            DaNet(DaNetConfig(**kw)).train()
    assert DaNet(DaNetConfig()).train().training


def test_port_imports_no_jax(tmp_path):
    """Importing every module of the port (serve, train, data, eval, the
    kernels, the training entry point with its ingest, loaders, trainer
    and checkpoints, the eval entry points, the COCO harness, the ingest
    on the card, the demo, the training visualization and the offline
    preprocessing included) from a directory that holds the port alone
    works, and leaves jax, flax, optax, the JAX package, cv2 and
    matplotlib out of sys.modules."""
    (tmp_path / "danet_densepose2smpl_tpu_torch").symlink_to(REPO / "danet_densepose2smpl_tpu_torch")
    code = (
        "import importlib, pkgutil, sys\n"
        "import danet_densepose2smpl_tpu_torch as p\n"
        "import danet_densepose2smpl_tpu_torch.serve\n"
        "import danet_densepose2smpl_tpu_torch.train.step, danet_densepose2smpl_tpu_torch.data.synthetic\n"
        "import danet_densepose2smpl_tpu_torch.kernels.rasterizer\n"
        "import danet_densepose2smpl_tpu_torch.cli.train, danet_densepose2smpl_tpu_torch.train.trainer\n"
        "import danet_densepose2smpl_tpu_torch.data.dataset, danet_densepose2smpl_tpu_torch.data.loader\n"
        "import danet_densepose2smpl_tpu_torch.core.checkpoint, danet_densepose2smpl_tpu_torch.data.image_io\n"
        "import danet_densepose2smpl_tpu_torch.cli.eval, danet_densepose2smpl_tpu_torch.cli.eval_coco\n"
        "import danet_densepose2smpl_tpu_torch.data.pipeline, danet_densepose2smpl_tpu_torch.eval.coco_harness\n"
        "import danet_densepose2smpl_tpu_torch.cli.demo, danet_densepose2smpl_tpu_torch.cli.preprocess\n"
        "import danet_densepose2smpl_tpu_torch.utils.vis, danet_densepose2smpl_tpu_torch.data.preprocess\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'danet_densepose2smpl_tpu',\n"
        "                                    'cv2', 'matplotlib'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
