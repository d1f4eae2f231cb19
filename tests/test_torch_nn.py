"""PyTorch port vs the JAX package: the serving path's nn blocks, each built
in flax with randomized variables (random BN statistics too), converted
through the port's `state_dict_from_flax` rules and loaded strictly.

fp32 on both sides; activations are O(1), so the bar is fp32 noise of
deep conv stacks (atol/rtol 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.models.iuv_estimator import LEARNED_OFFSET, LEARNED_RATIO
from danet_densepose2smpl_tpu.models.smpl_regressor import (
    DecomposedPredictor as JDecomposedPredictor,
    default_mean_params,
)
from danet_densepose2smpl_tpu.nn.gcn import GCN as JGCN
from danet_densepose2smpl_tpu.nn.hrnet import PoseHighResolutionNet as JHRNet
from danet_densepose2smpl_tpu.nn.iuv_head import IUVPredictHead as JIUVPredictHead
from danet_densepose2smpl_tpu.nn.resnet import LimbResLayers as JLimbResLayers
from danet_densepose2smpl_tpu.nn.resnet import SmplResNet as JSmplResNet
from danet_densepose2smpl_tpu.ops.structure import rot2pos_adjacency
from danet_densepose2smpl_tpu.parallel.mesh import cast_float_tree

from danet_densepose2smpl_tpu_torch import port
from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.models.smpl_regressor import DecomposedPredictor
from danet_densepose2smpl_tpu_torch.nn.gcn import GCN
from danet_densepose2smpl_tpu_torch.nn.hrnet import PoseHighResolutionNet
from danet_densepose2smpl_tpu_torch.nn.iuv_head import IUVPredictHead
from danet_densepose2smpl_tpu_torch.nn.resnet import LimbResLayers, SmplResNet
from test_torch_config import jax_cfg

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
NARROW_STAGES = (
    (1, 2, (1, 1), (8, 16)),
    (1, 3, (1, 1, 1), (8, 16, 32)),
    (1, 4, (1, 1, 1, 1), (8, 16, 32, 64)),
)


def randomize(module, *args, seed=0, **kwargs):
    """Seeded numpy variables for a flax module, shaped by `eval_shape` of
    its init (no compile; `kwargs` go to the call as they are): weights
    N(0, 1/fan_in), biases and BN shifts/means N(0, 0.1^2), BN scales and
    variances and edge importances in [0.5, 1.5); the STN ratio/offset keep
    their shipped values."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda key, *a: module.init(key, *a, **kwargs), jax.random.PRNGKey(0), *args)
    shipped = {"stn_ratio": LEARNED_RATIO, "stn_offset": LEARNED_OFFSET}

    def leaf(path, x):
        name = path[-1].key
        shape = x.shape
        if name in ("scale", "var", "edge_importance"):
            v = rng.rand(*shape) + 0.5
        elif name in ("bias", "mean"):
            v = rng.randn(*shape) * 0.1
        elif name in shipped:
            v = shipped[name]
        else:  # conv / dense / partwise / graph kernels: (..., in, out)
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]) if len(shape) != 3 else shape[1])
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load(module, variables, rules):
    module.load_state_dict(port.convert(variables, rules), strict=True)
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def to_np(t):
    return t.detach().numpy()


def test_hrnet_narrow(rng):
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jmod = JHRNet(stages=NARROW_STAGES)
    variables = randomize(jmod, jnp.asarray(x))
    exp = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    ours = load(PoseHighResolutionNet(NARROW_STAGES), variables, port.hrnet_rules(NARROW_STAGES))
    with torch.no_grad():
        got = ours(nchw(x).contiguous(memory_format=torch.channels_last))
    assert got.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(np.moveaxis(to_np(got), 1, -1), exp, **TOL)


def test_iuv_predict_head(rng):
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    jmod = JIUVPredictHead()
    variables = randomize(jmod, jnp.asarray(x), seed=1)
    exp = jmod.apply(variables, jnp.asarray(x))
    ours = load(IUVPredictHead(16, decomposed=False), variables, port.iuv_head_rules("", ()))
    with torch.no_grad():
        got = ours(nchw(x))
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(exp[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("num_classes,truncate", [(13, 0), (0, 1)])
def test_smpl_resnet(rng, num_classes, truncate):
    x = rng.randn(2, 32, 32, 64).astype(np.float32)
    jmod = JSmplResNet(resnet_nums=18, num_classes=num_classes, truncate=truncate)
    variables = randomize(jmod, jnp.asarray(x), seed=2)
    ecls, efeat = jmod.apply(variables, jnp.asarray(x))
    ours = load(SmplResNet(18, num_classes=num_classes, truncate=truncate), variables,
                port.smpl_resnet_rules("", (), 18, num_classes, truncate))
    with torch.no_grad():
        cls, feat = ours(nchw(x))
    np.testing.assert_allclose(np.moveaxis(to_np(feat), 1, -1), np.asarray(efeat), **TOL)
    if num_classes:
        np.testing.assert_allclose(to_np(cls), np.asarray(ecls), **TOL)
    else:
        assert cls is None and ecls is None


def test_limb_res_layers(rng):
    x = rng.randn(2, 4, 4, 24 * 16).astype(np.float32)
    jmod = JLimbResLayers(resnet_nums=18, outplanes=8)
    variables = randomize(jmod, jnp.asarray(x), seed=3)
    exp = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    ours = load(LimbResLayers(18, inplanes=16, outplanes=8), variables,
                port.res_layer_rules("layer4", ("layer4",), False, 2, True))
    with torch.no_grad():
        got = ours(nchw(x))
    assert got.shape == exp.shape == (2, 24, 8)
    np.testing.assert_allclose(to_np(got), exp, **TOL)


def test_gcn(rng):
    x = rng.randn(3, 24, 12).astype(np.float32)
    adj = rot2pos_adjacency()
    jmod = JGCN(hidden_dim=16, out_dim=8, num_layers=3)
    variables = randomize(jmod, jnp.asarray(x), jnp.asarray(adj), seed=4)
    exp = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(adj)))
    ours = load(GCN(12, 16, 8, 3), variables, port.gcn_rules("", (), 3))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(adj))
    np.testing.assert_allclose(to_np(got), exp, **TOL)


def test_decomposed_predictor(rng):
    """'gcn' regressor on cleaned-looking inputs at 16 px."""
    cfg = DaNetConfig()
    mp = default_mean_params()
    s = 16
    iuv = rng.rand(2, s, s, 75).astype(np.float32)
    part = rng.rand(2, 24, s, s, 3, 7).astype(np.float32)
    jmod = JDecomposedPredictor(jax_cfg(cfg), mp)
    variables = randomize(jmod, jnp.asarray(iuv), jnp.asarray(part), seed=5)
    exp = np.asarray(jmod.apply(variables, jnp.asarray(iuv), jnp.asarray(part))["para"])
    ours = load(DecomposedPredictor(cfg, mp), variables, port.decomposed_rules(cfg))
    with torch.no_grad():
        got = ours(nchw(iuv), torch.from_numpy(part))["para"]
    assert got.shape == exp.shape == (2, 229)
    np.testing.assert_allclose(to_np(got), exp, **TOL)


def test_decomposed_predictor_bf16_matches_jax(rng):
    """bf16 serving: parameters and BatchNorm statistics in bf16, the
    constant tables (mean cam/shape, mean pose, adjacencies) left fp32, as
    JAX's `cast_float_tree` serving path leaves its jnp constants. JAX then
    promotes the mean-pose add and every stage from the first GCN on to
    fp32, so `para` is fp32 on both sides.

    Bar: atol 2e-2 on para (max |para| ~1.2). Both packages keep the body
    and limb ResNets in bf16 and round their activations at different
    points; JAX's own bf16 para lies ~1e-2 from its fp32 para, and the two
    bf16 results agree to ~9e-3."""
    cfg = DaNetConfig()
    mp = default_mean_params()
    s = 16
    iuv = (rng.rand(2, s, s, 75) > 0.7).astype(np.float32)
    part = (rng.rand(2, 24, s, s, 3, 7) > 0.7).astype(np.float32)
    jmod = JDecomposedPredictor(jax_cfg(cfg), mp)
    variables = randomize(jmod, jnp.asarray(iuv), jnp.asarray(part), seed=5)
    exp = jmod.apply(cast_float_tree(variables, jnp.bfloat16), jnp.asarray(iuv, jnp.bfloat16),
                     jnp.asarray(part, jnp.bfloat16))["para"]
    ours = load(DecomposedPredictor(cfg, mp), variables, port.decomposed_rules(cfg)).to(torch.bfloat16)
    assert all(getattr(ours, n).dtype == torch.float32 for n in DecomposedPredictor.CONSTANTS)
    assert ours.body_net[0].weight.dtype == ours.r2p_gcn.gc[0].weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = ours(nchw(iuv).to(torch.bfloat16), torch.from_numpy(part).to(torch.bfloat16))["para"]
    assert exp.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(exp), atol=2e-2, rtol=0)
    # .double() still lifts the tables to f64 (the f64 parity path)
    assert ours.double().mean_pose.dtype == torch.float64
