"""The port's other DaNet architectures against the JAX package on the CPU:
the PoseResNet IUV backbone (its transposed convs alone in f64 to 1e-12),
the GlobalPredictor (`decomposed=False`) and its names, the 'gcn_direct',
'lstm' and 'lstm_direct' refinements and refinement without `refine_on` /
`pos_intersupv`, the HMR baseline, the kinematic tables the LSTM strategies
walk, the input modes that still raise, and K1's plain version at the
ResNet backbone's 256 channels.

Each model is the JAX one with seeded numpy variables (`test_torch_nn.
randomize`), converted by `port.state_dict_from_flax` (or
`hmr_state_dict_from_flax`) and loaded strictly. The architectures run on a
ResNet-18 backbone at 64 px (heatmap 16), B=2 in eval and B=4 in train mode
(at B=2 the regressor's last BatchNorms normalize two values to +-1); bars:
f64 `para` atol 1e-6 / rtol 1e-9, as `tests/test_torch_slice.py`, and f32 at
the weight bridge's bar (atol 0.05, rtol 1e-3)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.kernels.part_crop_head import fused_part_predict as jax_fused
from danet_densepose2smpl_tpu.models import smpl_regressor as jreg
from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet
from danet_densepose2smpl_tpu.nn.hmr import HMR as JHMR
from danet_densepose2smpl_tpu.nn.resnet import DeconvLayer as JDeconvLayer
from danet_densepose2smpl_tpu.port import apply_rules
from danet_densepose2smpl_tpu.port.convert import _flatten
from danet_densepose2smpl_tpu.port.danet_map import danet_rules as jax_danet_rules
from danet_densepose2smpl_tpu.port.danet_map import fuse_lstm_biases, hmr_rules as jax_hmr_rules

from danet_densepose2smpl_tpu_torch import port
from danet_densepose2smpl_tpu_torch.cli import demo
from danet_densepose2smpl_tpu_torch.cli import eval_coco as cli_eval_coco
from danet_densepose2smpl_tpu_torch.cli import train as cli_train
from danet_densepose2smpl_tpu_torch.config import DaNetConfig, RefinementConfig
from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
    fused_part_predict,
    pack_head_weights,
    part_crop_head_plain,
)
from danet_densepose2smpl_tpu_torch.models import smpl_regressor as treg
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.nn.hmr import HMR
from danet_densepose2smpl_tpu_torch.nn.layers import bn
from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights
from danet_densepose2smpl_tpu_torch.utils.vis import DEMO_PANELS

from test_torch_config import jax_cfg
from test_torch_demo import write_frames
from test_torch_nn import randomize

torch.set_num_threads(1)
SIZE = 64
RESNET = dict(img_size=SIZE, heatmap_size=SIZE // 4, iuv_regressor="resnet", msres_num_layers=18)
# the configurations of this slice, each on the ResNet-18 backbone
ARCHS = {
    "resnet": DaNetConfig(**RESNET),
    "global": DaNetConfig(**RESNET, decomposed=False),
    "gcn_direct": DaNetConfig(**RESNET, refine_strategy="gcn_direct"),
    "lstm": DaNetConfig(**RESNET, refine_strategy="lstm"),
    "lstm_direct": DaNetConfig(**RESNET, refine_strategy="lstm_direct"),
    "refine_off": DaNetConfig(**RESNET, refinement=RefinementConfig(refine_on=False)),
    "intersupv_off": DaNetConfig(**RESNET, refinement=RefinementConfig(pos_intersupv=False)),
}
# train mode without noise, so both packages see the same inputs
QUIET = dict(partdrop_rate=0.0, stn_center_jitter=0.0, stn_scale_jitter=0.0)


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _variables(cfg, seed=3):
    return randomize(JDaNet(jax_cfg(cfg), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=seed)


def _port(cfg, variables):
    model = DaNet(cfg)
    model.load_state_dict(port.state_dict_from_flax(variables, cfg), strict=True)
    return model


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_lstm_tables_pinned():
    """The port's copies of the kinematic orders the LSTM strategies walk."""
    assert treg.LIMB_BRANCHES == jreg.LIMB_BRANCHES
    assert treg.LSTM_CHAINS == jreg.LSTM_CHAINS


def test_deconv_conversion_f64(x64_mode):
    """One PoseResNet deconv layer: flax's 'SAME' transposed conv (k=4,
    s=2) + BN + ReLU against torch's ConvTranspose2d(4, 2, 1) + BN + ReLU
    from the converted kernel, in f64 to 1e-12. A kernel converted without
    its spatial flip keeps every shape and fails this."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 5, 16)
    variables = _f64(randomize(JDeconvLayer(24), jnp.zeros((1, 7, 5, 16), jnp.float32), seed=1))
    exp = np.asarray(JDeconvLayer(24).apply(variables, jnp.asarray(x)))
    rules = [("0.weight", ("params", "ConvTranspose_0", "kernel"), port._deconv_w)]
    rules += port.bn_rules("1", ("NormAct_0", "norm"))
    layer = torch.nn.Sequential(torch.nn.ConvTranspose2d(16, 24, 4, 2, 1, bias=False), bn(24), torch.nn.ReLU())
    layer.load_state_dict(port.convert(variables, rules), strict=True)
    with torch.no_grad():
        got = layer.double().eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == exp.shape == (2, 14, 10, 24)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-12)
    # the same kernel without the flip is another function of the same shape
    unflipped = np.transpose(np.asarray(variables["params"]["ConvTranspose_0"]["kernel"]), (2, 3, 0, 1))
    layer[0].weight.data.copy_(torch.from_numpy(unflipped.copy()))
    with torch.no_grad():
        wrong = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(wrong - exp).max() > 1e-3


@pytest.mark.parametrize("arch", ["resnet", "global"])
def test_arch_matches_jax_f64(arch, x64_mode):
    """The PoseResNet-18 DaNet and the GlobalPredictor model: see
    `check_arch`. (The refinement strategies are
    `tests/test_torch_refine.py`.)"""
    check_arch(arch)


def check_arch(arch):
    """Eval `para` (and the STN scales and 'lstm_direct''s eval-mode
    rotations), then train mode without noise: `para`, the
    `joint_rotation` and `joint_position` lists and the BatchNorm running
    statistics after the forward, all in f64. The statistics are held to
    rtol 1e-9, atol 1e-8: the deepest (the rot2pos MLPs at the end of a limb
    branch, a chain of ~16 layers after the backbone) part by up to ~5e-10
    on entries of ~0.1, the summation order of batch means of activations
    in the tens."""
    cfg = ARCHS[arch]
    variables = _variables(cfg)
    v64 = _f64(variables)
    model = _port(cfg, variables).double()
    rng = np.random.RandomState(11)

    x = rng.rand(2, SIZE, SIZE, 3)
    jout = jax.jit(JDaNet(jax_cfg(cfg), train=False).apply)(v64, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out["para"].shape == (2, 229)
    np.testing.assert_allclose(out["para"].numpy(), np.asarray(jout["para"]), atol=1e-6, rtol=1e-9)
    assert len(out.get("joint_rotation", [])) == len(jout.get("joint_rotation", []))
    for a, b in zip(out.get("joint_rotation", []), jout.get("joint_rotation", [])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-9)
    assert ("stn_scale" in out["iuv_raw"]) == cfg.decomposed == ("part_iuv_clean" in out)
    if cfg.decomposed:
        np.testing.assert_allclose(out["iuv_raw"]["stn_scale"].numpy(), np.asarray(jout["iuv_raw"]["stn_scale"]),
                                   atol=1e-9)

    tcfg = dataclasses.replace(cfg, **QUIET)
    x = rng.rand(4, SIZE, SIZE, 3)
    jout, jstate = jax.jit(lambda v, im: JDaNet(jax_cfg(tcfg), train=True).apply(v, im, mutable=["batch_stats"]))(
        v64, jnp.asarray(x))
    model = _port(tcfg, variables).double().train()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out["para"].numpy(), np.asarray(jout["para"]), atol=1e-6, rtol=1e-9)
    for key in ("joint_rotation", "joint_position"):
        ours, theirs = out.get(key, []), jout.get(key, [])
        assert len(ours) == len(theirs), key
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-9, err_msg=key)
    stats = port.convert({"params": variables["params"], "batch_stats": jstate["batch_stats"]}, port.danet_rules(cfg))
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=1e-9, atol=1e-8, err_msg=name)


def test_resnet_danet_f32_at_the_bridge_bar():
    """fp32 on both sides, the weight bridge's bar for fp32 `para`."""
    cfg = ARCHS["resnet"]
    variables = _variables(cfg, seed=4)
    x = np.random.RandomState(12).rand(2, SIZE, SIZE, 3).astype(np.float32)
    exp = np.asarray(jax.jit(JDaNet(jax_cfg(cfg), train=False).apply)(variables, jnp.asarray(x))["para"])
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(x))["para"].numpy()
    np.testing.assert_allclose(got, exp, atol=0.05, rtol=1e-3)


@pytest.mark.parametrize("arch", ["resnet"])
def test_weight_bridge_round_trip(arch):
    """See `check_round_trip`; the refinement strategies' are in
    `tests/test_torch_refine.py`."""
    check_round_trip(arch)


def check_round_trip(arch):
    """The port's state_dict goes through the JAX package's checkpoint map
    (`danet_rules`, reference checkpoint names; the LSTM biases fused as
    `load_danet_checkpoint` fuses them) back to the flax variables it came
    from, exactly. The JAX map names the refinement GCN and the coordinate
    heads whatever the config: its rules for modules the config leaves out
    are dropped here."""
    cfg = ARCHS[arch]
    variables = _variables(cfg)
    sd = fuse_lstm_biases({k: v.numpy() for k, v in _port(cfg, variables).state_dict().items()})
    flat = {col: _flatten(variables[col]) for col in ("params", "batch_stats")}
    rules = [r for r in jax_danet_rules(jax_cfg(cfg)) if tuple(r[1][1:]) in flat[r[1][0]]]
    back, report = apply_rules(sd, variables, rules, strict=True)
    assert report["unconsumed_torch_keys"] == [] and report["unfilled_params"] == []
    for col in ("params", "batch_stats"):
        ours = _flatten(back[col])
        assert ours.keys() == flat[col].keys()
        for path in flat[col]:
            np.testing.assert_array_equal(ours[path], flat[col][path], err_msg="/".join(path))


def test_global_predictor_names_round_trip():
    """`decomposed=False`: the rules reach every flax leaf of the JAX DaNet
    exactly once (no STN ratio/offset, no partial head: the JAX estimator
    stops after its heads), their torch names are the port's state_dict
    keys, and converting back with the inverse layouts returns every leaf."""
    cfg = ARCHS["global"]
    variables = _variables(cfg)
    rules = port.danet_rules(cfg)
    paths = [tuple(r[1]) for r in rules]
    leaves = {(col,) + p for col in ("params", "batch_stats") for p in _flatten(variables[col])}
    assert len(paths) == len(set(paths)) and set(paths) == leaves
    assert not any("stn_" in "/".join(p) or "partial" in "/".join(p) for p in paths)
    model = DaNet(cfg)
    sd = model.state_dict()
    assert {r[0] for r in rules} == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert any(k.startswith("iuv2smpl.smpl_para_Outs.Conv1x1BNRelu_0.") for k in sd)
    assert any(k.startswith("iuv2smpl.smpl_para_Outs.conv_body.final_layer") for k in sd)
    model.load_state_dict(port.state_dict_from_flax(variables, cfg), strict=True)
    inverse = {port._conv_w: lambda w: np.transpose(w, (2, 3, 1, 0)), port._dense_w: np.transpose, None: None,
               port._deconv_w: lambda w: np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))}
    sd = model.state_dict()
    for key, path, transform in rules:
        node = variables
        for name in path:
            node = node[name]
        back = sd[key].numpy() if inverse[transform] is None else inverse[transform](sd[key].numpy())
        np.testing.assert_array_equal(back, np.asarray(node), err_msg=key)


def test_hmr_matches_jax_f64(x64_mode):
    """The HMR baseline at 64 px, B=2, from the JAX HMR's variables through
    `hmr_state_dict_from_flax`: rotation matrices, shape and camera in f64;
    the state_dict round-trips through the JAX package's `hmr_rules`. In
    train mode its dropout acts, at eval it does not."""
    mp = jreg.default_mean_params()
    init = [np.asarray(a, np.float64)[None] for a in (mp.pose6d, mp.shape, mp.cam)]
    sample = (jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 144)), jnp.zeros((1, 10)), jnp.zeros((1, 3)))
    variables = randomize(JHMR(), *sample, seed=5)
    x = np.random.RandomState(13).rand(2, SIZE, SIZE, 3)
    exp = JHMR().apply(_f64(variables), jnp.asarray(x), *(jnp.asarray(a) for a in init))
    model = HMR()
    model.load_state_dict(port.hmr_state_dict_from_flax(variables), strict=True)
    model = model.double().eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), *(torch.from_numpy(a) for a in init))
    for a, b, name in zip(got, exp, ("rotmats", "shape", "cam")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9, rtol=1e-9, err_msg=name)
    assert got[0].shape == (2, 24, 3, 3)

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, report = apply_rules(sd, variables, jax_hmr_rules(), strict=True)
    assert report["unconsumed_torch_keys"] == [] and report["unfilled_params"] == []
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[col]).items():
            np.testing.assert_array_equal(_flatten(back[col])[path], np.asarray(leaf, np.float64),
                                          err_msg="/".join(path))
    model.train()
    with torch.no_grad():
        drop = model(torch.from_numpy(x), *(torch.from_numpy(a) for a in init))
    assert not torch.allclose(drop[2], got[2])


def test_demo_without_decomposed_and_hmr_refusals(tmp_path, capsys):
    """`cli.demo` on a `decomposed=False` model (no part crops: its figure
    has no part grid), and the entry points that run DaNet only refusing
    `--regressor hmr` (the JAX demo and COCO CLI fail on it)."""
    (tmp_path / "cfg.yaml").write_text("DANET:\n  INIMG_SIZE: 64\n  HEATMAP_SIZE: 16\n  DECOMPOSED: false\n"
                                       "  IUV_REGRESSOR: resnet\n  MSRES_NUM_LAYERS: 18\n")
    path = write_frames(tmp_path)[0]
    argv = ["--cpu", "--synthetic-assets", "--num_verts", "500", "--cfg", str(tmp_path / "cfg.yaml"),
            "--img", path, "--out_dir", str(tmp_path / "out")]
    (res,) = demo.main(argv)
    titles = [t for t, _ in res["panels"]]
    assert len(titles) == 5 and titles == [t for t in DEMO_PANELS if t != DEMO_PANELS[3]]
    assert res["para"].shape == (229,) and np.isfinite(res["para"]).all()
    for main in (demo.main, cli_eval_coco.main, cli_train.main):
        with pytest.raises(ValueError, match="runs DaNet only"):
            main(argv[:1] + ["--regressor", "hmr"])


@pytest.mark.parametrize("mode", ["iuv_gt", "iuv_feat", "iuv_gt_feat", "feat", "seg"])
def test_input_modes_still_raise(mode):
    """The input-mode ablations are the second half of ROADMAP item 20."""
    with pytest.raises(NotImplementedError, match="item 20"):
        DaNet(DaNetConfig(input_mode=mode))


def test_k1_plain_at_256_channels_matches_jax_kernel_interpret():
    """K1's plain version at the ResNet backbone's width (B=1, S=8, C=256)
    against the JAX kernel in interpret mode, fp32."""
    rng = np.random.RandomState(2)
    b, h, c, s, k, o = 1, 8, 256, 8, 24, 21
    feats = rng.rand(b, h, h, c).astype(np.float32)
    centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, k, 2)).astype(np.float32))
    scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, k)).astype(np.float32))
    wy = _axis_weights(centers[..., 1], scales, h, s, torch.float32)
    wx = _axis_weights(centers[..., 0], scales, h, s, torch.float32)
    kernel = (rng.randn(3, 3, c, k * o) * 0.05).astype(np.float32)
    bias = (rng.randn(k * o) * 0.1).astype(np.float32)
    got = fused_part_predict(torch.from_numpy(feats), wy, wx, torch.from_numpy(kernel), torch.from_numpy(bias), s)
    exp = np.asarray(jax_fused(jnp.asarray(feats), jnp.asarray(wy.numpy()), jnp.asarray(wx.numpy()),
                               jnp.asarray(kernel), jnp.asarray(bias), s, interpret=True))
    assert got.shape == exp.shape == (b, k, s, s, o)
    np.testing.assert_allclose(got.numpy(), exp, atol=2e-5)


@pytest.mark.parametrize("c,chunk", [(256, 32), (200, 32), (48, 48)])
def test_chunked_packed_weights_gemm_matches_plain_f64(c, chunk):
    """The chunked B operand of the bf16 kernel, written out: for each chunk
    of channels, the crop's nine taps of that chunk side by side in
    (dy, dx, c) order times the chunk's packed weights, summed over the
    chunks, plus the bias, is the plain version's grouped conv (f64,
    1e-12). C=200 leaves a partial last chunk, padded with zeros."""
    rng = np.random.RandomState(3)
    b, h, s, k, o = 1, 10, 9, 24, 21
    f = torch.from_numpy(rng.rand(b, h, h, c))
    centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, k, 2)))
    scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, k)))
    wy = _axis_weights(centers[..., 1], scales, h, s, torch.float64)
    wx = _axis_weights(centers[..., 0], scales, h, s, torch.float64)
    kern, bi = torch.from_numpy(rng.randn(3, 3, c, k * o) * 0.05), torch.from_numpy(rng.randn(k * o) * 0.1)
    packed = pack_head_weights(kern, k, chunk)
    n = -(-c // chunk)
    assert packed.shape == (k, n, 24, 9 * chunk) and packed.is_contiguous()
    assert not packed[:, :, o:].any()
    crop = torch.einsum("bkpw,bkowc->bkopc", wx, torch.einsum("bkoh,bhwc->bkowc", wy, f))
    padded = torch.nn.functional.pad(crop, (0, n * chunk - c, 1, 1, 1, 1))
    gemm = 0
    for j in range(n):
        part = padded[..., j * chunk:(j + 1) * chunk]
        cols = torch.cat([part[:, :, dy:dy + s, dx:dx + s] for dy in range(3) for dx in range(3)], -1)
        gemm = gemm + torch.einsum("bkyxq,knq->bkyxn", cols, packed[:, j])
    got = gemm[..., :o] + bi.reshape(k, o)[None, :, None, None, :]
    ref = part_crop_head_plain(f, wy, wx, kern, bi, s)
    assert (got - ref).abs().max().item() <= 1e-12
    if n == 1:   # one chunk of all of C: the unchunked layout's bytes
        assert torch.equal(packed[:, 0], pack_head_weights(kern, k))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 200])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2), ("float64", 1e-10)])
def test_cuda_kernel_wide_channels_match_plain(rng, cuda_device, c, dtype, tol):
    """K1 on the card at the ResNet backbone's C=256 (the kernels take the
    channels in chunks) and at C=200 (a partial last chunk), B=1, S=56,
    against the plain version; bf16 relative to max|ref|."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    b, h, s, k, o = 1, 56, 56, 24, 21
    feats = torch.from_numpy(rng.rand(b, h, h, c)).to(cuda_device, dt)
    centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, k, 2)))
    scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, k)))
    wy = _axis_weights(centers[..., 1], scales, h, s, torch.float64).to(cuda_device, dt)
    wx = _axis_weights(centers[..., 0], scales, h, s, torch.float64).to(cuda_device, dt)
    kern = torch.from_numpy(rng.randn(3, 3, c, k * o) * 0.05).to(cuda_device, dt)
    bi = torch.from_numpy(rng.randn(k * o) * 0.1).to(cuda_device, dt)
    before = fused_part_predict.launches
    got = fused_part_predict(feats, wy, wx, kern, bi, s)
    torch.cuda.synchronize()
    assert fused_part_predict.launches == before + 1
    ref = part_crop_head_plain(feats, wy, wx, kern, bi, s)
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item() if dtype == "bfloat16" else 1.0
    assert err <= tol * scale, (dtype, c, err, scale)


@pytest.mark.slow
def test_resnet50_danet_224_matches_jax_f64(x64_mode):
    """`configs/danet_resnet.yaml`'s model at full size: the ResNet-50
    DaNet at 224 px (C=256 into the part crops), B=2, f64, eval `para`
    atol 1e-6 / rtol 1e-9."""
    cfg = DaNetConfig(iuv_regressor="resnet")
    variables = randomize(JDaNet(jax_cfg(cfg), train=False), jnp.zeros((1, 224, 224, 3), jnp.float32), seed=3)
    x = np.random.RandomState(14).rand(2, 224, 224, 3)
    exp = np.asarray(jax.jit(JDaNet(jax_cfg(cfg), train=False).apply)(_f64(variables), jnp.asarray(x))["para"])
    with torch.no_grad():
        got = _port(cfg, variables).double()(torch.from_numpy(x))["para"].numpy()
    np.testing.assert_allclose(got, exp, atol=1e-6, rtol=1e-9)
