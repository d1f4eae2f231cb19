"""The input-mode ablations ('iuv_gt', 'iuv_feat', 'iuv_gt_feat', 'feat',
'seg') of the port against the JAX package on the CPU: the eval forward of
each at full HRNet-W48 width (and 'iuv_feat' with the GlobalPredictor), the
feature modes' part-crop layout, the weight names of the oracle, and the
entry points that refuse the GT modes or skip their vis step. The train
steps are `tests/test_torch_input_modes_train*.py`, which share the helpers
below.

Each model is the JAX one with seeded numpy variables (`test_torch_nn.
randomize`), converted by `port.state_dict_from_flax` and loaded strictly;
64 px (heatmap 16), B=4, f64. The GT modes get a synthetic GT IUV image and
GT keypoints, as `tests/test_danet_model.py` gives the JAX model. Bars: f64
`para`, the regressor's inputs and `part_iuv_clean` rtol/atol 1e-9."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.models import smpl_regressor as jreg
from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet
from danet_densepose2smpl_tpu.nn.iuv_head import PartialIUVHead as JPartialIUVHead
from danet_densepose2smpl_tpu.ops.imwarp import separable_crop as jax_separable_crop
from danet_densepose2smpl_tpu.port.convert import _flatten

from danet_densepose2smpl_tpu_torch import port
from danet_densepose2smpl_tpu_torch.cli import demo as cli_demo
from danet_densepose2smpl_tpu_torch.cli import eval as cli_eval
from danet_densepose2smpl_tpu_torch.cli import eval_coco as cli_eval_coco
from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig, TrainConfig
from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch, write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.models.danet import GT_MODES, DaNet
from danet_densepose2smpl_tpu_torch.models.iuv_estimator import crop_theta, feat_crops_and_head
from danet_densepose2smpl_tpu_torch.nn.iuv_head import PartialIUVHead
from danet_densepose2smpl_tpu_torch.serve import Predictor
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.fits_dict import FitsDict
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step
from danet_densepose2smpl_tpu_torch.train.trainer import Trainer

from test_torch_config import jax_cfg
from test_torch_nn import randomize

torch.set_num_threads(1)
SIZE, BATCH = 64, 4
HM = SIZE // 4
MODES = ("iuv_gt", "iuv_feat", "iuv_gt_feat", "feat", "seg")
# train mode without noise, so both packages see the same inputs
QUIET = dict(partdrop_rate=0.0, stn_center_jitter=0.0, stn_scale_jitter=0.0)


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def mode_cfg(mode: str, **kw) -> DaNetConfig:
    return DaNetConfig(img_size=SIZE, heatmap_size=HM, input_mode=mode, **kw)


def gt_inputs(seed: int, b: int = BATCH, s: int = HM):
    """A synthetic GT IUV image (B, S, S, 3) (patch ids 0-24, U/V on the
    body) and GT keypoints (B, 24, 3) in [-0.8, 0.8] with confidence 1, f64."""
    rng = np.random.RandomState(seed)
    part = rng.randint(0, 25, (b, s, s)).astype(np.float64)
    uv = np.stack([part / 24, rng.rand(b, s, s) * (part > 0), rng.rand(b, s, s) * (part > 0)], -1)
    kps = np.concatenate([rng.uniform(-0.8, 0.8, (b, 24, 2)), np.ones((b, 24, 1))], -1)
    return uv, kps


def gt_kwargs(mode: str, uv, kps, to):
    """The forward's GT keyword arguments of `mode`, each through `to`."""
    if mode == "iuv_gt":
        return {"uv_image_gt": to(uv), "smpl_kps_gt": to(kps)}
    return {"uv_image_gt": to(uv)} if mode == "iuv_gt_feat" else {}


def variables_for(cfg: DaNetConfig, seed: int):
    """Seeded numpy variables of the JAX DaNet for `cfg` (fp32)."""
    uv, kps = gt_inputs(0, 1)
    kw = gt_kwargs(cfg.input_mode, uv, kps, lambda a: jnp.asarray(a, jnp.float32))
    return randomize(JDaNet(jax_cfg(cfg), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=seed, **kw)


def port_model(cfg: DaNetConfig, variables) -> DaNet:
    model = DaNet(cfg)
    model.load_state_dict(port.state_dict_from_flax(variables, cfg), strict=True)
    return model


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def jax_regressor_inputs(module, variables, image, train: bool, **kw):
    """`module.apply` with the regressor's call intercepted: (outputs,
    [its positional inputs, global_feats, part_feats], mutated state)."""
    seen = []

    def interceptor(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, jreg.DecomposedPredictor):
            seen.append([*args, kwargs.get("global_feats"), kwargs.get("part_feats")])
        elif context.method_name == "__call__" and isinstance(context.module, jreg.GlobalPredictor):
            seen.append([args[0], None, kwargs.get("global_feats"), None])
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        if train:
            out, state = module.apply(variables, image, mutable=["batch_stats"], **kw)
        else:
            out, state = module.apply(variables, image, **kw), None
    return out, seen[0], state


def port_regressor_inputs(model: DaNet, *args, **kw):
    """The port model's outputs and the regressor's inputs in JAX's layout
    (channels last; None where JAX has None)."""
    seen = []

    def hook(_, inputs):
        seen.append(list(inputs) + [None] * (4 - len(inputs)))

    handle = model.iuv2smpl.smpl_para_Outs.register_forward_pre_hook(hook)
    try:
        out = model(*args, **kw)
    finally:
        handle.remove()
    body, part, gfeats, pfeats = seen[0]
    if not model.cfg.decomposed:          # GlobalPredictor(body, global_feats)
        part, gfeats = None, part

    def nhwc(t):
        return None if t is None else t.permute(0, 2, 3, 1)

    return out, [nhwc(body), part, nhwc(gfeats), pfeats]


def assert_inputs_equal(ours, theirs, tol=1e-9):
    names = ("body input", "limb input", "global_feats", "part_feats")
    for name, a, b in zip(names, ours, theirs):
        assert (a is None) == (b is None), name
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape), (name, a.shape, b.shape)
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=tol, atol=tol, err_msg=name)


EVAL_CONFIGS = {m: mode_cfg(m) for m in MODES} | {"iuv_feat_global": mode_cfg("iuv_feat", decomposed=False)}


@pytest.mark.parametrize("name", ["iuv_gt", "iuv_feat", "iuv_feat_global"])
def test_eval_forward_matches_jax_f64(name, x64_mode):
    """See `check_eval_forward`; 'iuv_gt_feat', 'feat' and 'seg' are in
    `tests/test_torch_input_modes_eval.py`."""
    check_eval_forward(name)


def check_eval_forward(name: str):
    """Eval `para`, the regressor's inputs (body and limb inputs, features
    and their part crops, each None where JAX passes None) and
    `part_iuv_clean` of `EVAL_CONFIGS[name]` against the JAX model, f64,
    rtol/atol 1e-9."""
    cfg = EVAL_CONFIGS[name]
    variables = variables_for(cfg, seed=3)
    x = np.random.RandomState(11).rand(BATCH, SIZE, SIZE, 3)
    uv, kps = gt_inputs(5)
    jfn = jax.jit(lambda v, img, kw: jax_regressor_inputs(JDaNet(jax_cfg(cfg), train=False), v, img, False, **kw)[:2])
    jout, jin = jfn(f64(variables), jnp.asarray(x), gt_kwargs(cfg.input_mode, uv, kps, jnp.asarray))
    model = port_model(cfg, variables).double()
    with torch.no_grad():
        out, ins = port_regressor_inputs(model, torch.from_numpy(x),
                                         **gt_kwargs(cfg.input_mode, uv, kps, torch.from_numpy))
    assert out["para"].shape == (BATCH, 229)
    np.testing.assert_allclose(out["para"].numpy(), np.asarray(jout["para"]), rtol=1e-9, atol=1e-9)
    assert_inputs_equal(ins, jin)
    assert ("part_iuv_clean" in out) == cfg.decomposed == ("part_iuv_clean" in jout)
    if cfg.decomposed:
        np.testing.assert_allclose(out["part_iuv_clean"].numpy(), np.asarray(jout["part_iuv_clean"]),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("c,s", [(5, 8), (48, 6)])
def test_feat_crop_layout_matches_jax(c, s, x64_mode):
    """The feature modes' part crops and partial head
    (`feat_crops_and_head`) against JAX's `separable_crop` and its
    `PartialIUVHead` on the crops transposed part-major, f64 to 1e-12, on
    a kernel whose groups differ: a head reading the channels in another
    order (part-minor, or the crops untransposed) gives other stacks."""
    rng = np.random.RandomState(c)
    b, h = 2, 9
    feats = rng.randn(b, h, h, c)
    centers, scales = rng.uniform(-0.6, 0.6, (b, 24, 2)), rng.uniform(0.2, 0.9, (b, 24))
    theta = crop_theta(torch.from_numpy(centers), torch.from_numpy(scales))
    head_vars = f64(randomize(JPartialIUVHead(), jnp.zeros((1, s, s, 24 * c), jnp.float32), seed=c))
    crops = jax_separable_crop(jnp.asarray(feats), jnp.asarray(centers), jnp.asarray(scales), s)
    exp = JPartialIUVHead().apply(head_vars, crops.transpose(0, 2, 3, 1, 4).reshape(b, s, s, -1))

    head = PartialIUVHead(c).double()
    head.load_state_dict(port.convert(head_vars, port.conv_rules("", ("predict_partial_iuv",), bias=True)),
                         strict=True)
    with torch.no_grad():
        got_crops, got = feat_crops_and_head(head, torch.from_numpy(feats), theta, s)
        swapped = head(got_crops.permute(0, 4, 1, 2, 3).reshape(b, c * 24, s, s))
    assert got_crops.shape == (b, 24, s, s, c) and got.shape == (b, 24, s, s, 3, 7)
    np.testing.assert_allclose(got_crops.numpy(), np.asarray(crops), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=1e-12)
    assert np.abs(swapped.numpy() - np.asarray(exp)).max() > 1e-3


def test_oracle_weight_names_round_trip():
    """'iuv_gt': the rules reach every flax leaf of the JAX oracle DaNet
    exactly once (the top-level STN ratio/offset and the regressor; no
    estimator), under the port's state_dict names (the ratio/offset as the
    reference's `img2iuv.learned_*`, parameters here, buffers in the other
    modes), and converting back with the inverse layouts returns every
    leaf."""
    cfg = mode_cfg("iuv_gt")
    variables = variables_for(cfg, seed=4)
    rules = port.danet_rules(cfg)
    paths = [tuple(r[1]) for r in rules]
    leaves = {(col,) + p for col in ("params", "batch_stats") for p in _flatten(variables[col])}
    assert len(paths) == len(set(paths)) and set(paths) == leaves
    assert ("params", "stn_ratio") in leaves and not any(p[1] == "img2iuv" for p in leaves)
    model = port_model(cfg, variables)
    sd = model.state_dict()
    assert {r[0] for r in rules} == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert {"img2iuv.learned_ratio", "img2iuv.learned_offset"} <= set(dict(model.named_parameters()))
    assert "img2iuv.learned_ratio" in dict(DaNet(mode_cfg("feat")).named_buffers())
    inverse = {   # torch tensor, flax shape -> the flax leaf
        None: lambda w, shape: w,
        port._conv_w: lambda w, shape: np.transpose(w, (2, 3, 1, 0)),
        port._dense_w: lambda w, shape: w.T,
        port._edge: lambda w, shape: w[0],
        port._flat: lambda w, shape: w.reshape(shape),
        port._partwise_w: lambda w, shape: np.transpose(w[..., 0, 0].reshape(shape[0], shape[2], shape[1]), (0, 2, 1)),
    }
    for key, path, transform in rules:
        node = variables
        for name in path:
            node = node[name]
        node = np.asarray(node)
        np.testing.assert_array_equal(inverse[transform](sd[key].numpy(), node.shape), node, err_msg=key)


@pytest.mark.parametrize("mode", MODES)
def test_adapters_sized_by_mode(mode):
    """The regressor's adapters take the mode's channels (backbone width
    C = 48): body 75 / 75 + C / C / 25, limb 21 / 21 + C / C / 7; the
    GlobalPredictor's adapter the body's; with `hrnet_pad_channels` the
    backbone is 64 channels wide, and the feature modes' adapters take C =
    64 ('iuv_gt' has no backbone)."""
    for pad, c in ((False, 48), (True, 64)):
        body, limb = {"iuv_gt": (75, 21), "iuv_feat": (75 + c, 21 + c), "iuv_gt_feat": (75 + c, 21 + c),
                      "feat": (c, c), "seg": (25, 7)}[mode]
        reg = DaNet(DaNetConfig(input_mode=mode, hrnet_pad_channels=pad)).iuv2smpl.smpl_para_Outs
        assert (reg.body_net[0].in_channels, reg.limb_net[0].in_channels) == (body, limb)
        glob = DaNet(DaNetConfig(input_mode=mode, decomposed=False, hrnet_pad_channels=pad)).iuv2smpl.smpl_para_Outs
        assert glob.Conv1x1BNRelu_0[0].in_channels == body


@pytest.mark.parametrize("mode", GT_MODES)
def test_gt_modes_refused_by_serving(mode, tmp_path):
    """`Predictor`, `cli.eval`, `cli.eval_coco` and `cli.demo` refuse the GT
    modes up front with a ValueError naming the mode (the JAX eval and demo
    call the model without GT and fail on an AssertionError); `cli.eval
    --regressor hmr` does not read the mode."""
    cfg_file = tmp_path / "gt.yaml"
    cfg_file.write_text(f"DANET:\n  INPUT_MODE: '{mode}'\n")
    match = f"input_mode='{mode}'"
    with pytest.raises(ValueError, match=match):
        Predictor("cpu", cfg=DaNetConfig(input_mode=mode))
    with pytest.raises(ValueError, match=match):
        Predictor("cpu", model=DaNet(mode_cfg(mode)))
    common = ["--cpu", "--cfg", str(cfg_file), "--synthetic-data", "--num_samples", "2", "--batch_size", "2"]
    with pytest.raises(ValueError, match=match):
        cli_eval.main(common + ["--dataset", "h36m-p2"])
    with pytest.raises(ValueError, match=match):
        cli_eval_coco.main(common)
    with pytest.raises(ValueError, match=match):
        cli_demo.main(["--cpu", "--cfg", str(cfg_file), "--synthetic-assets", "--img", str(tmp_path / "x.png"),
                       "--out_dir", str(tmp_path)])


def test_train_step_without_render_raises(x64_mode):
    """A GT-mode step built without a renderer has no `uv_image_gt` in its
    batch: a ValueError naming the mode (JAX raises a bare KeyError)."""
    cfg = Config(danet=mode_cfg("iuv_gt"))
    model = DaNet(cfg.danet)
    step = make_train_step(model, synthetic_smpl_model(num_verts=300), cfg)
    batch = batch_to_device(synthetic_raw_batch(cfg, 2, seed=1, num_dp_points=4), "cpu")
    with pytest.raises(ValueError, match="input_mode='iuv_gt'.*uv_image_gt"):
        step(create_train_state(model, cfg), batch, torch.Generator().manual_seed(0))


def test_trainer_skips_vis_in_gt_modes(tmp_path, capsys):
    """The Trainer in 'iuv_gt' at a vis interval: the step trains, the vis
    step prints its one skip line (from the mode, not from a failure) and
    writes no PNG."""
    npz, img_dir = write_synthetic_dataset(str(tmp_path / "data"), n=2, seed=3, with_dp=True)
    ds = NpzDataset(npz, img_dir, name="h36m", is_train=True, heatmap_size=HM)
    cfg = Config(danet=mode_cfg("iuv_gt"), train=TrainConfig(batch_size=2, num_epochs=1, pretr_step=0,
                                                              vis_interval=1, summary_steps=1,
                                                              prefetch_workers=0))
    smpl = synthetic_smpl_model(num_verts=300)
    from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas

    class Resized:   # the dataset crops at 224 px; the model takes 64
        def __len__(self):
            return len(ds)

        def __getitem__(self, i, rng=None):
            from danet_densepose2smpl_tpu_torch.data.transforms import resize_bilinear

            item = ds.__getitem__(i, rng=rng)
            item["img"] = resize_bilinear(item["img"], (SIZE, SIZE))
            return item

    trainer = Trainer(cfg, Resized(), smpl, IUVRenderer(synthetic_densepose_atlas(smpl), SIZE, HM),
                      FitsDict.from_datasets({"h36m": ds}), str(tmp_path / "run"), device="cpu")
    state = trainer.train()
    out = capsys.readouterr().out
    assert state.step == 1
    assert out.count("vis skipped: input_mode='iuv_gt'") == 1, out
    assert not (tmp_path / "run" / "vis").exists()


class F64Render:
    """A GT renderer whose fp32 image is cast to f64: exact (the flat
    raster copies the atlas's fp32 texture values). The render is fp32 in
    both packages, and the GT maps and part crops made from it keep its
    dtype, so with it as it is the GT crops are fp32 contractions that the
    two frameworks round apart (fused multiply-adds in another order):
    their ~1e-7 reaches the partial UV losses' gradients, and in the GT
    modes the forward itself. Cast, both packages run the step in f64."""

    def __init__(self, renderer, cast):
        self.renderer, self.cast = renderer, cast

    def __call__(self, verts, cam):
        return self.cast(self.renderer(verts, cam))


def check_train_step(mode: str, grad_bar: float = 1e-9) -> DaNet:
    """One f64 training step of `mode` at full W48 width, 64 px, B=4,
    PartDrop and jitter off, the synthetic soup atlas: JAX's
    prepare_targets -> make_loss_fn -> value_and_grad against the port's
    `make_train_step`, from the same flax variables. Every loss term rtol
    1e-9; every gradient within `grad_bar` of its tensor's largest entry
    plus 1e-12 (as `tests/test_torch_train.py`); BatchNorm statistics rtol
    1e-9, atol 1e-10. Both renders are cast to f64 (`F64Render`; with the
    fp32 render, 'feat''s and 'seg''s partial head, which only the partial
    UV losses train, parts from JAX by 3.6e-9 of its largest gradient).
    Returns the port model after the step (its gradients in place)."""
    from danet_densepose2smpl_tpu.kernels.rasterizer import IUVRenderer as JIUVRenderer
    from danet_densepose2smpl_tpu.smpl.densepose_atlas import synthetic_densepose_atlas as jax_atlas
    from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl
    from danet_densepose2smpl_tpu.train.prepare import prepare_targets as jax_prepare_targets
    from danet_densepose2smpl_tpu.train.step import make_loss_fn

    from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas

    cfg = Config(danet=mode_cfg(mode, **QUIET))
    variables = variables_for(cfg.danet, seed=9)
    raw = synthetic_raw_batch(cfg, BATCH, seed=6, num_dp_points=32)
    raw["has_dp"] = np.array([0.0, 1.0, 0.0, 1.0], np.float32)   # DensePose samples: sparse losses live

    jsmpl = jax_synthetic_smpl()
    jrender = JIUVRenderer(jax_atlas(jsmpl), SIZE, HM)
    jbatch = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), raw)
    prep = jax_prepare_targets(jax_cfg(cfg), jsmpl, jbatch,
                               renderer=F64Render(jrender, lambda a: a.astype(jnp.float64)))
    v64 = f64(variables)
    loss_fn = make_loss_fn(JDaNet(jax_cfg(cfg.danet), train=True), jsmpl, jax_cfg(cfg))
    keys = jax.random.split(jax.random.PRNGKey(0))
    (total, (jlosses, jstats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, v64["batch_stats"], prep, keys[0], keys[1]), has_aux=True))(v64["params"])

    model = port_model(cfg.danet, variables).double()
    state = create_train_state(model, cfg)
    render = IUVRenderer(synthetic_densepose_atlas(synthetic_smpl_model()), SIZE, HM)
    step = make_train_step(model, synthetic_smpl_model(), cfg, renderer=F64Render(render, torch.Tensor.double))
    state, metrics = step(state, batch_to_device(raw, "cpu", torch.float64))

    assert set(metrics) == set(jlosses) | {"loss_total"}
    for k, v in jlosses.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-9, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(metrics["loss_total"].item(), float(total), rtol=1e-9)

    grads = port.convert({"params": jgrads, "batch_stats": jstats}, port.danet_rules(cfg.danet))
    named = dict(model.named_parameters())
    assert set(named) <= set(grads)
    for name, p in named.items():
        g = grads[name].numpy()
        ours = np.zeros_like(g) if p.grad is None else p.grad.numpy()   # untouched by the loss: zero
        np.testing.assert_allclose(ours, g, rtol=0, atol=grad_bar * np.abs(g).max() + 1e-12, err_msg=name)
    stats = port.convert({"params": v64["params"], "batch_stats": jstats}, port.danet_rules(cfg.danet))
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-9, atol=1e-10, err_msg=name)
    return model
