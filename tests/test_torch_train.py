"""The port's training slice against the JAX package on the CPU: the LR
schedule and the optimizers against optax, BatchNorm's running statistics
against flax, PartDrop and STN jitter with injected noise, and the whole
training step (GT preparation, GT IUV raster, train-mode forward, every
loss, gradients, one Adam step) at full HRNet-W48 width, 64 px, f64."""

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.data.synthetic import synthetic_raw_batch as jax_raw_batch
from danet_densepose2smpl_tpu.kernels.rasterizer import IUVRenderer as JIUVRenderer
from danet_densepose2smpl_tpu.models import danet as jdanet
from danet_densepose2smpl_tpu.models import iuv_estimator as jest
from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet
from danet_densepose2smpl_tpu.smpl.densepose_atlas import synthetic_densepose_atlas as jax_atlas
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl
from danet_densepose2smpl_tpu.train.prepare import prepare_targets as jax_prepare_targets
from danet_densepose2smpl_tpu.train.step import make_loss_fn, make_lr_schedule as jax_schedule

from danet_densepose2smpl_tpu_torch import port
from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig, SolverConfig
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models import danet as tdanet
from danet_densepose2smpl_tpu_torch.models import iuv_estimator as est
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.nn.layers import BatchNorm1d, BatchNorm2d
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import (
    batch_to_device,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

from test_torch_config import jax_cfg
from test_torch_nn import randomize

torch.set_num_threads(1)
# B=4: at B=2 the body net's last BatchNorms see n = 2 values (1x1 maps),
# normalize them to +-1 whatever they are, and the gradients behind them
# are rounding noise (thread count alone moves the losses by 4e-8); at n = 4
# the step is well conditioned (3e-11)
SIZE, BATCH = 64, 4


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# --------------------------------------------------------------------------
# schedule and optimizers
# --------------------------------------------------------------------------

def test_lr_schedule_matches_optax():
    cfg = Config()
    ours, theirs = make_lr_schedule(cfg), jax_schedule(jax_cfg(cfg))
    for step in (0, 1, 29_999, 30_000, 30_001, 59_999, 60_000, 60_001, 500_000):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6), step


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_steps_match_optax(name, x64_mode):
    """Three updates of the port's optimizer (lr set from the schedule each
    step, as the train step does) against optax on the same gradients."""
    cfg = Config(solver=SolverConfig(optimizer=name, base_lr=1e-3, steps=(0, 2)))
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(4, 5), "b": rng.randn(5) * 1e-3}
    grads = [{k: rng.randn(*v.shape) * 10.0 ** rng.randint(-9, 1) for k, v in p0.items()} for _ in range(3)]

    tx = (optax.adam if name == "adam" else lambda s: optax.sgd(s, momentum=0.9))(jax_schedule(jax_cfg(cfg)))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_optimizer(cfg, list(tp.values()))
    schedule = make_lr_schedule(cfg)
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-12, atol=1e-15)


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError, match="unsupported solver.optimizer"):
        make_optimizer(Config(solver=SolverConfig(optimizer="adamw")), [torch.nn.Parameter(torch.zeros(1))])


# --------------------------------------------------------------------------
# BatchNorm in train mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,shape", [("2d", (2, 4, 4, 6)), ("2d", (2, 1, 1, 7)), ("nodes", (3, 24, 6))])
def test_batchnorm_train_matches_flax(kind, shape, x64_mode):
    """Output and running statistics after one train-mode forward, against
    flax: an NHWC map, the regressor's 1x1 map (n = 2, where torch's own
    unbiased update would double the variance term), and the GCN's
    BatchNorm over the node axis."""
    rng = np.random.RandomState(1)
    x = rng.randn(*shape) * 2.0 + 0.5
    c = shape[-1] if kind == "2d" else shape[1]
    mean0, var0 = rng.randn(c) * 0.1, rng.rand(c) + 0.5
    scale, bias = rng.rand(c) + 0.5, rng.randn(c) * 0.1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, axis=-1 if kind == "2d" else 1)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    m = (BatchNorm2d(c, eps=1e-5) if kind == "2d" else BatchNorm1d(c, eps=1e-5)).double().train()
    with torch.no_grad():
        for t, v in ((m.weight, scale), (m.bias, bias), (m.running_mean, mean0), (m.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy() if kind == "2d" else x)
    got = m(xt).detach().numpy()
    got = np.moveaxis(got, 1, -1) if kind == "2d" else got
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-12)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-9)


# --------------------------------------------------------------------------
# injected noise: STN jitter and PartDrop
# --------------------------------------------------------------------------

def test_stn_scale_jitter_with_injected_noise(rng):
    """The port's two scale jitters with the uniforms JAX draws from the
    same key (split in two, as `stn_affine_params` does), hidden parts on."""
    centers = rng.uniform(-0.8, 0.8, (3, 24, 2)).astype(np.float32)
    hidden = rng.rand(3, 24) < 0.3
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(k, (3, 24))) for k in (k1, k2)])
    jtheta, jscale = jest.stn_affine_params(jnp.asarray(centers), jnp.asarray(jest.LEARNED_RATIO),
                                            jnp.asarray(jest.LEARNED_OFFSET), jnp.asarray(hidden),
                                            scale_jitter=0.2, rng=key)
    theta, scale = est.stn_affine_params(torch.from_numpy(centers), torch.from_numpy(est.LEARNED_RATIO),
                                         torch.from_numpy(est.LEARNED_OFFSET), torch.from_numpy(hidden),
                                         scale_jitter=0.2, scale_noise=torch.from_numpy(u))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-6, atol=1e-7)


def test_partdrop_with_injected_noise(rng):
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (2, 24)))
    jdrop = jdanet.partdrop_mask(key, 2, 0.3)
    drop = torch.from_numpy(u) < 0.3
    np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
    maps = [rng.rand(2, 8, 8, 25).astype(np.float32) for _ in range(3)]
    part = rng.rand(2, 24, 8, 8, 3, 7).astype(np.float32)
    for ours, theirs in zip(tdanet.apply_partdrop_global(*(torch.from_numpy(m) for m in maps), drop),
                            jdanet.apply_partdrop_global(*(jnp.asarray(m) for m in maps), jdrop)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(tdanet.apply_partdrop_partial(torch.from_numpy(part), drop).numpy(),
                                  np.asarray(jdanet.apply_partdrop_partial(jnp.asarray(part), jdrop)))


def test_train_mode_needs_noise_source_and_config_gates():
    model = DaNet(DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4)).train()
    with pytest.raises(ValueError, match="torch.Generator"):
        model(torch.zeros(1, SIZE, SIZE, 3))
    # the chunked crop + head trains (tests/test_torch_chunks.py), backbone
    # rematerialisation too (tests/test_torch_remat.py)
    assert DaNet(DaNetConfig(part_head_chunks=4)).train().training
    remat = DaNet(DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, remat_backbone=True,
                              remat_scope="early")).train()
    assert remat.training and remat.img2iuv.iuv_est.remat_skip_stages == (4,)
    with pytest.raises(ValueError, match="torch.Generator"):
        remat(torch.zeros(1, SIZE, SIZE, 3))


def test_train_forward_with_injected_noise_matches_jax(x64_mode, monkeypatch):
    """The train-mode DaNet forward at full W48 width, 64 px, B=4, f64, with
    the default PartDrop (0.3) and STN centre/scale jitter (0.1/0.2): JAX
    draws its uniforms inside the jitted forward, a recording wrapper of
    `jax.random.uniform` hands them out, and the port takes them injected.
    Outputs and the updated BatchNorm statistics at f64 noise."""
    cfg = DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4)
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
    assert bool((noise["partdrop"] < cfg.partdrop_rate).any())

    model = DaNet(cfg)
    model.load_state_dict(port.state_dict_from_flax(variables, cfg), strict=True)
    model = model.double().train()
    out = model(torch.from_numpy(x), noise=noise)

    pairs = [(out["para"], jout["para"]), (out["iuv_raw"]["stn_scale"], jout["iuv_raw"]["stn_scale"]),
             (out["iuv_raw"]["stn_theta"], jout["iuv_raw"]["stn_theta"]),
             (out["iuv_raw"]["part_iuv"], jout["iuv_raw"]["part_iuv"]),
             (out["part_iuv_clean"], jout["part_iuv_clean"]),
             (out["iuv_clean"][2], jout["iuv_clean"][2])]
    pairs += list(zip(out["joint_rotation"], jout["joint_rotation"]))
    pairs += list(zip(out["joint_position"], jout["joint_position"]))
    assert len(pairs) == 9
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=1e-9, atol=1e-9)
    stats = port.convert({"params": v64["params"], "batch_stats": jstats}, port.danet_rules(cfg))
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-9, atol=1e-10, err_msg=name)


# --------------------------------------------------------------------------
# the whole step
# --------------------------------------------------------------------------

def test_synthetic_raw_batch_equal():
    cfg = Config(danet=DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4))
    ours, theirs = synthetic_raw_batch(cfg, 3, seed=4, num_dp_points=20), jax_raw_batch(jax_cfg(cfg), 3, seed=4, num_dp_points=20)

    def flat(d, pre=""):
        return {pre + k: v for k, v in d.items() if not isinstance(v, dict)} | {
            kk: vv for k, v in d.items() if isinstance(v, dict) for kk, vv in flat(v, k + ".").items()}

    a, b = flat(ours), flat(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_step_matches_jax_f64(x64_mode):
    """One step of the full W48 slice at 64 px (heatmap 16), B=4, f64,
    PartDrop and jitter off, the synthetic soup atlas: JAX's
    prepare_targets -> make_loss_fn -> value_and_grad -> optax.adam
    against the port's `make_train_step`, from the same flax variables.

    Bars: every loss term rtol 1e-9; every gradient within 1e-9 of its
    tensor's largest entry plus 1e-12 (summation order differs between XLA
    and PyTorch's CPU kernels; the heatmap head's bias has a gradient of
    exactly 0 in exact arithmetic, softmax being shift-invariant, and of
    ~1e-15 in floating point); the parameters after the step equal optax's
    first Adam update of the port's gradients (atol 1e-12) and JAX's
    parameters (atol 1e-9) wherever the gradient is at least 1e-6 of its
    tensor's largest entry — below that, g / (|g| + 1e-8) can take either
    sign, and the two may differ by 2 lr; BatchNorm statistics rtol 1e-9,
    atol 1e-10 (batch means of activations in the hundreds cancel to
    ~0.01)."""
    cfg = Config(danet=DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, partdrop_rate=0.0,
                                   stn_center_jitter=0.0, stn_scale_jitter=0.0))
    variables = randomize(JDaNet(jax_cfg(cfg.danet), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=9)
    raw = synthetic_raw_batch(cfg, BATCH, seed=6, num_dp_points=32)
    raw["has_dp"] = np.array([0.0, 1.0, 0.0, 1.0], np.float32)   # DensePose samples: sparse losses live

    # --- JAX ---
    jsmpl = jax_synthetic_smpl()
    jbatch = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), raw)
    prep = jax_prepare_targets(jax_cfg(cfg), jsmpl, jbatch, renderer=JIUVRenderer(jax_atlas(jsmpl), 64, 16))
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    loss_fn = make_loss_fn(JDaNet(jax_cfg(cfg.danet), train=True), jsmpl, jax_cfg(cfg))
    keys = jax.random.split(jax.random.PRNGKey(0))
    (total, (jlosses, jstats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, v64["batch_stats"], prep, keys[0], keys[1]), has_aux=True))(v64["params"])
    tx = optax.adam(jax_schedule(jax_cfg(cfg)))
    upd, _ = tx.update(jgrads, tx.init(v64["params"]), v64["params"])
    jparams = optax.apply_updates(v64["params"], upd)

    # --- port ---
    model = DaNet(cfg.danet)
    model.load_state_dict(port.state_dict_from_flax(variables, cfg.danet), strict=True)
    model = model.double()
    state = create_train_state(model, cfg)
    step = make_train_step(model, synthetic_smpl_model(), cfg,
                           renderer=IUVRenderer(synthetic_densepose_atlas(synthetic_smpl_model()), 64, 16))
    state, metrics = step(state, batch_to_device(raw, "cpu", torch.float64))
    assert state.step == 1

    assert set(metrics) == set(jlosses) | {"loss_total"}
    for k, v in jlosses.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-9, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(metrics["loss_total"].item(), float(total), rtol=1e-9)
    assert metrics["loss_Udp"].item() > 0 and metrics["loss_pU"].item() > 0

    rules = port.danet_rules(cfg.danet)
    grads = port.convert({"params": jgrads, "batch_stats": jstats}, rules)
    after = port.convert({"params": jparams, "batch_stats": jstats}, rules)
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(named) <= set(grads)
    before = port.state_dict_from_flax(v64, cfg.danet)
    lr = cfg.solver.base_lr
    for name, p in named.items():
        g, ours = grads[name].numpy(), p.grad.numpy()
        np.testing.assert_allclose(ours, g, rtol=0, atol=1e-9 * np.abs(g).max() + 1e-12, err_msg=name)
        # the step applied optax.adam's first update to the port's own gradients
        adam = before[name].numpy() - lr * ours / (np.abs(ours) + 1e-8)
        np.testing.assert_allclose(p.detach().numpy(), adam, rtol=0, atol=1e-12, err_msg=name)
        # against JAX's parameters: Adam's first update is lr * g / (|g| + 1e-8),
        # a sign wherever |g| >> 1e-8, so it is held tight only where the
        # gradient stands far above its error bar
        sure = np.abs(g) >= 1e-6 * np.abs(g).max()
        diff = np.abs(p.detach().numpy() - after[name].numpy())
        assert diff[sure].max(initial=0) <= 1e-9 and diff.max() <= 2 * lr + 1e-12, name
    for name, b in buffers.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), after[name].numpy(), rtol=1e-9, atol=1e-10, err_msg=name)
