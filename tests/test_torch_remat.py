"""Backbone rematerialisation (`remat_backbone`, `remat_scope`) against the
port's own no-remat path, which the other tests hold to JAX.

At narrow HRNet stages in f64, for each scope and for the ResNet backbone
(one checkpoint over the whole backbone under every scope, as in JAX): the
train forward is bit-identical, the parameter gradients agree within
1e-12 relative, and one forward and backward move the BatchNorm running
statistics and `num_batches_tracked` once, as without remat (the
recompute leaves them alone); the backbone draws no random numbers, so the
checkpoints keep no RNG state. Then one f64 `make_train_step` step of the
full W48 model at 64 px against the same step without remat, and
`cli.train --cpu --remat` with `REMAT_SCOPE: modules`."""

import shutil

import numpy as np
import pytest
import torch

from danet_densepose2smpl_tpu_torch.cli import train as cli_train
from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models import iuv_estimator
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.nn import hrnet, layers
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

torch.set_num_threads(1)
SIZE = 64
QUIET = dict(partdrop_rate=0.0, stn_center_jitter=0.0, stn_scale_jitter=0.0)
# two modules in stages 3 and 4, so 'early' has stage-4 modules to skip
TINY_STAGES = (
    (1, 2, (1, 1), (8, 16)),
    (2, 3, (1, 1, 1), (8, 16, 32)),
    (2, 4, (1, 1, 1, 1), (8, 16, 32, 64)),
)
# the checkpointed blocks of a train forward, by scope
CHECKPOINTS = {
    ("hrnet", "backbone"): ["PoseHighResolutionNet"],
    ("hrnet", "modules"): ["ResLayer"] + ["HRModule"] * 5,
    ("hrnet", "early"): ["ResLayer"] + ["HRModule"] * 3,
    ("resnet", "backbone"): ["PoseResNet"],
    ("resnet", "modules"): ["PoseResNet"],
    ("resnet", "early"): ["PoseResNet"],
}


@pytest.fixture
def recorded(monkeypatch):
    """The class names of the blocks `remat` checkpoints, in call order."""
    calls = []

    def recording(fn, *args):
        calls.append(type(fn).__name__)
        return layers.remat(fn, *args)

    monkeypatch.setattr(hrnet, "remat", recording)
    monkeypatch.setattr(iuv_estimator, "remat", recording)
    monkeypatch.setattr(iuv_estimator, "HRNET_W48_STAGES", TINY_STAGES)
    return calls


def _estimator(backbone, **kw):
    cfg = DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, iuv_regressor=backbone, msres_num_layers=18,
                      **QUIET, **kw)
    est = iuv_estimator.IUVEstimator(cfg)
    torch.manual_seed(0)
    for m in est.modules():     # random BatchNorm statistics, so the running update is visible
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return est.double().train()


def _forward_backward(est, image):
    out = est(image.contiguous(memory_format=torch.channels_last))
    weights = torch.Generator().manual_seed(1)
    loss = sum((v * torch.rand(v.shape, generator=weights, dtype=v.dtype)).sum()
               for k, v in sorted(out.items()) if v.requires_grad)
    loss.backward()
    return out, {n: p.grad for n, p in est.named_parameters() if p.grad is not None}, dict(est.named_buffers())


@pytest.mark.parametrize("backbone,scope", list(CHECKPOINTS), ids=[f"{b}-{s}" for b, s in CHECKPOINTS])
def test_remat_equals_plain_f64(backbone, scope, recorded):
    """Remat's train forward and backward against the same weights without
    remat: outputs bit-equal, gradients 1e-12 relative, BatchNorm buffers
    bit-equal (a second update in the recompute moves every running mean
    and doubles `num_batches_tracked`), the global RNG untouched."""
    plain = _estimator(backbone)
    remat = _estimator(backbone, remat_backbone=True, remat_scope=scope)
    remat.load_state_dict(plain.state_dict())
    image = torch.from_numpy(np.random.RandomState(3).randn(2, 3, SIZE, SIZE))

    want, want_grads, want_bufs = _forward_backward(plain, image)
    assert recorded == []
    rng = torch.get_rng_state()
    got, grads, bufs = _forward_backward(remat, image)
    assert torch.equal(torch.get_rng_state(), rng)
    assert recorded == CHECKPOINTS[backbone, scope]

    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert grads.keys() == want_grads.keys() and len(grads) == len(list(plain.parameters()))
    for n, g in want_grads.items():
        torch.testing.assert_close(grads[n], g, rtol=0, atol=1e-12 * g.abs().max().item() + 1e-300, msg=n)
    tracked = [n for n in want_bufs if n.endswith("num_batches_tracked")]
    assert tracked and all(want_bufs[n].item() == 1 for n in tracked)
    for n, b in want_bufs.items():
        assert torch.equal(bufs[n], b), n

    # eval mode ignores remat
    recorded.clear()
    with torch.no_grad():
        remat.eval()(image.contiguous(memory_format=torch.channels_last))
    assert recorded == []


def test_train_step_remat_modules_f64():
    """One `make_train_step` step of the full W48 DaNet at 64 px, B=2, f64,
    the closed atlas culled, PartDrop and jitter on (the same generator
    seed): with `remat_scope='modules'` against without. Losses rtol 1e-9,
    parameters after Adam within 1e-9 of each tensor's largest entry,
    BatchNorm buffers equal."""
    smpl = synthetic_smpl_model()
    atlas, template = closed_synthetic_atlas(smpl.num_verts)
    renderer = IUVRenderer(atlas, SIZE, SIZE // 4, cull_verts=template)
    assert renderer.cull
    base = Config(danet=DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4))
    raw = synthetic_raw_batch(base, 2, seed=4, num_dp_points=32)
    raw["has_dp"] = np.array([0.0, 1.0], np.float32)
    weights = random_init_(DaNet(base.danet), seed=2).double().state_dict()

    def run(cfg):
        model = DaNet(cfg.danet).double()
        model.load_state_dict(weights)
        state = create_train_state(model, cfg)
        step = make_train_step(model, smpl, cfg, renderer=renderer)
        _, metrics = step(state, batch_to_device(raw, "cpu", torch.float64), torch.Generator().manual_seed(5))
        return metrics, dict(model.named_parameters()), dict(model.named_buffers())

    want, want_params, want_bufs = run(base)
    remat_cfg = Config(danet=DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, remat_backbone=True,
                                         remat_scope="modules"))
    got, params, bufs = run(remat_cfg)
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-9, atol=0, msg=k)
    for n, p in want_params.items():
        torch.testing.assert_close(params[n], p, rtol=0, atol=1e-9 * p.abs().max().item(), msg=n)
    for n, b in want_bufs.items():
        torch.testing.assert_close(bufs[n], b, rtol=1e-9, atol=1e-10, msg=n)
        if n.endswith("num_batches_tracked"):
            assert b.item() == 1, n


def test_cli_train_remat(tmp_path, monkeypatch):
    """`cli.train --cpu --remat` with a YAML of `REMAT_SCOPE: modules`
    trains 2 steps of a narrow HRNet, checkpointing every module."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.setattr(iuv_estimator, "HRNET_W48_STAGES", TINY_STAGES)
    checkpointed = []
    def recording(fn, *args):
        checkpointed.append(type(fn).__name__)
        return layers.remat(fn, *args)

    monkeypatch.setattr(hrnet, "remat", recording)
    yaml = tmp_path / "remat.yaml"
    yaml.write_text("DANET:\n  REMAT_SCOPE: modules\n")
    trainer = cli_train.main(["--cpu", "--remat", "--cfg", str(yaml), "--synthetic-data", "--img_size", "64",
                              "--batch_size", "2", "--num_samples", "4", "--pretr_step", "1", "--num_epochs", "1",
                              "--summary_steps", "1", "--log_dir", str(tmp_path), "--name", "remat"])
    assert trainer.cfg.danet.remat_backbone and trainer.cfg.danet.remat_scope == "modules"
    assert trainer.state.step == 2
    assert checkpointed == (["ResLayer"] + ["HRModule"] * 5) * 2
    shutil.rmtree(tmp_path, ignore_errors=True)     # a checkpoint of the full regressor
