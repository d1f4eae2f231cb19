"""The port's training loop on the CPU: `FitsDict` against the JAX package,
the torch checkpoint round trip, the `Trainer` (two-stage schedule, metric
rows, checkpoints, and a mid-epoch resume bit-identical to an
uninterrupted run), and the Trainer against the JAX `Trainer` on the same
weights and files (per-step `loss_total`, f32, 1e-3 relative).

Full HRNet-W48 DaNet (the width both packages build) at 64 px, B=2, the
synthetic 300-vertex body; checkpoints of the full model are ~1.2 GB, so
each test removes its work directory."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from danet_densepose2smpl_tpu.train.fits_dict import FitsDict as JFitsDict

from danet_densepose2smpl_tpu_torch.cli.train import _Resize
from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig, SolverConfig, TrainConfig
from danet_densepose2smpl_tpu_torch.core.checkpoint import CheckpointManager, MetricLogger, ResumePoint
from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
from danet_densepose2smpl_tpu_torch.data.image_io import read_png
from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.parallel import Mesh
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.fits_dict import FitsDict
from danet_densepose2smpl_tpu_torch.train.step import create_train_state
from danet_densepose2smpl_tpu_torch.train.trainer import Trainer, step_generator

torch.set_num_threads(1)


@pytest.fixture
def workdir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_fits_dict_matches_jax(tmp_path):
    """`from_files` through each link of the fallback chain (h36m .npy,
    SPIN .npz with valid flags, static fits, none: raises), `from_datasets`
    and `lookup` with rotations and flips, against JAX."""
    rng = np.random.RandomState(0)
    final, static = tmp_path / "final", tmp_path / "static"
    final.mkdir()
    static.mkdir()
    np.save(final / "h36m.npy", rng.randn(6, 82))
    np.savez(final / "coco.npz", pose=rng.randn(6, 72), betas=rng.randn(6, 10), valid_fit=rng.rand(6) > 0.5)
    np.save(static / "mpii_fits.npy", rng.randn(6, 82))
    names = ["h36m", "coco", "mpii"]
    ours = FitsDict.from_files(names, str(final), str(static))
    theirs = JFitsDict.from_files(names, str(final), str(static))
    with pytest.raises(FileNotFoundError):
        FitsDict.from_files(["lsp"], str(final))
    batch = (["coco", "h36m", "mpii", "coco"], np.array([0, 5, 2, 3]), np.array([0.0, 12.5, -30.0, 7.0]),
             np.array([0.0, 1.0, 1.0, 0.0]))
    for a, b in zip(ours.lookup(*batch), theirs.lookup(*batch)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    class Rows:
        pose, betas, has_smpl = rng.randn(4, 72), rng.randn(4, 10), np.array([1, 0, 1, 1], np.float32)

    a, b = FitsDict.from_datasets({"h36m": Rows}), JFitsDict.from_datasets({"h36m": Rows})
    np.testing.assert_array_equal(a.fits["h36m"], b.fits["h36m"])
    np.testing.assert_array_equal(a.valid["h36m"], b.valid["h36m"])


def _small_state(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4), torch.nn.Flatten(),
                                torch.nn.LazyLinear(2))
    model(torch.randn(2, 3, 6, 6))
    from danet_densepose2smpl_tpu_torch.train.step import TrainState

    return TrainState(model.train(), torch.optim.Adam(model.parameters(), lr=1e-2), 0)


def test_checkpoint_round_trip(tmp_path):
    """Model (BatchNorm statistics included), Adam moments and step, the
    step count and the resume point come back exactly, into a fresh model;
    the file loads with weights_only=True; an empty directory restores
    None; only the newest max_to_keep files stay; MetricLogger writes one
    JSON row per call."""
    mngr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mngr.latest_step() is None and mngr.restore(_small_state(0)) is None
    state = _small_state(0)
    for step in range(1, 4):
        state.optimizer.zero_grad()
        state.model(torch.randn(2, 3, 6, 6)).square().sum().backward()
        state.optimizer.step()
        state.step = step
        mngr.save(state, ResumePoint(0, step, step))
    assert mngr.steps() == [2, 3] and mngr.latest_step() == 3
    payload = torch.load(os.path.join(mngr.directory, "ckpt_000000003.pt"), weights_only=True)
    assert payload["resume"] == {"epoch": 0, "batch_idx": 3, "step": 3}

    fresh = _small_state(1)
    fresh.model(torch.randn(2, 3, 6, 6))
    restored, resume = mngr.restore(fresh)
    assert resume == ResumePoint(0, 3, 3) and restored.step == 3
    for (n, a), (_, b) in zip(state.model.state_dict().items(), restored.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for k in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    assert restored.optimizer.state_dict()["state"][0]["step"].device.type == "cpu"
    assert mngr.restore(_small_state(2), step=2)[1] == ResumePoint(0, 2, 2)

    log = MetricLogger(str(tmp_path / "m" / "metrics.jsonl"))
    log.log(3, {"loss": torch.tensor(1.5), "name": "skipped"})
    log.close()
    assert [json.loads(line) for line in open(tmp_path / "m" / "metrics.jsonl")] == [{"step": 3, "loss": 1.5}]


def _setup(d, n=8, size=64, **train):
    npz, img_dir = write_synthetic_dataset(str(d / "data"), n=n, with_dp=True)
    ds = NpzDataset(npz, img_dir, name="h36m", heatmap_size=size // 4)
    cfg = Config(danet=DaNetConfig(img_size=size, heatmap_size=size // 4),
                 train=TrainConfig(**{**dict(batch_size=2, pretr_step=1, summary_steps=1, checkpoint_steps=2,
                                             num_epochs=1, vis_interval=1, prefetch_workers=2), **train}))
    smpl = synthetic_smpl_model(num_verts=300, seed=0)
    renderer = IUVRenderer(synthetic_densepose_atlas(smpl, seed=0), orig_size=size, out_size=size // 4)
    return cfg, _Resize(ds, size), smpl, renderer, FitsDict.from_datasets({"h36m": ds})


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_trainer_two_stage_checkpoints_and_bit_identical_resume(workdir):
    """4 steps (1 pretrain, 3 full) with checkpoints every 2; then a run cut
    after step 2 (its time budget) and a fresh Trainer on the same
    directory: it resumes at (epoch 0, batch 2, step 2) and ends with the
    uninterrupted run's parameters, BatchNorm statistics, Adam state and
    losses, bit for bit."""
    cfg, ds, smpl, renderer, fits = _setup(workdir)
    whole = Trainer(cfg, ds, smpl, renderer, fits, str(workdir / "whole"), device="cpu")
    assert whole.train().step == 4
    rows = _rows(workdir / "whole" / "metrics.jsonl")
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert "smpl_pose" not in rows[0] and all("smpl_pose" in r and np.isfinite(r["loss_total"]) for r in rows[1:])
    assert all(r["imgs_per_sec"] > 0 for r in rows)
    assert CheckpointManager(str(workdir / "whole" / "checkpoints")).steps() == [2, 4]
    vis = sorted(os.listdir(workdir / "whole" / "vis"))         # vis_interval=1: a pair of PNGs a step
    assert vis == [f"step_{s:07d}{suffix}.png" for s in (1, 2, 3, 4) for suffix in ("", "_parts")]
    assert all(read_png(str(workdir / "whole" / "vis" / f)).std() > 0 for f in vis)

    expected = whole.state.model.state_dict()
    expected_sq = [s["exp_avg_sq"] for s in whole.state.optimizer.state_dict()["state"].values()]
    del whole                                    # one full-width trainer alive at a time

    first = Trainer(cfg, ds, smpl, renderer, fits, str(workdir / "cut"), device="cpu")
    first._out_of_time = lambda: first.state.step >= 2
    assert first.train().step == 2
    del first
    second = Trainer(cfg, ds, smpl, renderer, fits, str(workdir / "cut"), device="cpu")
    assert second.resume == ResumePoint(0, 2, 2) and second.state.step == 2
    assert second.train().step == 4
    for n, b in second.state.model.state_dict().items():
        assert torch.equal(expected[n], b), n
    got_sq = [s["exp_avg_sq"] for s in second.state.optimizer.state_dict()["state"].values()]
    assert len(got_sq) == len(expected_sq) and all(torch.equal(a, b) for a, b in zip(expected_sq, got_sq))
    del second
    def losses(r):
        return {k: v for k, v in r.items() if k not in ("step_time_s", "imgs_per_sec")}

    assert [losses(r) for r in _rows(workdir / "cut" / "metrics.jsonl")] == [losses(r) for r in rows]
    # a finished run resumes past its end and takes no step
    again = Trainer(cfg, ds, smpl, renderer, fits, str(workdir / "whole"), device="cpu")
    assert again.resume == ResumePoint(1, 0, 4) and again.train().step == 4


def test_step_generator_is_a_function_of_seed_and_step():
    a, b = step_generator(1, 7, "cpu"), step_generator(1, 7, "cpu")
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    assert not torch.equal(torch.rand(5, generator=step_generator(1, 8, "cpu")),
                           torch.rand(5, generator=step_generator(1, 7, "cpu")))


def test_trainer_refuses_a_mesh(workdir):
    """A mesh whose ranks do not divide the global batch is refused before
    any collective (`tests/test_torch_parallel.py` trains on meshes that
    do)."""
    cfg, ds, smpl, renderer, fits = _setup(workdir, n=2)
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        Trainer(cfg, ds, smpl, renderer, fits, str(workdir / "w"), device="cpu",
                mesh=Mesh(0, 3, torch.device("cpu"), "gloo"))


def _f64(tree):
    """Float arrays of a nested item dict as float64."""
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    a = np.asarray(tree) if not isinstance(tree, str) else tree
    return a.astype(np.float64) if isinstance(a, np.ndarray) and a.dtype.kind == "f" else tree


@pytest.mark.slow
def test_trainer_losses_match_jax_trainer(workdir, monkeypatch):
    """The port's Trainer and the JAX Trainer on the same weights (flax
    init, converted by `port.state_dict_from_flax`), the same files, pixels
    and loader seeds, STN jitter and PartDrop off (neither draws noise),
    SGD, both in f64 (the weights, the optimizer state, every float of the
    batches and of the SMPL model): `loss_total` of step 1 (pretrain) and
    step 2 (full) agree within 1e-9 relative, step 3 within 1e-4 (1.4e-5
    measured): after step 2's update, 99% of its loss is the depth
    penalty exp(-20 s) of the random-init camera scale s, which turns a
    1e-9 difference in the step's gradients into 20 x |ds| of the loss.

    Why f64 and SGD: in f32 the full forward's one-hot cleaning of the
    partial IUV stacks flips an argmax on f32 noise (1.1e-3 apart at the
    init weights); and Adam's first update of a parameter is
    lr * g / (|g| + 1e-8), a sign for any gradient above 1e-8, which the
    two frameworks' summation orders give either sign where it is noise,
    so even in f64 step 3 lands 3.8e-3 apart after an Adam step (4e-6 at
    step 2). SGD's update is linear in the gradient. The optimizers
    themselves are held to optax in `test_torch_train.py`."""
    import jax
    import jax.numpy as jnp

    from danet_densepose2smpl_tpu.data.dataset import NpzDataset as JNpzDataset
    from danet_densepose2smpl_tpu.kernels import IUVRenderer as JIUVRenderer
    from danet_densepose2smpl_tpu.smpl.densepose_atlas import synthetic_densepose_atlas as jax_atlas
    from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_smpl
    from danet_densepose2smpl_tpu.train import Trainer as JTrainer
    from danet_densepose2smpl_tpu.train.step import TrainState as JTrainState
    from danet_densepose2smpl_tpu.train.step import make_optimizer as jax_make_optimizer

    from danet_densepose2smpl_tpu_torch import port
    from danet_densepose2smpl_tpu_torch.smpl.loader import to_torch
    from danet_densepose2smpl_tpu_torch.train import trainer as trainer_module
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device

    from test_torch_config import jax_cfg

    class F64(_Resize):
        """The port's `_Resize` (both Trainers see the same pixels; the
        resize is held to cv2 in test_torch_data.py), then f64."""

        def __getitem__(self, i, rng=None):
            return _f64(super().__getitem__(i, rng=rng))

    size = 64
    cfg, ds, smpl, renderer, fits = _setup(workdir, n=6, num_epochs=1, checkpoint_steps=100, vis_interval=0,
                                           prefetch_workers=0)
    cfg = Config(danet=DaNetConfig(img_size=size, heatmap_size=size // 4, stn_center_jitter=0.0,
                                   stn_scale_jitter=0.0, partdrop_rate=0.0), train=cfg.train,
                 solver=SolverConfig(optimizer="sgd"))
    jds = JNpzDataset(str(workdir / "data" / "labels.npz"), str(workdir / "data" / "images"), name="h36m",
                      heatmap_size=size // 4)
    jsmpl = jax_smpl(num_verts=300, seed=0)
    jtrainer = JTrainer(jax_cfg(cfg), F64(jds, size), jsmpl._replace(**{
                            k: np.asarray(v, np.float64) for k, v in jsmpl._asdict().items()
                            if np.asarray(v).dtype.kind == "f"}),
                        JIUVRenderer(jax_atlas(jsmpl, seed=0), orig_size=size, out_size=size // 4),
                        JFitsDict.from_datasets({"h36m": jds}), str(workdir / "jax"))
    # the port starts from the flax init the JAX Trainer made (in f32), both in f64
    init = jax.tree.map(np.asarray, {"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats})
    jax.config.update("jax_enable_x64", True)
    try:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jtrainer.state.params)
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jtrainer.state.batch_stats)
        jtrainer.state = JTrainState(params, stats, jax_make_optimizer(jax_cfg(cfg)).init(params),
                                     jnp.zeros((), jnp.int32))
        jtrainer.train()
    finally:
        jax.config.update("jax_enable_x64", False)

    monkeypatch.setattr(trainer_module, "batch_to_device",
                        lambda batch, device: batch_to_device(batch, device, torch.float64))
    ours = Trainer(cfg, ds, to_torch(smpl, "cpu", torch.float64), renderer, fits, str(workdir / "torch"),
                   device="cpu")
    ours.state.model.load_state_dict(port.state_dict_from_flax(init, cfg.danet))
    ours.state = create_train_state(ours.state.model.double(), cfg)
    ours.train()
    got, want = _rows(workdir / "torch" / "metrics.jsonl"), _rows(workdir / "jax" / "metrics.jsonl")
    assert len(got) == len(want) == 3 and "smpl_pose" not in got[0]
    for g, w, rel in zip(got, want, (1e-9, 1e-9, 1e-4)):
        assert g["loss_total"] == pytest.approx(w["loss_total"], rel=rel), (g["step"], g["loss_total"], w["loss_total"])
