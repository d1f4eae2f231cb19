"""The port's training CLI on the CPU: `python -m
danet_densepose2smpl_tpu_torch.cli.train --cpu --synthetic-data` end to end
at 64 px (metrics, config.json, a checkpoint; a second run on the same
directory resumes) without JAX in the process; --remat trains; without a
card and without --cpu the CLI raises, --data_parallel too; and `cli/common.py`'s asset loading, strict load of
a reference checkpoint and restore of the trainer's checkpoints.

Checkpoints of the full W48 model are ~1.2 GB, so each test removes its
work directory."""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import torch

from danet_densepose2smpl_tpu.cli.common import load_assets as jax_load_assets

from danet_densepose2smpl_tpu_torch.cli import common
from danet_densepose2smpl_tpu_torch.cli import train as cli_train
from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
from danet_densepose2smpl_tpu_torch.core.checkpoint import CheckpointManager, ResumePoint
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.nn.hmr import HMR
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.loader import save_smpl_npz, synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import create_train_state

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = ["--synthetic-data", "--img_size", "64", "--batch_size", "2", "--num_samples", "4", "--pretr_step", "1",
           "--summary_steps", "1"]


@pytest.fixture
def workdir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_train_end_to_end_and_resume(workdir):
    """Two runs of `python -m ...cli.train --cpu` on one --log_dir/--name:
    the first trains 2 steps (pretrain, full) and writes metrics.jsonl,
    config.json and a checkpoint; the second, with --num_epochs 2, resumes
    at its end and trains epoch 1. Neither process imports jax."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {
        "PYTHONPATH": REPO, "TMPDIR": str(workdir), "OMP_NUM_THREADS": "1"}
    code = ("import sys, runpy\n"
            "sys.argv = ['cli.train'] + sys.argv[1:]\n"
            "runpy.run_module('danet_densepose2smpl_tpu_torch.cli.train', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'danet_densepose2smpl_tpu'))\n"
            "assert not bad, bad\n")
    run = str(workdir / "logs" / "run")
    for epochs, out in (("1", "training done at step 2"), ("2", "training done at step 4")):
        proc = subprocess.run([sys.executable, "-c", code, "--cpu", *FIXTURE, "--num_epochs", epochs,
                               "--log_dir", str(workdir / "logs"), "--name", "run"],
                              cwd=str(workdir), env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert out in proc.stdout, proc.stdout
    assert "resumed from step 2 (epoch 1, batch 0)" in proc.stdout
    rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert "smpl_pose" not in rows[0] and all("smpl_pose" in r for r in rows[1:])
    assert all(np.isfinite(r["loss_total"]) for r in rows)
    assert json.load(open(os.path.join(run, "config.json")))["args"]["img_size"] == "64"
    assert CheckpointManager(os.path.join(run, "checkpoints")).steps() == [2, 4]


@pytest.mark.parametrize("flag,error,message", [
    (["--data_parallel"], RuntimeError, "no CUDA device"),
    (["--cpu", "--remat", "--num_epochs", "1", "--cfg", os.path.join(REPO, "configs", "danet_tiny_test.yaml")],
     None, None),
], ids=["data_parallel", "remat"])
def test_cli_unported_options_raise(flag, error, message, workdir, monkeypatch):
    """Both options once raised; both are ported. --remat sets
    `danet.remat_backbone` and trains, here the ResNet-18 config (a small
    checkpoint; `tests/test_torch_remat.py` holds the step to the one
    without). --data_parallel runs in
    `tests/test_torch_parallel.py`: without --cpu and without a card its
    mesh raises, as the CLI does."""
    monkeypatch.setattr("tempfile.tempdir", str(workdir))
    argv = [*FIXTURE, "--log_dir", str(workdir), *flag]
    if error is None:
        trainer = cli_train.main(argv)
        assert trainer.cfg.danet.remat_backbone and trainer.state.step == 2
        return
    with pytest.raises(error, match=message):
        cli_train.main(argv)


def test_cli_train_device_preprocess_and_resume(workdir, monkeypatch):
    """--device_preprocess (item 16; it raised until it was ported): the
    dataset emits raw uint8 frames and no host crop, the step crops them
    on the model's device at the config's 64 px (no host resize), and a
    second run on the same directory resumes at the first one's end."""
    from danet_densepose2smpl_tpu_torch.data import pipeline

    monkeypatch.setattr("tempfile.tempdir", str(workdir))
    sizes = []
    real = pipeline.device_preprocess_train

    def watched(images, *args, **kw):
        out = real(images, *args, **kw)
        sizes.append((images.dtype, tuple(images.shape[1:]), tuple(out.shape[1:])))
        return out

    monkeypatch.setattr("danet_densepose2smpl_tpu_torch.train.step.device_preprocess_train", watched)
    argv = ["--cpu", *FIXTURE, "--log_dir", str(workdir), "--name", "raw", "--device_preprocess"]
    first = cli_train.main(argv + ["--num_epochs", "1"])
    assert first.state.step == 2
    second = cli_train.main(argv + ["--num_epochs", "2"])
    assert tuple(second.resume) == (1, 0, 2) and second.state.step == 4
    assert sizes == [(torch.uint8, (256, 256, 3), (64, 64, 3))] * 4
    rows = [json.loads(line) for line in open(workdir / "raw" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4] and all(np.isfinite(r["loss_total"]) for r in rows)


def test_cli_without_a_card_raises(workdir, monkeypatch):
    """No --cpu and no CUDA device: the CLI refuses before it writes
    anything, and does not train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --cpu"):
        cli_train.main([*FIXTURE, "--log_dir", str(workdir)])
    assert not os.listdir(workdir)


def _args(**kw):
    p = common.add_common_args(argparse.ArgumentParser())
    return p.parse_args([]) if not kw else argparse.Namespace(**{**vars(p.parse_args([])), **kw})


def test_load_assets_matches_jax(tmp_path):
    """From files (an SMPL npz, a UV_Processed.mat, an H36M regressor .npy,
    SPIN mean params) and synthetic: the same arrays as the JAX CLI's."""
    rng = np.random.RandomState(0)
    smpl = synthetic_smpl_model(num_verts=200, seed=1)
    save_smpl_npz(smpl, str(tmp_path / "smpl.npz"))
    scipy.io.savemat(str(tmp_path / "uv.mat"), {
        "All_vertices": np.arange(1, 201, dtype=np.float64)[None], "All_Faces": rng.randint(1, 201, (90, 3)) * 1.0,
        "All_FaceIndices": rng.randint(1, 25, (90, 1)) * 1.0, "U_norm": rng.rand(200, 1), "V_norm": rng.rand(200, 1)})
    np.save(tmp_path / "jreg.npy", rng.rand(17, 200))
    np.savez(tmp_path / "mean.npz", pose=rng.randn(144), shape=rng.randn(10), cam=rng.randn(3))
    files = dict(smpl_model=str(tmp_path / "smpl.npz"), uv_atlas=str(tmp_path / "uv.mat"),
                 j_regressor_h36m=str(tmp_path / "jreg.npy"), smpl_mean_params=str(tmp_path / "mean.npz"))
    for kw in (files, dict(synthetic_assets=True, num_verts=150, seed=3)):
        ours, theirs = common.load_assets(_args(**kw)), jax_load_assets(_args(**kw))
        assert len(ours) == len(theirs) == 6
        for a, b in zip(ours, theirs):
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_build_model_loads_reference_and_trainer_checkpoints(workdir, capsys):
    """--torch_checkpoint: a reference-style file ({'model': ...},
    DataParallel 'module.' prefixes, one key the port lacks) loads
    strictly and reports the extra key; a file missing a key raises.
    --checkpoint: the trainer's checkpoint directory restores. --regressor
    hmr builds the HMR baseline and loads a reference SPIN file, whose
    `init_*` mean-parameter buffers it reports unused."""
    cfg = Config(danet=DaNetConfig(img_size=64, heatmap_size=16))
    src = random_init_(DaNet(cfg.danet), seed=5)
    sd = {"module." + k: v for k, v in src.state_dict().items()} | {"module.extra.weight": torch.zeros(1)}
    torch.save({"model": sd}, workdir / "ref.pt")
    model = common.build_model_and_params(_args(torch_checkpoint=str(workdir / "ref.pt")), cfg, "cpu")
    assert not model.training and "extra.weight" in capsys.readouterr().out
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    del sd["module.iuv2smpl.smpl_para_Outs.edge_importance"]
    torch.save({"model": sd}, workdir / "partial.pt")
    with pytest.raises(KeyError, match="edge_importance"):
        common.build_model_and_params(_args(torch_checkpoint=str(workdir / "partial.pt")), cfg, "cpu")

    CheckpointManager(str(workdir / "ckpt")).save(create_train_state(src, cfg), ResumePoint(0, 1, 1))
    model = common.build_model_and_params(_args(checkpoint=str(workdir / "ckpt"), seed=9), cfg, "cpu", train=True)
    assert model.training
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    hmr = random_init_(HMR(), seed=5)
    sd = {"module." + k: v for k, v in hmr.state_dict().items()} | {"module.init_pose": torch.zeros(1, 144)}
    torch.save({"model": sd}, workdir / "hmr.pt")
    model = common.build_model_and_params(_args(regressor="hmr", torch_checkpoint=str(workdir / "hmr.pt")), cfg, "cpu")
    assert isinstance(model, HMR) and not model.training
    assert "1 keys of the file unused, e.g. ['init_pose']" in capsys.readouterr().out
    for k, v in hmr.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
