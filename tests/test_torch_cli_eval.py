"""The port's eval entry points against the JAX package's on the CPU:
`python -m danet_densepose2smpl_tpu_torch.cli.eval` (h36m-p2 with and
without --device_preprocess, 3dpw, lsp with and without
--device_preprocess) and `.cli.eval_coco`, each beside the JAX CLI on the
same files: one reference-layout .pt (--torch_checkpoint) and one
dataset of each kind, written once. fp32, a small HRNet (W18, 64 px
config; the datasets crop at 224 px in both packages, as the JAX CLI
does).

Bars: MPJPE and PA-MPJPE per sample within 0.5 mm (README.md's bar for
the port against the reference); the LSP scores and the COCO AP table
within 1e-3. The exact agreement lives in the f64 harness tests
(`tests/test_torch_eval.py`, `test_torch_ingest.py`, `test_torch_coco.py`).
The refusals: no card without --cpu, `cli.eval_coco --regressor hmr`
(the JAX CLI fails there; `cli.eval --regressor hmr` is
`tests/test_torch_archs_train.py`)."""

import re
import shutil

import numpy as np
import pytest
import torch

from danet_densepose2smpl_tpu.cli import eval as jax_eval
from danet_densepose2smpl_tpu.cli import eval_coco as jax_eval_coco

from danet_densepose2smpl_tpu_torch.cli import eval as cli_eval
from danet_densepose2smpl_tpu_torch.cli import eval_coco as cli_eval_coco
from danet_densepose2smpl_tpu_torch.config import load_config
from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.serve import random_init_

torch.set_num_threads(1)
LSP_NAMES = ("Accuracy", "F1", "Parts Accuracy", "Parts F1 (BG)")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config, the checkpoint and the three datasets, shared by every
    run; removed after the module (the checkpoint is ~390 MB)."""
    d = tmp_path_factory.mktemp("cli_eval")
    cfg = d / "small.yaml"
    cfg.write_text("DANET:\n  INIMG_SIZE: 64\n  HEATMAP_SIZE: 16\n  HRNET_WIDTH: 18\n")
    model = random_init_(DaNet(load_config(str(cfg)).danet), seed=11)
    torch.save({"model": {"module." + k: v for k, v in model.state_dict().items()}}, d / "ref.pt")
    pose = write_synthetic_dataset(str(d / "pose"), n=4, seed=1, gendered=True)
    lsp = write_synthetic_dataset(str(d / "lsp"), n=4, seed=2, with_lsp_masks=True)
    coco = write_synthetic_dataset(str(d / "coco"), n=4, seed=3)
    yield {"cfg": str(cfg), "pt": str(d / "ref.pt"), "pose": pose, "lsp": lsp, "coco": coco, "dir": d}
    shutil.rmtree(d, ignore_errors=True)


def _argv(files, data, result=None):
    npz, img_dir = files[data][:2]
    argv = ["--cpu", "--cfg", files["cfg"], "--torch_checkpoint", files["pt"], "--num_verts", "500",
            "--batch_size", "2", "--npz", npz, "--img_dir", img_dir]
    if data == "lsp":
        argv += ["--annot_dir", files["lsp"][2]]
    return argv + (["--result_file", result] if result else [])


def _lsp_lines(out: str) -> dict:
    return {n: float(re.search(rf"^{re.escape(n)}: ([0-9.]+)$", out, re.M).group(1)) for n in LSP_NAMES}


@pytest.mark.parametrize("dataset,raw", [("h36m-p2", False), ("h36m-p2", True), ("3dpw", False)],
                         ids=["h36m-p2", "h36m-p2-device_preprocess", "3dpw"])
def test_cli_eval_pose_matches_jax(dataset, raw, files, capsys):
    """Per-sample MPJPE / PA-MPJPE (the --result_file contents) and the
    printed summary against the JAX CLI's, with the same flags."""
    flags = ["--dataset", dataset, "--log_freq", "1"] + (["--device_preprocess"] if raw else [])
    theirs = str(files["dir"] / f"jax_{dataset}_{raw}.npz")
    jax_eval.main(_argv(files, "pose", theirs) + flags)
    jout = capsys.readouterr().out
    ours = str(files["dir"] / f"port_{dataset}_{raw}.npz")
    res = cli_eval.main(_argv(files, "pose", ours) + flags)["pose"]
    out = capsys.readouterr().out
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a) == sorted(b) == ["mpjpe", "pa_mpjpe"]
    np.testing.assert_array_equal(a["mpjpe"], res.mpjpe)
    for k in a:
        assert a[k].shape == (4,) and np.isfinite(a[k]).all()
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-4, err_msg=k)
    assert f"saved {ours}" in out and out.count("batch ") == jout.count("batch ") == 2
    for line in ("MPJPE", "PA-MPJPE (rec. err)"):
        ours_mm = float(re.search(rf"^{re.escape(line)}: ([0-9.]+) mm$", out, re.M).group(1))
        theirs_mm = float(re.search(rf"^{re.escape(line)}: ([0-9.]+) mm$", jout, re.M).group(1))
        assert abs(ours_mm - theirs_mm) <= 0.5, (line, ours_mm, theirs_mm)
    assert ("per-action PA-MPJPE:" in out) == ("per-action PA-MPJPE:" in jout) == (dataset == "h36m-p2")


def test_cli_eval_lsp_matches_jax(files, capsys):
    """The four "Final Results" lines from the upi-s1h GT PNGs, read as
    cv2 reads them, against the JAX CLI's; then the port's run with
    --device_preprocess (which the JAX CLI's LSP path lacks) against the
    same lines."""
    jax_eval.main(_argv(files, "lsp") + ["--dataset", "lsp"])
    want = _lsp_lines(capsys.readouterr().out)
    for flags in ([], ["--device_preprocess"]):
        got = cli_eval.main(_argv(files, "lsp") + ["--dataset", "lsp"] + flags)["lsp"]
        assert _lsp_lines(capsys.readouterr().out) == pytest.approx(got, abs=1e-6)
        for n in LSP_NAMES:
            assert 0.0 <= got[n] <= 1.0 and abs(got[n] - want[n]) <= 1e-3, (flags, n, got[n], want[n])


def test_cli_eval_coco_matches_jax(files, capsys):
    """The AP table and the --result_file (predictions and stats) against
    the JAX CLI's; both run the model in fp32."""
    theirs, ours = str(files["dir"] / "jax_coco.npz"), str(files["dir"] / "port_coco.npz")
    jax_eval_coco.main(_argv(files, "coco", theirs))
    jout = capsys.readouterr().out
    ap, preds = cli_eval_coco.main(_argv(files, "coco", ours))
    out = capsys.readouterr().out
    table = [line for line in out.splitlines() if line.startswith("|")]
    assert table[:2] == [line for line in jout.splitlines() if line.startswith("|")][:2] and len(table) == 3
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a) == sorted(b) and a["preds"].shape == (4, 17, 3)
    np.testing.assert_array_equal(a["preds"], preds)
    for k in cli_eval_coco.AP_NAMES:
        assert float(a[k]) == ap[k] and (ap[k] == -1.0 or 0.0 <= ap[k] <= 1.0)
        assert abs(ap[k] - float(b[k])) <= 1e-3, (k, ap[k], float(b[k]))


def test_eval_clis_refuse(files, monkeypatch):
    """Without a card and without --cpu both CLIs raise before they build
    anything; `cli.eval_coco --regressor hmr` raises (the HMR baseline runs
    in `cli.eval` only, as in the JAX package, whose COCO CLI fails on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_cpu = [a for a in _argv(files, "pose") if a != "--cpu"]
    for main in (cli_eval.main, cli_eval_coco.main):
        with pytest.raises(RuntimeError, match="pass --cpu"):
            main(no_cpu)
    with pytest.raises(ValueError, match="runs DaNet only"):
        cli_eval_coco.main(_argv(files, "pose") + ["--regressor", "hmr"])
