"""The port's checkpoint preflight (`port.preflight_report`, `cli/port.py`)
against the JAX package's (`port/preflight.py`, `cli/port.py`).

The port's manifest (its own model's state_dict on the meta device, the
ignorable keys left out) equals JAX's `expected_torch_shapes` for the
default DaNet and for HMR (JAX's shapes by `jax.eval_shape`: nothing is
compiled). On synthetic .pt files written from a seeded port model (a
ResNet-18 DaNet: intact; a key dropped; a tensor reshaped; an extra key)
both CLIs give the same exit code and the same report categories. The
'lstm' refiner's LSTM biases differ by design (two per direction here,
their sum in JAX): the verdicts still agree, GO on an intact file and
NO-GO on one that lacks a `bias_hh`."""

import json
import shutil

import pytest
import torch

from danet_densepose2smpl_tpu.cli import port as jax_cli
from danet_densepose2smpl_tpu.core.config import load_config as jax_load_config
from danet_densepose2smpl_tpu.port.danet_map import expected_torch_shapes

from danet_densepose2smpl_tpu_torch import port
from danet_densepose2smpl_tpu_torch.cli import port as cli
from danet_densepose2smpl_tpu_torch.config import DaNetConfig, load_config
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.serve import random_init_

torch.set_num_threads(1)
SMALL_YAML = "DANET:\n  IUV_REGRESSOR: resnet\n  MSRES_NUM_LAYERS: 18\n"


@pytest.fixture
def workdir(tmp_path):
    """tmp_path, removed after the test (the .pt files are ~200 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


class _Args:
    def __init__(self, regressor):
        self.regressor = regressor


@pytest.mark.parametrize("regressor", ["danet", "hmr"])
def test_manifest_equals_jax(regressor, tmp_path):
    """The default config's manifest (W48 'gcn' DaNet, or HMR): the same
    keys at the same shapes as JAX's rule map inverted through its flax
    shapes, and the port's CLI writes it."""
    cfg = jax_load_config(None)
    args = _Args(regressor)
    theirs = expected_torch_shapes(jax_cli._rules(args, cfg), jax_cli._shape_template(args, cfg))
    ours = port.expected_shapes(port.preflight_model(DaNetConfig(), regressor))
    assert ours == {k: tuple(v) for k, v in theirs.items()}
    out = tmp_path / "manifest.json"
    assert cli.main(["--manifest", str(out), "--regressor", regressor]) == 0
    assert json.loads(out.read_text()) == {k: list(v) for k, v in theirs.items()}
    assert all(t.is_meta for t in port.preflight_model(DaNetConfig(), regressor).state_dict().values())


def _categories(report: dict) -> dict:
    """The report's contents that both packages name alike."""
    return {"missing": report["missing_torch_keys"],
            "mismatched": sorted(m["torch_key"] for m in report["shape_mismatches"]),
            "unmapped": report["unmapped_torch_keys"],
            "ignorable": report["unmapped_ignorable"],
            "unfilled": bool(report.get("unfilled_tensors", report.get("unfilled_flax_leaves")))}


def _both(pt, yaml, capsys):
    """(exit code, JSON report) of the port's CLI and of the JAX CLI."""
    out = []
    for main in (cli.main, jax_cli.main):
        code = main(["--check", str(pt), "--cfg", str(yaml), "--json"])
        out.append((code, json.loads(capsys.readouterr().out)))
    return out


def _corrupt(sd: dict, case: str) -> dict:
    sd = dict(sd)
    if case == "dropped":
        del sd["img2iuv.learned_ratio"]
        del sd["iuv2smpl.smpl_para_Outs.body_net.1.running_var"]
    elif case == "reshaped":
        sd["iuv2smpl.smpl_para_Outs.body_net.0.weight"] = torch.zeros(1, 2, 3, 4)
    elif case == "extra":
        sd["totally.foreign.weight"] = torch.zeros(3, 3)
        sd["iuv2smpl.smpl.v_template"] = torch.zeros(10, 3)
    return sd


@pytest.mark.parametrize("case", ["intact", "dropped", "reshaped", "extra"])
def test_cli_verdicts_equal_jax(case, workdir, capsys):
    yaml = workdir / "small.yaml"
    yaml.write_text(SMALL_YAML)
    model = random_init_(DaNet(load_config(str(yaml)).danet), seed=0)
    sd = {"module." + k if case == "intact" else k: v for k, v in _corrupt(model.state_dict(), case).items()}
    pt = workdir / "ckpt.pt"
    torch.save({"model": sd}, pt)
    (ours_code, ours), (theirs_code, theirs) = _both(pt, yaml, capsys)
    assert ours_code == theirs_code == (0 if case == "intact" else 1)
    assert ours["ok"] == theirs["ok"] == (case == "intact")
    assert _categories(ours) == _categories(theirs)
    assert ours["n_torch_keys"] == theirs["n_torch_keys"] == len(sd)
    assert _categories(ours)["ignorable"]     # the BatchNorm counters


@pytest.mark.parametrize("case", ["intact", "bias_hh_dropped"])
def test_lstm_biases_verdicts_agree(case, workdir, capsys):
    """'lstm': the port expects `bias_ih_l0` and `bias_hh_l0` where JAX's
    manifest has their sum `bias_l0`; JAX fuses the file's pair first. Both
    say GO on an intact file and NO-GO on one without a `bias_hh_l0`: the
    port reports it missing, JAX the unfused `bias_ih_l0` unmapped and
    `bias_l0` missing."""
    yaml = workdir / "lstm.yaml"
    yaml.write_text(SMALL_YAML + "  REFINE_STRATEGY: lstm\n")
    model = random_init_(DaNet(load_config(str(yaml)).danet), seed=0)
    sd = model.state_dict()
    key = "iuv2smpl.smpl_para_Outs.limb_lstm.0.0.bias_hh_l0"
    assert key in sd and key.replace("bias_hh", "bias_ih") in sd
    manifest = port.expected_shapes(port.preflight_model(model.cfg))
    assert key in manifest and key.replace("bias_hh_l0", "bias_l0") not in manifest
    if case == "bias_hh_dropped":
        sd = {k: v for k, v in sd.items() if k != key}
    pt = workdir / "ckpt.pt"
    torch.save(sd, pt)
    (ours_code, ours), (theirs_code, theirs) = _both(pt, yaml, capsys)
    assert ours_code == theirs_code == (0 if case == "intact" else 1)
    if case == "bias_hh_dropped":
        assert ours["missing_torch_keys"] == [key] and not ours["unmapped_torch_keys"]
        assert theirs["missing_torch_keys"] == [key.replace("bias_hh_l0", "bias_l0")]
        assert theirs["unmapped_torch_keys"] == [key.replace("bias_hh", "bias_ih")]


def test_cli_port_needs_work_and_touches_no_device(tmp_path):
    """Without --check or --manifest the CLI stops (argparse, exit 2); a
    manifest run builds the model on the meta device and initializes no
    card."""
    with pytest.raises(SystemExit) as stop:
        cli.main([])
    assert stop.value.code == 2
    assert cli.main(["--manifest", str(tmp_path / "m.json")]) == 0
    assert not torch.cuda.is_initialized()
