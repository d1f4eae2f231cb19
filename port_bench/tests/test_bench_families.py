"""The harness split into what every serve cell does and what one model
family does (`port_bench/families/<family>.py`).

The pin: at the CPU size of `tiny.py`, each DaNet cell draws the same
weights and images, counts the same FLOPs and K1 call, and reads the same
numbers as the harness did before the split. The readings are rounding-
level gaps between the port and the reference, so they are pinned at one
CPU thread, where they repeat exactly from run to run.

A second family, the toy under `tests/families/` (not DaNet: a
transformer over a 64x48 image), runs through `run.execute` with the
families directory pointed at it: its sound runs are correct, its planted
faults are not, its traced run reads `mfu.serve` and no `k1_roofline`;
its LayerNorms and free parameters are drawn, and one left undrawn
raises. `spec.load_cell` refuses an unknown family and a family without
a harness for the cell's traffic kind."""

import hashlib
import json
import time
from pathlib import Path

import pytest
import torch

import run
from port_bench.harness import serve, spec, train, weights
from port_bench.harness.faults import FAULTS
from port_bench.reference import config as ref_config
from port_bench.reference.smpl.loader import synthetic_smpl_model
from port_bench.tests.tiny import NEAREST, SEED, TINY_SERVE, tiny

CPU = torch.device("cpu")

SERVE_PIN = {
    "state_dict": "99cd1a82a76bed56f692201461088f0729e511ffa463e32fe8f5dd290d3c9883",
    "first_batch": "5504947e173fa5478356880ba1be7c88866941043b7f3a5f376301096e66d3b6",
    "flops_per_image": 2395222580.0,
    "k1_call": (4, 16, 16, 256, 16, 24, 3072, 3072),
    "readings": {"para": 7.091226262120088e-06, "para_nearest": 3.947427145440139e-06, "para_not_nearest": 0.0,
                 "para_unexplained": 1.64624311861925e-11, "para_median": 3.151656116497817e-06,
                 "para_p10": 2.32434638591714e-06, "vertices": 5.421298307698363e-05,
                 "vertices_nearest": 0.00015800559417212927, "vertices_not_nearest": 0.0,
                 "vertices_unexplained": 0.0, "joints": 1.6078524943258886e-05,
                 "joints_nearest": 0.00013579883292864358, "joints_not_nearest": 0.0, "joints_unexplained": 0.0},
}
# the two serve cells cut to `tiny.py`'s size are one model (ResNet-18 at 64 px)
PINNED = {
    "w48-serve-fp32-b64": SERVE_PIN,
    "r50-serve-fp32-b64": SERVE_PIN,
    "w48-train-bf16-b128": {
        "state_dict": "99cd1a82a76bed56f692201461088f0729e511ffa463e32fe8f5dd290d3c9883",
        "first_batch": "0224256f19acfb80bd40e3a4b3fb238ee18d210edc61ef08f479a80dce927599",
        "flops_per_image": 12202996128.0,
        "k1_call": None,
        "readings": {"loss": 0.005511551239023394, "loss_iuv1": 0.0, "grad_median": 8.824577715735572e-07,
                     "change": 0.099397278849878, "change_median": 0.009295297737161166},
    },
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def digest(tree) -> str:
    """sha256 over a (nested) dict of tensors: each key, dtype, shape and bytes."""
    h = hashlib.sha256()
    tensors = _flat(tree)
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous()
        h.update(f"{k}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("workload", list(PINNED))
def test_danet_cells_read_as_pinned(workload, one_thread):
    """Weights, the first batch, the counts and every reading of a run
    whose window holds one request (serving) or none (training: the three
    checked steps)."""
    small = tiny(workload)
    cell = spec.load_cell(workload)
    cell.traffic.update(small["traffic"])
    ref_cfg = spec.build_config(ref_config, cell.config, cell.traffic, small["danet"])
    pin = PINNED[workload]
    assert digest(train.reference_model(ref_cfg, SEED, CPU).state_dict()) == pin["state_dict"]
    if cell.traffic["kind"] == "train_steps":
        first = train.make_batches(ref_cfg, cell.traffic, SEED, CPU, synthetic_smpl_model())[0]
        out = train.run(cell, SEED, 0.0, False, CPU, time.perf_counter(), overrides=small["danet"])
    else:
        first = {"pool": serve.make_pool(cell.traffic, ref_cfg.danet.img_size, SEED, CPU)[0]}
        out = serve.run(cell, SEED, 0.0, False, CPU, time.perf_counter(), overrides=small["danet"])
    assert digest(first) == pin["first_batch"]
    assert out["ctx"]["flops_per_image"] == pin["flops_per_image"]
    k1 = out["ctx"].get("k1_call")
    assert (tuple(k1) if k1 is not None else None) == pin["k1_call"]
    assert out["readings"] == pin["readings"]


TOY_FAMILIES = Path(__file__).resolve().parent / "families"
TOY = "toy-serve-fp32"
TOY_CONFIG = {"name": "toy", "family": "toy",
              "toy": {"img_hw": [64, 48], "patch": 16, "width": 32, "heads": 2, "mlp": 64, "blocks": 2}}
# sound runs read 0 on the CPU (Predictor serves the reference's own module
# in fp32); the planted faults' nearest ratios read 7e6 or more
TOY_LIMITS = {"para_median": 1e-4, "para_p10": 1e-4, **NEAREST}
SERVE_METRICS_CELL = "w48-serve-fp32-b64"


def toy_benchmark(tmp_path, monkeypatch, family="toy", traffic="serve_closed_b64_fp32"):
    """BENCHMARK.json with the toy cell beside the others, reporting what
    the fp32 serve cells report; its configuration and limits in
    `tmp_path`, the families directory the toy's."""
    bench = json.loads(spec.BENCHMARK_JSON.read_text())
    config = tmp_path / "toy.json"
    config.write_text(json.dumps({**TOY_CONFIG, "family": family}))
    bench["configs"].append({"name": "toy", "source": "tests", "file": str(config), "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": TOY, "config": "toy", "traffic": traffic, "chips": 1, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if SERVE_METRICS_CELL in m.get("workloads", ()):
            m["workloads"].append(TOY)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    (tmp_path / "limits").mkdir()
    (tmp_path / "limits" / f"{TOY}.json").write_text(json.dumps(TOY_LIMITS))
    monkeypatch.setattr(spec, "BENCHMARK_JSON", path)
    monkeypatch.setattr(spec, "LIMITS_DIR", tmp_path / "limits")
    monkeypatch.setattr(spec, "FAMILIES_DIR", TOY_FAMILIES)


def execute_toy(trace=False, **kw):
    return run.execute(TOY, SEED, 0.5, trace, CPU, {"traffic": TINY_SERVE}, **kw)["result"]


def test_toy_family_agrees_with_its_reference(tmp_path, monkeypatch):
    toy_benchmark(tmp_path, monkeypatch)
    result = execute_toy()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and set(result["checks"]) == set(TOY_LIMITS)


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_toy_family_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    toy_benchmark(tmp_path, monkeypatch)
    result = execute_toy(wrap=FAULTS["serve"][fault])
    assert not result["correct"], result["checks"]


def test_toy_family_traced_reads_mfu_and_no_k1(tmp_path, monkeypatch):
    toy_benchmark(tmp_path, monkeypatch)
    result = execute_toy(trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["mfu.serve"]["value"] > 0
    assert "k1_roofline" not in result["metrics"]


def test_toy_family_draws_its_own_leaves(tmp_path, monkeypatch):
    """Every tensor of the toy's `leaves` (LayerNorms, the positional
    embedding, the query token, the attention's packed input projection)
    moves off what its constructor made; a parameter that nothing draws
    raises, named."""
    toy_benchmark(tmp_path, monkeypatch)
    toy = spec.load_family("toy")
    cfg, _ = toy.configs(TOY_CONFIG, {})
    built = toy.ToyTransformer(cfg)
    drawn = toy.reference_model(cfg, SEED, CPU)
    names = {id(t): n for n, t in drawn.named_parameters()}
    own = [names[id(t)] for t, _, _, _ in toy.leaves(drawn)]
    assert {"pos", "query", "norm.weight", "blocks.0.ln1.bias", "cross.in_proj_weight"} <= set(own)
    before = dict(built.named_parameters())
    for name in own:
        assert not torch.equal(dict(drawn.named_parameters())[name], before[name]), name
    built.extra = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="extra"):
        weights.fill_weights_(built, SEED, toy.leaves(built), toy.output_layers, toy.left_to_construction)


def test_load_cell_refuses_an_unknown_family(tmp_path, monkeypatch):
    toy_benchmark(tmp_path, monkeypatch, family="nonesuch")
    monkeypatch.setattr(spec, "FAMILIES_DIR", spec.BENCH_DIR / "families")
    with pytest.raises(FileNotFoundError, match=r"nonesuch.*danet\.py"):
        spec.load_cell(TOY)


def test_load_cell_refuses_a_family_without_the_traffic_kind(tmp_path, monkeypatch):
    toy_benchmark(tmp_path, monkeypatch, traffic="train_raw_b128_bf16")
    with pytest.raises(ValueError, match=r"'toy'.*'train_steps'"):
        spec.load_cell(TOY)


def test_toy_flops_count_the_attention(tmp_path, monkeypatch):
    """The yardstick counts a plain reference's attention matmuls: the
    toy's FLOPs an image by hand, 12 tokens of width 32 (patch conv
    589,824; per block qkv 73,728, scores and values 9,216 each, proj
    24,576, MLP 98,304; cross-attention 54,784; head 10,048)."""
    from port_bench.harness.yardstick import counting_flops

    toy_benchmark(tmp_path, monkeypatch)
    toy = spec.load_family("toy")
    cfg, _ = toy.configs(TOY_CONFIG, {})
    model = toy.reference_model(cfg, SEED, CPU)
    with torch.no_grad(), counting_flops() as c:
        model(torch.zeros(2, 64, 48, 3))
    assert c["flops"] / 2 == 589_824 + 2 * (73_728 + 2 * 9_216 + 24_576 + 98_304) + 54_784 + 10_048
