"""The harness split into what every serve cell does and what one model
family does (`port_bench/families/<family>.py`).

The pin: at the CPU size of `tiny.py`, each DaNet cell draws the same
weights and images, counts the same FLOPs and K1 call, and reads the same
numbers as the harness did before the split. The readings are rounding-
level gaps between the port and the reference, so they are pinned at one
CPU thread, where they repeat exactly from run to run.

HMR 2.0's cell, cut to the tiny size of `test_bench_hmr2.py`, is pinned
alike in its bf16: so the family interface's optional attributes, absent
from both shipped families, leave every reading where it was.

A second family, the toy under `tests/families/` (not DaNet: a
transformer over a 64x48 image), runs through `run.execute` with the
families directory pointed at it: its sound runs are correct, its planted
faults are not, its traced run reads `mfu.serve` and no `k1_roofline`;
its LayerNorms and free parameters are drawn, and one left undrawn
raises. `spec.load_cell` refuses an unknown family and a family without
a harness for the cell's traffic kind.

A third, `toy_people.py`, gives every optional attribute: three people an
image picked on the device, a 293-column `para` in four blocks, a body
model of its own, its score map compared, a reference conditioned on the
port's picks. Its sound runs are correct in fp32 and bf16; a scaled tail
of `para`, two people swapped, the next-best pick and the expression left
out of the vertices are not, nor its fp8 control; blocks that do not tile
`para`, or rows that do not match the answers, raise."""

import hashlib
import json
import math
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


HMR2_PIN = {
    "state_dict": "b86886e94e49eb17ba7d076c68c326f47281cf250fc6a6148204457724a4cda4",
    "first_batch": "3ad3831806330852a449765da773698d273af7a9f6c82a6764234e9029f97d47",
    "flops_per_image": 18285380.0,
    "k1_call": None,
    "readings": {"para": 0.06073949044691251, "para_nearest": 0.022914613679849597, "para_not_nearest": 0.0,
                 "para_unexplained": 0.0005890032091269977, "para_median": 0.03795343630751671,
                 "para_p10": 0.036372988805565214, "vertices": 0.04026545828512662,
                 "vertices_nearest": 0.019438718284492396, "vertices_not_nearest": 0.0,
                 "vertices_unexplained": 0.00044785506886919365, "joints": 0.04464310657913116,
                 "joints_nearest": 0.020345889083550284, "joints_not_nearest": 0.0,
                 "joints_unexplained": 0.0005169418715735314},
}


def test_hmr2_cell_reads_as_pinned(one_thread):
    """HMR 2.0's cell cut to `test_bench_hmr2.py`'s tiny size, in its bf16:
    the weights, the first batch, the counts and every reading of a run
    whose window holds one request."""
    from port_bench.tests.test_bench_hmr2 import CELL, TINY_HMR2

    cell = spec.load_cell(CELL)
    cell.traffic.update(TINY_SERVE)
    _, ref_cfg = cell.family.configs(cell.config, cell.traffic, TINY_HMR2)
    got = {"state_dict": digest(cell.family.reference_model(ref_cfg, SEED, CPU).state_dict()),
           "first_batch": digest({"pool": serve.make_pool(cell.traffic, cell.family.image_hw(ref_cfg), SEED,
                                                          CPU)[0]})}
    out = serve.run(cell, SEED, 0.0, False, CPU, time.perf_counter(), overrides=TINY_HMR2)
    got["flops_per_image"] = out["ctx"]["flops_per_image"]
    got["k1_call"] = out["ctx"].get("k1_call")
    got["readings"] = out["readings"]
    assert got == HMR2_PIN


TOY_FAMILIES = Path(__file__).resolve().parent / "families"
TOY = "toy-serve-fp32"
TOY_CONFIG = {"name": "toy", "family": "toy",
              "toy": {"img_hw": [64, 48], "patch": 16, "width": 32, "heads": 2, "mlp": 64, "blocks": 2}}
# sound runs read 0 on the CPU (Predictor serves the reference's own module
# in fp32); the planted faults' nearest ratios read 7e6 or more
TOY_LIMITS = {"para_median": 1e-4, "para_p10": 1e-4, **NEAREST}
SERVE_METRICS_CELL = "w48-serve-fp32-b64"


def toy_benchmark(tmp_path, monkeypatch, family="toy", traffic="serve_closed_b64_fp32", config=TOY_CONFIG,
                  cell=TOY, limits=TOY_LIMITS):
    """BENCHMARK.json with the toy cell beside the others, reporting what
    the fp32 serve cells report; its configuration and limits in
    `tmp_path`, the families directory the toy's."""
    bench = json.loads(spec.BENCHMARK_JSON.read_text())
    path = tmp_path / "toy.json"
    path.write_text(json.dumps({**config, "family": family}))
    bench["configs"].append({"name": "toy", "source": "tests", "file": str(path), "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": cell, "config": "toy", "traffic": traffic, "chips": 1, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if SERVE_METRICS_CELL in m.get("workloads", ()):
            m["workloads"].append(cell)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    (tmp_path / "limits").mkdir()
    (tmp_path / "limits" / f"{cell}.json").write_text(json.dumps(limits))
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


# A toy with several people an image and a body model of its own
# (`tests/families/toy_people.py`), through the family interface's
# optional attributes: its `para` of 293 columns in four blocks, K = 3
# answers an image, its body model, its score map compared, its reference
# conditioned on the port's picks.
PEOPLE_CONFIG = {"name": "toy", "toy_people": {"img_hw": [64, 48], "patch": 8, "width": 32, "heads": 2, "mlp": 64,
                                               "blocks": 2, "people": 3, "vertices": 200}}
# Sound fp32 runs read 0 (the nearest ratios 2.5e-6-4.3e-6, cdist's
# rounding), so 1e-3, and 0.01 the ratios. bf16 over 9 seeds reads up to:
# para 0.181, vertices 0.135, joints 0.136, scores 0.030, pick_shortfall
# 0.030, the nearest ratios 0.313, the unexplained shares 3.1e-4; its fp8
# control scores 0.19-0.32, pick_shortfall 0.24-0.82, the unexplained
# shares 4.3e-3 or more.
PEOPLE_LIMITS = {
    "fp32": {"para": 1e-3, "vertices": 1e-3, "joints": 1e-3, "scores": 1e-3, "pick_shortfall": 1e-3,
             "para_nearest": 0.01, "vertices_nearest": 0.01, "joints_nearest": 0.01},
    "bf16": {"para": 0.5, "vertices": 0.5, "joints": 0.5, "scores": 0.1, "pick_shortfall": 0.1,
             "para_nearest": 1.0, "vertices_nearest": 1.0, "joints_nearest": 1.0, "para_unexplained": 2e-3,
             "vertices_unexplained": 2e-3, "joints_unexplained": 2e-3},
}
PEOPLE_TRAFFIC = {"fp32": "serve_closed_b64_fp32", "bf16": "serve_closed_b256_bf16"}


def people_benchmark(tmp_path, monkeypatch, precision="fp32"):
    cell = f"toy-people-serve-{precision}"
    toy_benchmark(tmp_path, monkeypatch, "toy_people", PEOPLE_TRAFFIC[precision], PEOPLE_CONFIG, cell,
                  PEOPLE_LIMITS[precision])
    return cell


def execute_people(cell, **kw):
    return run.execute(cell, SEED, 0.5, False, CPU, {"traffic": TINY_SERVE}, **kw)


def scale_para_tail(predict):
    """Columns 229-292 of `para` alone scaled by 1.01."""
    def wrapped(images):
        out = dict(predict(images))
        out["para"] = torch.cat([out["para"][:, :229], out["para"][:, 229:] * 1.01], dim=1)
        return out
    return wrapped


def swap_people(predict):
    """The first image's first two people's answers swapped, their picks
    left as they were."""
    def wrapped(images):
        out = dict(predict(images))
        for k in ("para", "vertices", "joints"):
            out[k] = out[k][[1, 0, *range(2, out[k].shape[0])]]
        return out
    return wrapped


def next_pick(server):
    """The (K+1)-th best token served in place of the K-th in the first
    image of each request."""
    def pick(scores, k):
        chosen = torch.topk(scores, k + 1, dim=1).indices
        chosen[0, k - 1] = chosen[0, k]
        return chosen[:, :k]

    server.pick = pick
    return server


def no_expression(server):
    """The expression left out of the vertices and joints."""
    server.expression = False
    return server


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_toy_people_agree_with_their_reference(tmp_path, monkeypatch, one_thread, precision):
    cell = people_benchmark(tmp_path, monkeypatch, precision)
    out = execute_people(cell)
    result = out["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and set(result["checks"]) == set(PEOPLE_LIMITS[precision])
    assert {"scores", "scores_nearest", "pick_shortfall"} <= set(out["readings"])


@pytest.mark.parametrize("fault, caught_by", [(scale_para_tail, "para"), (swap_people, "para_nearest"),
                                              (next_pick, "pick_shortfall"), (no_expression, "vertices")])
def test_toy_people_planted_fault_is_not_correct(tmp_path, monkeypatch, one_thread, fault, caught_by):
    cell = people_benchmark(tmp_path, monkeypatch)
    result = execute_people(cell, wrap=fault)["result"]
    assert not result["correct"], result["checks"]
    assert result["checks"][caught_by]["value"] > result["checks"][caught_by]["limit"], result["checks"]


def test_toy_people_fp8_control_is_not_correct(tmp_path, monkeypatch, one_thread):
    """The control picks its own people, and the fp32 reference answers for
    those: it reads a score map and picks far from the reference's."""
    cell = people_benchmark(tmp_path, monkeypatch, "bf16")
    checks = execute_people(cell, server="fp8")["result"]["checks"]
    assert checks["scores"]["value"] > checks["scores"]["limit"], checks
    assert math.isfinite(checks["pick_shortfall"]["value"]), checks


def test_fixed_blocks_leave_the_tail_of_a_wider_para_unread(one_thread):
    """`PARA_BLOCKS` reads a gap of 0 where columns 229-292 alone are
    scaled by 1.01; the toy's own blocks read it over the limit."""
    from port_bench.tests.families import toy_people

    cfg, _ = toy_people.configs(PEOPLE_CONFIG, {})
    model = toy_people.reference_model(cfg, SEED, CPU)
    with torch.no_grad():
        ref = model(torch.randn(4, 64, 48, 3, generator=torch.Generator().manual_seed(SEED)))["para"]
    got = scale_para_tail(lambda images: {"para": ref})(None)["para"]
    assert ref.shape[1] == toy_people.PARA == 293
    assert serve.image_gaps(got, ref, serve.PARA_BLOCKS).max().item() == 0.0
    assert serve.image_gaps(got, ref, toy_people.para_blocks(cfg)).max().item() > PEOPLE_LIMITS["fp32"]["para"]


@pytest.mark.parametrize("blocks, fault", [
    (((0, 3), (3, 13), (14, 293)), "column 13 is left out"),
    (((0, 3), (3, 13), (13, 229)), "column 229 is left out"),
    (((0, 3), (2, 13), (13, 293)), "column 2 is read twice"),
    (((0, 3), (3, 3), (3, 293)), r"block \(3, 3\) is empty"),
    (((0, 3), (3, 13), (13, 300)), "the blocks run past column 292"),
])
def test_blocks_that_do_not_tile_para_raise(tmp_path, monkeypatch, one_thread, blocks, fault):
    cell = people_benchmark(tmp_path, monkeypatch)
    load = spec.load_family

    def with_blocks(name):
        family = load(name)
        family.para_blocks = lambda cfg: blocks
        return family

    monkeypatch.setattr(spec, "load_family", with_blocks)
    with pytest.raises(ValueError, match=f"model family 'toy_people'.*{fault}"):
        execute_people(cell)


def test_answers_that_do_not_match_the_rows_raise(tmp_path, monkeypatch, one_thread):
    cell = people_benchmark(tmp_path, monkeypatch)
    load = spec.load_family

    def two_a_image(name):
        family = load(name)
        family.answers_per_image = lambda cfg: 2
        return family

    monkeypatch.setattr(spec, "load_family", two_a_image)
    with pytest.raises(ValueError, match="model family 'toy_people'.*'para' holds 12 rows for 4 images"):
        execute_people(cell)


@pytest.mark.parametrize("family", ["danet", "hmr2"])
def test_default_blocks_tile_the_shipped_families_para(family):
    """DaNet's and HMR 2.0's `para` (229 columns) in the default blocks;
    a 230th column would go unread and raises."""
    module = spec.load_family(family)
    assert not hasattr(module, "para_blocks")
    assert serve.para_blocks(module, None, 229) == serve.PARA_BLOCKS
    with pytest.raises(ValueError, match=f"'{family}'.*column 229 is left out"):
        serve.para_blocks(module, None, 230)
