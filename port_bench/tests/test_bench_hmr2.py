"""The HMR 2.0 cell (`families/hmr2.py`, `configs/hmr2_vitpose_h.json`,
`reference/models/hmr2.py`) through `run.execute` on the CPU, cut to a
tiny size of its own (2 blocks of width 64 with 4 heads, 2 decoder layers
of width 32, a 64x64 crop cut to 64x48), in the cell's bf16: sound runs
are correct; the planted faults and the fp8 control are not; a traced
run reads the cell's metrics (the span readers under a stand-in card,
whose events tick a clock of their own) and not DaNet's; the yardstick's
FLOPs are the hand count; every floating tensor of the model is drawn.
On the card (`cuda` marker), at the cell's own sizes and limits: the
fp8 control and both faults are not correct, the port is."""

import time

import pytest
import torch

import run
from danet_densepose2smpl_tpu_torch.utils import profiling
from port_bench.harness import serve, spec, weights
from port_bench.harness.faults import FAULTS
from port_bench.harness.yardstick import counting_flops
from port_bench.reference.smpl.loader import synthetic_smpl_model, to_torch
from port_bench.reference.smpl.model import smpl_forward
from port_bench.tests.tiny import SEED, TINY_SERVE

CELL = "hmr2-vith-serve-bf16-b256"
CPU = torch.device("cpu")
TINY_HMR2 = dict(image_size=64, embed_dim=64, depth=2, num_heads=4, mlp_dim=256, dec_dim=32,
                 dec_depth=2, dec_heads=2, dec_dim_head=16, dec_mlp_dim=32)
# The cell's limits' numbers, at this size. Sound bf16 runs read
# para_median 0.024-0.025, the nearest ratios 0.022-0.032, the unexplained
# shares 7.6e-5-2.8e-4; the fp8 control para_median 0.43 and unexplained
# shares 0.035-0.041; the faults' nearest ratios 90 or more.
TINY_LIMITS = {"para_median": 0.1, "para_nearest": 1.0, "vertices_nearest": 1.0, "joints_nearest": 1.0,
               "para_unexplained": 1.5e-3, "vertices_unexplained": 1.5e-3, "joints_unexplained": 1.5e-3}
NEW_METRICS = ("vit_ms.serve", "vit_attn_ms.serve", "decoder_ms.serve", "attn_fused_share.serve")


class StandInEvent:
    """A `torch.cuda.Event` on a clock of its own: each `record` 1.5 ms
    after the last."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        StandInEvent.clock += 1.5
        self.at = StandInEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.RECORDER.clear()
    yield
    profiling.RECORDER.clear()
    torch.set_num_threads(threads)


def execute(trace=False, seed=SEED, **kw):
    return run.execute(CELL, seed, 0.5, trace, CPU, {"hmr2": TINY_HMR2, "traffic": TINY_SERVE},
                       limits=TINY_LIMITS, **kw)


@pytest.mark.parametrize("seed", [SEED, 5])
def test_tiny_cell_agrees_with_its_reference(seed):
    result = execute(seed=seed)["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_planted_fault_is_not_correct(fault):
    result = execute(wrap=FAULTS["serve"][fault])["result"]
    assert not result["correct"], result["checks"]


def test_fp8_control_is_not_correct():
    result = execute(server="fp8")["result"]
    assert not result["correct"], result["checks"]


def test_traced_run_reads_the_cell_metrics(monkeypatch):
    """Under a stand-in card the span readers read each request's spans:
    the trunk, the decoder head, the two blocks' attention (summed), the
    waits, and the attention counts (the CPU's plain route, 0%); DaNet's
    K1 roofline and BatchNorm share stay silent."""
    modes = [0]
    monkeypatch.setattr(profiling, "on_card", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    out = execute(trace=True)
    result = out["result"]
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(NEW_METRICS) | {"mfu.serve", "syncs.serve", "smpl_ms.serve", "idle.serve",
                               "dispatch_ms.serve"} <= set(metrics)
    assert "k1_roofline" not in metrics and "bn_fused_share.serve" not in metrics
    assert metrics["attn_fused_share.serve"]["value"] == 0.0 and metrics["syncs.serve"]["value"] == 0
    # a block's attention span opens and closes with nothing inside: one tick
    assert metrics["vit_attn_ms.serve"]["value"] == pytest.approx(2 * 1.5)
    assert metrics["vit_ms.serve"]["value"] > metrics["vit_attn_ms.serve"]["value"]
    assert 0 < metrics["mfu.serve"]["value"] < 100
    items = [it for it in profiling.recorded_items() if it["name"] == "serve.request"]
    assert items and all(it["counts"] == {"attn.plain": 2 + 2 * 2} for it in items)


def test_flops_per_image_are_the_hand_count():
    """12 tokens of width 64, heads of 16; per image: the patch conv
    2·12·64·768 = 1,179,648; per block qkv 294,912, scores and values
    18,432 each, proj 98,304, MLP 2 x 393,216 (1,216,512, twice); the token
    embedding 64; per decoder layer to_qkv 6,144, self scores and values 64
    each, to_out 2,048 twice, to_q 2,048, to_kv 98,304, cross scores and
    values 768 each, FeedForward 4,096 (116,352, twice); the readouts
    10,048; HMR 2.0's 6D reading's dot products 24 x 6: 3,855,632. The
    run's `flops_per_image` adds SMPL's products (the reference's
    `smpl_forward`, counted alone) and counts no part crop."""
    cell = spec.load_cell(CELL)
    cell.traffic.update(TINY_SERVE)
    _, ref_cfg = cell.family.configs(cell.config, cell.traffic, TINY_HMR2)
    model = cell.family.reference_model(ref_cfg, SEED, CPU).eval()
    with torch.no_grad(), counting_flops() as c:
        out = model(torch.zeros(2, 64, 64, 3))
    assert c["flops"] / 2 == 3_855_632 and not c["crops"]
    with torch.no_grad(), counting_flops() as s:
        smpl_forward(to_torch(synthetic_smpl_model(), CPU), out["pred_shape"], out["pred_rotmat"])
    ran = serve.run(cell, SEED, 0.0, False, CPU, time.perf_counter(), overrides=TINY_HMR2)
    assert ran["ctx"]["flops_per_image"] == 3_855_632 + s["flops"] / 2
    assert "k1_call" not in ran["ctx"]


def test_every_floating_tensor_is_drawn():
    """The family's leaves (every LayerNorm, both position tables) and the
    generic rules draw every floating parameter; the mean parameters are
    the head's constants and keep their values; a parameter nothing draws
    raises, named."""
    cell = spec.load_cell(CELL)
    _, ref_cfg = cell.family.configs(cell.config, cell.traffic, TINY_HMR2)
    from port_bench.reference.models.hmr2 import HMR2

    built = HMR2(ref_cfg)
    drawn = cell.family.reference_model(ref_cfg, SEED, CPU)
    before = dict(built.named_parameters())
    for name, p in drawn.named_parameters():
        assert not torch.equal(p, before[name]), name
    for name in ("init_body_pose", "init_betas", "init_cam"):
        assert torch.equal(getattr(drawn.smpl_head, name), getattr(built.smpl_head, name))
    own = {id(t) for t, _, _, _ in cell.family.leaves(drawn)}
    assert id(drawn.backbone.pos_embed) in own and id(drawn.backbone.blocks[1].norm2.weight) in own
    built.smpl_head.extra = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="smpl_head.extra"):
        weights.fill_weights_(built, SEED, cell.family.leaves(built), cell.family.output_layers,
                              cell.family.left_to_construction)


@pytest.mark.cuda
@pytest.mark.parametrize("lower", ["fp8", "fault:answer", "fault:half"])
def test_limits_hold_on_the_card(lower):
    """At the cell's own sizes and limits on the card (one checked
    request): the port is correct, the fp8 control and each fault not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's limits hold at its sizes on the card")
    dev = torch.device("cuda", 0)
    small = {"traffic": {"check_requests": 1}}
    kw = {"wrap": FAULTS["serve"][lower.split(":")[1]]} if lower.startswith("fault:") else {"server": lower}
    ok = run.execute(CELL, SEED, 1.0, False, dev, small)["result"]
    broken = run.execute(CELL, SEED, 1.0, False, dev, small, **kw)["result"]
    assert ok["correct"] and not broken["correct"], (ok["checks"], broken["checks"])
