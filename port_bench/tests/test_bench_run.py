"""Whole runs of the cells at a CPU size (`tiny.py`), the harness's look
for a card skipped: the port agrees with the reference; the last line
carries only the contract's keys, the checks last; with the timed path
broken underneath, or the reference in the port's place a precision
lower, `correct` comes out false. On the card, at the cells' own sizes
and limits: the TF32 control of the fp32 cells, the fp8 control of the
bf16 cell, and the serve faults in the serve cells."""

import json

import pytest
import torch

import run
from port_bench.harness.faults import FAULTS
from port_bench.tests.tiny import SEED, TINY_LIMITS, tiny

CPU = torch.device("cpu")
CONTRACT = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
SERVE_FP32 = ["w48-serve-fp32-b64", "r50-serve-fp32-b64"]
TRAIN = "w48-train-bf16-b128"


def kind(workload):
    return "train" if workload == TRAIN else "serve"


def execute(workload, trace=False, seed=SEED, **kw):
    return run.execute(workload, seed, 0.5, trace, CPU, tiny(workload), limits=TINY_LIMITS[workload],
                       **kw)["result"]


@pytest.mark.parametrize("workload", SERVE_FP32 + [TRAIN])
def test_port_agrees_with_the_reference(workload):
    result = execute(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    result = execute("w48-serve-fp32-b64", trace)
    assert set(result) <= CONTRACT and list(result)[-1] == "checks"
    line = json.loads(json.dumps(result))
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        assert {"dispatch_ms.serve", "mfu.serve", "idle.serve"} <= names and "breakdown" in line
        assert set(line["device"]) >= {"busy_s", "window_s"}
    else:
        assert names == {"setup_s", "serve_imgs_per_s", "serve_p95_ms"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in SERVE_FP32 for f in FAULTS["serve"]]
                         + [(TRAIN, f) for f in FAULTS["train"]])
def test_a_planted_fault_is_not_correct(workload, fault):
    result = execute(workload, wrap=FAULTS[kind(workload)][fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", SERVE_FP32 + [TRAIN])
def test_fp8_control_is_not_correct(workload):
    result = execute(workload, server="fp8")
    assert not result["correct"], result["checks"]


CARD_CASES = [("w48-serve-fp32-b64", "tf32"), ("r50-serve-fp32-b64", "tf32"), ("w48-serve-bf16-b256", "fp8")]
# every serve fault in every serve cell but one altered answer in the bf16
# cell, whose sound answers leave up to a fifth of the fp32 reference's
# variation from image to image unexplained: one among 768 moves no number
# there (PERF.md)
CARD_CASES += [(w, f"fault:{f}") for w, _ in CARD_CASES for f in FAULTS["serve"]
               if (w, f) != ("w48-serve-bf16-b256", "answer")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,lower", CARD_CASES)
def test_control_is_not_correct_on_the_card(workload, lower):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' limits hold at their sizes on the card")
    dev = torch.device("cuda", 0)
    small = {"traffic": {"check_requests": 1}}
    kw = ({"wrap": FAULTS["serve"][lower.split(":")[1]]} if lower.startswith("fault:")
          else {"server": lower})
    ok = run.execute(workload, SEED, 1.0, False, dev, small)["result"]
    broken = run.execute(workload, SEED, 1.0, False, dev, small, **kw)["result"]
    assert ok["correct"] and not broken["correct"], (ok["checks"], broken["checks"])
