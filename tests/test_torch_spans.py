"""The port's spans (`utils.profiling.annotate`) and their recorder.

With no profiler recording, a span is a `record_function` range and
nothing else: no item, no CUDA event, the warning hooks untouched. Under
`torch.profiler`, a tiny `Predictor` request and a tiny bf16 training step
on the CPU record their items (`serve.request`, `train.step`) with the
spans nested in them, the store keeps the last `ITEMS_KEPT`, a blocking
wait (a stand-in for PyTorch's sync warning) is charged to the innermost
open span, and with a stand-in card each span reads its device ms from
its two events while the sync debug mode is on. On the card (`cuda`
marker; this file imports no JAX, so it runs there with
`python -m pytest --noconftest -m cuda tests/test_torch_spans.py`): a copy
from pageable memory inside a span raises its count by exactly one.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.serve import Predictor, random_init_
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step
from danet_densepose2smpl_tpu_torch.utils import profiling
from danet_densepose2smpl_tpu_torch.utils.profiling import ITEMS_KEPT, SYNC_WARNING, annotate, recorded_items

torch.set_num_threads(1)
SIZE = 64
TINY = dict(iuv_regressor="resnet", msres_num_layers=18, img_size=SIZE, heatmap_size=SIZE // 4)
REQUEST = [("serve.request", None), ("serve.model", "serve.request"), ("danet.backbone", "serve.model"),
           ("danet.heads", "serve.model"), ("danet.regressor", "serve.model"), ("serve.smpl", "serve.request")]
PHASES = ["train.ingest", "train.prepare_targets", "train.forward", "train.losses", "train.backward",
          "train.optimizer"]


@pytest.fixture(autouse=True)
def empty_store():
    profiling.RECORDER.clear()
    yield
    profiling.RECORDER.clear()


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def structure(item):
    return [(s["name"], s["parent"]) for s in item["spans"]]


@pytest.fixture(scope="module")
def tiny_predictor():
    return Predictor("cpu", torch.float32, DaNetConfig(**TINY), seed=0, smpl=synthetic_smpl_model(500))


def tiny_images():
    return np.random.RandomState(3).rand(2, SIZE, SIZE, 3).astype(np.float32)


class StandInEvent:
    """A `torch.cuda.Event` on a clock of its own: each `record` is 1.5 ms
    after the last."""

    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        StandInEvent.made += 1
        self.at = None

    def record(self):
        StandInEvent.clock += 1.5
        self.at = StandInEvent.clock

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return end.at - self.at


class RecordingRange:
    """A stand-in for `record_function` that logs its uses."""

    log = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        RecordingRange.log.append(("enter", self.name))

    def __exit__(self, *exc):
        RecordingRange.log.append(("exit", self.name))


def test_without_a_profiler_a_span_is_a_record_function(monkeypatch, tiny_predictor):
    """No item, no CUDA event (even where a card is initialised), the
    warning hooks untouched: the `record_function` range alone."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made with no profiler recording")

    monkeypatch.setattr(profiling, "on_card", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(profiling, "record_function", RecordingRange)
    RecordingRange.log = []
    shown, filters = warnings.showwarning, list(warnings.filters)
    with annotate("outer"):
        with annotate("inner"):
            assert warnings.showwarning is shown and warnings.filters == filters
    assert RecordingRange.log == [("enter", "outer"), ("enter", "inner"), ("exit", "inner"), ("exit", "outer")]
    tiny_predictor.predict(tiny_images())
    assert ("enter", "serve.request") in RecordingRange.log and ("enter", "danet.backbone") in RecordingRange.log
    assert recorded_items() == [] and profiling.RECORDER.current() is None


def test_a_request_records_its_spans(tiny_predictor):
    images = tiny_images()
    with profiled() as prof:
        tiny_predictor.predict(images)
        tiny_predictor.predict(images)
    items = recorded_items()
    assert len(items) == 2 and items[1]["id"] == items[0]["id"] + 1
    for item in items:
        assert item["name"] == "serve.request" and structure(item) == REQUEST
        assert item["syncs"] == 0
        assert all(s["device_ms"] is None for s in item["spans"])   # no CUDA events on the CPU
    names = {e.name for e in prof.events()}
    assert {name for name, _ in REQUEST} <= names   # the host ranges stay in the trace
    tiny_predictor.predict(images)                  # the profiler is off again
    assert len(recorded_items()) == 2


def test_a_bf16_train_step_records_its_phases():
    cfg = Config(danet=DaNetConfig(compute_dtype="bfloat16", **TINY))
    rng = np.random.RandomState(8)
    raw = synthetic_raw_batch(cfg, 2, seed=9, num_dp_points=20)
    del raw["img"]
    raw |= {"raw_img": rng.randint(0, 256, (2, 90, 70, 3)).astype(np.uint8),
            "center": np.array([[35.0, 45.0], [30.0, 50.0]], np.float32),
            "scale": np.array([0.3, 0.35], np.float32), "rot_angle": np.array([0.0, 17.0], np.float32),
            "is_flipped": np.array([1.0, 0.0], np.float32),
            "pixel_noise": rng.uniform(0.6, 1.4, (2, 3)).astype(np.float32)}
    smpl = synthetic_smpl_model(500)
    state = create_train_state(random_init_(DaNet(cfg.danet), seed=3), cfg)
    step = make_train_step(state.model, smpl, cfg, renderer=IUVRenderer(synthetic_densepose_atlas(smpl), SIZE, 16))
    with profiled():
        state, metrics = step(state, batch_to_device(raw, "cpu"), torch.Generator().manual_seed(5))
    assert torch.isfinite(metrics["loss_total"])
    (item,) = recorded_items()
    assert item["name"] == "train.step" and item["spans"][0]["parent"] is None
    top = [s["name"] for s in item["spans"] if s["parent"] == "train.step"]
    assert top == PHASES
    inner = [(s["name"], s["parent"]) for s in item["spans"] if s["name"].startswith("danet.")]
    assert inner == [("danet.backbone", "train.forward"), ("danet.heads", "train.forward"),
                     ("danet.regressor", "train.forward")]


def test_the_store_keeps_the_last_items():
    with profiled():
        for _ in range(ITEMS_KEPT + 6):
            with annotate("serve.request"):
                with annotate("serve.model"):
                    pass
    items = recorded_items()
    assert len(items) == ITEMS_KEPT
    ids = [it["id"] for it in items]
    assert ids == list(range(ids[0], ids[0] + ITEMS_KEPT)) and ids[0] >= 6


def stand_in_wait():
    warnings.warn(f"{SYNC_WARNING} (a stand-in)", UserWarning)


def test_a_wait_charges_the_innermost_open_span(recwarn):
    with profiled():
        with annotate("item"):
            stand_in_wait()
            with annotate("middle"):
                with annotate("inner"):
                    stand_in_wait()
                    stand_in_wait()
                stand_in_wait()
                warnings.warn("another warning", UserWarning)    # passes, uncounted
            with annotate("quiet"):
                pass
        stand_in_wait()                                          # no item open: shown, uncounted
    (item,) = recorded_items()
    counts = {s["name"]: s["syncs"] for s in item["spans"]}
    assert counts == {"item": 1, "middle": 1, "inner": 2, "quiet": 0} and item["syncs"] == 4
    inner = next(s for s in item["spans"] if s["name"] == "inner")
    assert len(inner["waits"]) == 2 and all("test_torch_spans.py:" in w for w in inner["waits"])
    shown = [str(w.message) for w in recwarn]
    assert shown == ["another warning", f"{SYNC_WARNING} (a stand-in)"]


def test_with_a_card_stand_in_spans_read_their_events(monkeypatch):
    """Two events a span, its device ms the time between them, read after
    the fact; the sync debug mode is 'warn' while the item is open and
    restored after it."""
    modes = [0]
    monkeypatch.setattr(profiling, "on_card", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    StandInEvent.made = 0
    with profiled():
        with annotate("serve.request"):
            assert modes[-1] == "warn"
            with annotate("serve.model"):
                pass
    assert modes == [0, "warn", 0] and StandInEvent.made == 4
    (item,) = recorded_items()
    # request: entry 1.5, exit 6.0; model: entry 3.0, exit 4.5
    assert [s["device_ms"] for s in item["spans"]] == [4.5, 1.5]
    assert recorded_items()[0]["spans"][0]["device_ms"] == 4.5    # resolved once, kept


@pytest.mark.cuda
def test_a_pageable_copy_is_one_wait_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync debug mode flags CUDA calls only")
    x = torch.ones(1 << 20, device="cuda")
    table = np.arange(24)
    with profiled():
        for plant in (False, True):
            with annotate("outer"):
                y = x * 2
                with annotate("inner"):
                    y = y + 1
                    if plant:
                        y = y + torch.as_tensor(table, device="cuda").sum()
    torch.cuda.synchronize()
    clean, planted = recorded_items()
    counts = [{s["name"]: s["syncs"] for s in it["spans"]} for it in (clean, planted)]
    assert counts[1]["inner"] == counts[0]["inner"] + 1 and counts[1]["outer"] == counts[0]["outer"]
    assert "test_torch_spans.py:" in planted["spans"][1]["waits"][-1]
    assert all(s["device_ms"] > 0 for it in (clean, planted) for s in it["spans"])
    assert torch.cuda.get_sync_debug_mode() == 0
