"""The span metrics (`metrics/*_ms.serve.py`, `*_ms.train.py`,
`syncs.*.py`, through `harness/spans.py`) on hand-built contexts over a
store filled by hand: each reads its spans' device ms, or the waits, per
item of the profiled slice, leaving out older items and items of the
other kind; nothing where the spans have no device ms (the CPU), where
the slice recorded no item, or where there is no slice."""

from types import SimpleNamespace

import pytest

import run
from danet_densepose2smpl_tpu_torch.utils import profiling

SERVE = {"backbone_ms.serve": "danet.backbone", "heads_ms.serve": "danet.heads",
         "regressor_ms.serve": "danet.regressor", "smpl_ms.serve": "serve.smpl"}
TRAIN = {"prepare_ms.train": ("train.ingest", "train.prepare_targets"), "forward_ms.train": ("train.forward",),
         "losses_ms.train": ("train.losses",), "backward_ms.train": ("train.backward",),
         "optimizer_ms.train": ("train.optimizer",)}
REQUEST = [("serve.request", None), ("serve.model", "serve.request"), ("danet.backbone", "serve.model"),
           ("danet.heads", "serve.model"), ("danet.regressor", "serve.model"), ("serve.smpl", "serve.request")]
STEP = [("train.step", None), ("train.ingest", "train.step"), ("train.prepare_targets", "train.step"),
        ("train.forward", "train.step"), ("danet.backbone", "train.forward"), ("train.losses", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step")]


@pytest.fixture(autouse=True)
def store():
    profiling.RECORDER.clear()
    yield profiling.RECORDER.items
    profiling.RECORDER.clear()


def item(ident, names, ms, waits=()):
    """An item of `names` (name, parent) whose k-th span read `ms(k)` device
    ms (None: no CUDA events), with `waits` {span: count}."""
    waits = dict(waits)
    spans = [profiling.Span(n, p, device_ms=ms(k), waits=["models/x.py:1"] * waits.get(n, 0))
             for k, (n, p) in enumerate(names)]
    return profiling.Item(ident, spans=spans)


def ctx(kind, items):
    return {"kind": kind, "slice": SimpleNamespace(items=items)}


def test_serve_metrics_read_the_slice_requests(store):
    store.append(item(0, REQUEST, lambda k: 1000.0, {"danet.heads": 9}))      # before the slice
    store.append(item(1, REQUEST, lambda k: 10.0 + k, {"danet.heads": 2, "serve.smpl": 1}))
    store.append(item(2, STEP, lambda k: 500.0, {"train.losses": 4}))          # another kind
    store.append(item(3, REQUEST, lambda k: 20.0 + k, {"danet.heads": 2, "serve.smpl": 2}))
    c = ctx("serve", 2)
    for name, span in SERVE.items():
        k = [n for n, _ in REQUEST].index(span)
        assert run.read_metric(name, c) == pytest.approx(15.0 + k), name
    assert run.read_metric("syncs.serve", c) == pytest.approx(3.5)


def test_train_metrics_read_the_slice_steps(store):
    store.append(item(0, REQUEST, lambda k: 7.0))
    store.append(item(1, STEP, lambda k: 100.0 * (k + 1), {"train.prepare_targets": 3, "train.backward": 1}))
    c = ctx("train", 1)
    for name, spans in TRAIN.items():
        want = sum(100.0 * ([n for n, _ in STEP].index(s) + 1) for s in spans)
        assert run.read_metric(name, c) == pytest.approx(want), name
    assert run.read_metric("syncs.train", c) == pytest.approx(4.0)


def test_nothing_on_the_cpu_or_without_items(store):
    names = list(SERVE) + ["syncs.serve"] + list(TRAIN) + ["syncs.train"]
    for name in names:                                  # an empty store, then no slice
        assert run.read_metric(name, ctx("serve" if "serve" in name else "train", 2)) is None, name
        assert run.read_metric(name, {"kind": "serve", "slice": None}) is None, name
    store.append(item(0, REQUEST, lambda k: None))      # spans without device ms (the CPU)
    store.append(item(1, STEP, lambda k: None))
    for name in names:
        assert run.read_metric(name, ctx("serve" if "serve" in name else "train", 1)) is None, name
