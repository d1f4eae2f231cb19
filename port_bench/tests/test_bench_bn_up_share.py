"""`metrics/bn_up_fused_share.serve.py` on hand-built contexts over a store
filled by hand: the upsampled fuse terms that took the kernel over all of
them (`nn.layers.bn_act`'s 'bn_act.up_*' counts) in the profiled slice's
requests, in %; nothing where the items carry no such count (a model
without HRNet, a port without the counter) or there is no slice."""

import collections
from types import SimpleNamespace

import pytest

import run
from danet_densepose2smpl_tpu_torch.utils import profiling

REQUEST = [("serve.request", None), ("serve.model", "serve.request"), ("danet.backbone", "serve.model")]


@pytest.fixture(autouse=True)
def store():
    profiling.RECORDER.clear()
    yield profiling.RECORDER.items
    profiling.RECORDER.clear()


def request(ident, counts=None):
    spans = [profiling.Span(n, p, device_ms=1.0) for n, p in REQUEST]
    return profiling.Item(ident, spans=spans, counts=collections.Counter(counts or {}))


def ctx(items):
    return {"kind": "serve", "slice": SimpleNamespace(items=items)}


def test_all_fused_reads_100(store):
    for k in range(3):
        store.append(request(k, {"bn_act.fused": 348, "bn_act.up_fused": 28}))
    assert run.read_metric("bn_up_fused_share.serve", ctx(3)) == pytest.approx(100.0)


def test_the_share_over_the_slice_requests(store):
    for k, (fused, plain) in enumerate(((0, 28), (28, 0), (20, 8), (27, 1))):
        store.append(request(k, {"bn_act.up_fused": fused, "bn_act.up_plain": plain, "bn_act.fused": 340}))
    assert run.read_metric("bn_up_fused_share.serve", ctx(2)) == pytest.approx(100 * 47 / 56)


def test_nothing_without_up_counts_or_a_slice(store):
    store.append(request(0, {"bn_act.fused": 348, "bn_act.plain": 2}))
    assert run.read_metric("bn_up_fused_share.serve", ctx(1)) is None
    assert run.read_metric("bn_up_fused_share.serve", {"kind": "serve", "slice": None}) is None
