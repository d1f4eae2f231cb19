"""`metrics/bn_fused_share.serve.py` on hand-built contexts over a store
filled by hand: fused over all of `nn.layers.bn_act`'s route counts in the
profiled slice's requests, in %; nothing where the items carry no such
count (a port without the counter) or there is no slice."""

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


def test_the_share_over_the_slice_requests(store):
    for k, (fused, plain) in enumerate(((0, 9), (340, 8), (2, 5), (343, 5))):
        store.append(request(k, {"bn_act.fused": fused, "bn_act.plain": plain, "other": 7}))
    assert run.read_metric("bn_fused_share.serve", ctx(2)) == pytest.approx(100 * 345 / 355)


def test_nothing_without_the_counts_or_a_slice(store):
    store.append(request(0))
    assert run.read_metric("bn_fused_share.serve", ctx(1)) is None
    assert run.read_metric("bn_fused_share.serve", {"kind": "serve", "slice": None}) is None
