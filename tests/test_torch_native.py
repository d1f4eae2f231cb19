"""The port's native RLE codec (`csrc/rle.cpp`, built with the host
compiler by `kernels.build.build_host`) against the JAX package's
`native/rle.cpp` and `data/rle.py`, and the port's profiling module.

The C++ source is a byte-for-byte copy; its decode of random masks and of
DensePose `dp_masks` lists (uncompressed, compressed, with empty slots) is
bit-equal to the port's numpy codec and to JAX's `data/rle.py`; a
malformed RLE and a build with a compiler that is not there raise.
`trace` writes a Chrome trace with the annotated range on the CPU (the
spans themselves: `test_torch_spans.py`)."""

import json
from pathlib import Path

import numpy as np
import pytest

from danet_densepose2smpl_tpu.data import rle as jrle

from danet_densepose2smpl_tpu_torch.data import rle
from danet_densepose2smpl_tpu_torch.kernels import build
from danet_densepose2smpl_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]


def test_rle_source_is_the_jax_packages():
    ours = REPO / "danet_densepose2smpl_tpu_torch" / "csrc" / "rle.cpp"
    assert ours.read_bytes() == (REPO / "danet_densepose2smpl_tpu" / "native" / "rle.cpp").read_bytes()


def _masks(rng):
    shapes = [(1, 1), (3, 7), (17, 5), (64, 48), (256, 256)]
    out = []
    for h, w in shapes:
        for density in (0.0, 0.3, 1.0):
            out.append((rng.rand(h, w) < density).astype(np.uint8))
    # blobs: long runs, as real masks have
    yy, xx = np.mgrid[:256, :256]
    out.append(((yy - 100) ** 2 + (xx - 140) ** 2 < 60 ** 2).astype(np.uint8))
    return out


def test_decode_rle_native_equals_numpy_and_jax():
    rng = np.random.RandomState(0)
    for m in _masks(rng):
        enc = rle.encode_rle(m)
        packed = {"size": enc["size"], "counts": rle.compress_counts(enc["counts"]).decode("ascii")}
        for r in (enc, packed, dict(packed, counts=packed["counts"].encode("ascii"))):
            got = rle.decode_rle(r)
            assert got.dtype == np.uint8 and got.shape == m.shape
            np.testing.assert_array_equal(got, m)
            np.testing.assert_array_equal(got, rle.decode_rle_plain(r))
            np.testing.assert_array_equal(got, jrle.decode_rle(r))


@pytest.mark.parametrize("layout", ["uncompressed", "compressed", "mixed"])
def test_decode_dp_masks_native_equals_numpy_and_jax(layout):
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[:256, :256]
    parts = []
    for p in range(14):
        if p % 5 == 4:
            parts.append([])          # an empty slot
            continue
        cy, cx, r = rng.randint(40, 216, 2).tolist() + [rng.randint(10, 70)]
        enc = rle.encode_rle(((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8))
        if layout == "compressed" or (layout == "mixed" and p % 2):
            enc = {"size": enc["size"], "counts": rle.compress_counts(enc["counts"]).decode("ascii")}
        parts.append(enc)
    got = rle.decode_dp_masks(parts)
    assert got.shape == (256, 256) and got.dtype == np.uint8 and len(np.unique(got)) > 5
    np.testing.assert_array_equal(got, rle.decode_dp_masks_plain(parts))
    np.testing.assert_array_equal(got, jrle.decode_dp_masks(parts))


@pytest.mark.parametrize("counts", [[2, 3], [5, 20], [-1, 13], "0"], ids=["short", "long", "negative", "bad-string"])
def test_malformed_rle_raises(counts):
    with pytest.raises(ValueError, match="malformed"):
        rle.decode_rle({"size": [3, 4], "counts": counts})


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a compiler that is not there, or one that
    fails, raises."""
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="could not run"):
        build.build_host("rle.cpp", compiler=str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="failed"):
        build.build_host("rle.cpp", compiler="false")
    assert not list(tmp_path.glob("*.so"))


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("smoke.matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    path = tmp_path / "tr" / "trace.json"
    assert path.stat().st_size > 0
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "smoke.matmul" in names
    assert any(e.key == "smoke.matmul" for e in prof.key_averages())
