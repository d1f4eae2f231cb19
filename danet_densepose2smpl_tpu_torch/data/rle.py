"""COCO RLE mask codec in numpy (port of the JAX package's `data/rle.py`).

The subset DensePose ingest needs: uncompressed RLE ({'counts': [..],
'size': [h, w]}) and COCO's LEB128-style compressed string RLE, both
directions, and the 14-part `dp_masks` decode. The JAX package's C++ codec
(`native/rle.cpp`) is not ported: this numpy codec is its own fallback.
"""

from __future__ import annotations

import numpy as np


def decode_rle(rle: dict) -> np.ndarray:
    """RLE dict -> (h, w) uint8 mask. COCO RLE is column-major."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _uncompress_counts(counts)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def encode_rle(mask: np.ndarray) -> dict:
    """(h, w) 0/1 mask -> uncompressed RLE dict (column-major counts)."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)
    # run lengths, starting with a zero-run
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def _uncompress_counts(s) -> list:
    """COCO compressed RLE string -> counts list (LEB128 variant with
    delta-coding of every count from the third on)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def compress_counts(counts: list) -> bytes:
    """counts list -> COCO compressed RLE byte string."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (chunk & 0x10)) and not (x == -1 and (chunk & 0x10))
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return bytes(out)


def decode_dp_masks(dp_masks: list) -> np.ndarray:
    """14-part DensePose `dp_masks` list -> (256, 256) part-label image:
    part i+1 where mask i is set."""
    label = np.zeros((256, 256), dtype=np.uint8)
    for i, rle in enumerate(dp_masks):
        if rle:
            label[decode_rle(rle) > 0] = i + 1
    return label
