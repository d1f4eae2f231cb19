"""COCO RLE mask codec (port of the JAX package's `data/rle.py` and its
C++ core `native/rle.cpp`).

The subset DensePose ingest needs: uncompressed RLE ({'counts': [..],
'size': [h, w]}) and COCO's LEB128-style compressed string RLE, both
directions, and the 14-part `dp_masks` decode. `decode_rle` and
`decode_dp_masks` run the C++ codec (`csrc/rle.cpp`, a copy of the JAX
package's, built with the host compiler at first use by
`kernels.build.build_host`; a failed build raises). A malformed RLE (a
negative run, runs past the mask or short of it) raises ValueError. The
numpy codec (`decode_rle_plain`, `decode_dp_masks_plain`) is the plain
version the tests hold it to.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from danet_densepose2smpl_tpu_torch.kernels.build import build_host

        lib = build_host("rle.cpp")
        i64p, u8p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)
        lib.rle_decode.argtypes = [i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        lib.rle_uncompress.argtypes = [ctypes.c_char_p, ctypes.c_int, i64p, ctypes.c_int]
        lib.dp_masks_decode.argtypes = [i64p, i64p, u8p]
        for fn in (lib.rle_decode, lib.rle_uncompress, lib.dp_masks_decode):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _counts(rle: dict) -> np.ndarray:
    """The run lengths of `rle` as int64, compressed strings decoded by
    the C++ codec."""
    h, w = rle["size"]
    counts = rle["counts"]
    if not isinstance(counts, (bytes, str)):
        return np.asarray(counts, np.int64)
    s = counts.encode("ascii") if isinstance(counts, str) else counts
    buf = np.zeros(h * w + 2, np.int64)
    n = _lib().rle_uncompress(s, len(s), _ptr(buf, ctypes.c_int64), buf.size)
    if n < 0:
        raise ValueError(f"malformed compressed RLE counts of a {h}x{w} mask")
    return buf[:n]


def decode_rle(rle: dict) -> np.ndarray:
    """RLE dict -> (h, w) uint8 mask. COCO RLE is column-major."""
    h, w = rle["size"]
    counts = np.ascontiguousarray(_counts(rle))
    mask = np.zeros((h, w), np.uint8)
    rc = _lib().rle_decode(_ptr(counts, ctypes.c_int64), len(counts), h, w, _ptr(mask, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"malformed RLE of a {h}x{w} mask: its runs do not tile it (code {rc})")
    return mask


def decode_rle_plain(rle: dict) -> np.ndarray:
    """`decode_rle` in numpy."""
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
    part i+1 where mask i is set (one C++ call over every part's runs)."""
    parts = [_counts(rle) if rle else np.zeros(0, np.int64) for rle in dp_masks]
    parts += [np.zeros(0, np.int64)] * (14 - len(parts))
    counts = np.ascontiguousarray(np.concatenate(parts))
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in parts])]).astype(np.int64)
    label = np.zeros((256, 256), np.uint8)
    if _lib().dp_masks_decode(_ptr(counts, ctypes.c_int64), _ptr(offsets, ctypes.c_int64),
                              _ptr(label, ctypes.c_uint8)) != 0:
        raise ValueError("malformed dp_masks RLE: the runs of a part do not tile its 256x256 mask")
    return label


def decode_dp_masks_plain(dp_masks: list) -> np.ndarray:
    """`decode_dp_masks` in numpy."""
    label = np.zeros((256, 256), dtype=np.uint8)
    for i, rle in enumerate(dp_masks):
        if rle:
            label[decode_rle_plain(rle) > 0] = i + 1
    return label
