"""Image files without cv2: PNG in numpy + zlib, JPEG through PIL.

The JAX package reads dataset images with `cv2.imread` and writes its
fixtures with `cv2.imwrite`; the port uses no cv2. PNG
(8-bit gray, gray + alpha, RGB, RGBA; every filter type on read; no
interlace) is decoded and encoded here and round-trips bit for bit with
cv2's own PNG codec. JPEG goes through PIL; where PIL is missing, reading a
JPEG raises and names the decoder that is missing.

Arrays are RGB (or 2-D gray), uint8, as they are in the file; `read_rgb`
gives the dataset's view: RGB uint8 (H, W, 3), gray replicated, alpha
dropped, as `cv2.imread(path)[:, :, ::-1]` gives it. `read_gray` reads a
label PNG as `cv2.imread(path, 0)` does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 (H, W) gray or (H, W, 3) RGB -> a PNG file (filter 0 on every
    row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF


def _average_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        cur[x] = (cur[x] + ((a + prior[x]) >> 1)) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth) of `h` rows of `stride` bytes."""
    if len(data) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(data)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = rows[y, 0], rows[y, 1:]
        if kind == 0:
            rec = cur
        elif kind == 1:     # Sub: a running sum per channel, mod 256
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:     # Up
            rec = cur + prior
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            rec = np.frombuffer(buf, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = rec
        prior = out[y]
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) for gray, (H, W, 3) RGB for colour; alpha
    is dropped. 8-bit samples, no palette, no interlace."""
    if not blob.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos : pos + 8])
        data = blob[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", blob[pos + 8 + length : pos + 12 + length])
        if crc != zlib.crc32(kind + data) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG with bit depth {depth}, colour type {color}, interlace {interlace}: only 8-bit "
            "gray, gray+alpha, RGB and RGBA without interlace are read")
    ch = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    return img[..., 0] if ch <= 2 else np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_gray(path: str) -> np.ndarray:
    """A PNG file -> uint8 (H, W), as `cv2.imread(path, 0)` reads it: gray
    as it is (alpha dropped); RGB and RGBA through libpng's rgb-to-gray,
    which cv2's PNG decoder asks for with the weights (0.299, 0.587):
    15-bit fixed-point coefficients (9797, 19234, 3737; they sum to 2^15,
    so R == G == B reads back as it is), truncated."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    """An image file -> RGB uint8 (H, W, 3): PNG here, JPEG through PIL."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(PNG_SIGNATURE):
        img = decode_png(blob)
    elif blob.startswith(JPEG_SIGNATURE):
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"{path} is a JPEG and this environment has no JPEG decoder (PIL is not "
                "installed); convert the images to PNG") from e
        import io

        with Image.open(io.BytesIO(blob)) as im:
            img = np.asarray(im.convert("RGB"))
    else:
        raise ValueError(f"{path}: neither PNG nor JPEG")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img
