"""Fused STN part crop + grouped 3x3 partial-IUV head: the CUDA kernels
`csrc/part_crop_head.cu` and their plain PyTorch version.

Replaces the TPU kernel `danet_densepose2smpl_tpu/kernels/part_crop_head.py
::fused_part_predict` and keeps its contract. What bounds each kernel on the
H100 and how its design answers is set out at the top of the CUDA source.

`fused_part_predict` dispatches on the device and dtype of `feats`. A CPU
tensor and an f64 one go to the plain version, the tests' precision running
the same code on every device. A bf16 or fp32 CUDA tensor goes to its kernel,
which launches or raises; any other dtype on the card raises:

- bf16 runs the conv on the tensor cores in bf16, taking the channels in
  chunks of 16 or 32 with the tile rows and chunk `bf16_plan` picks, from
  the weights `pack_head_weights` lays out chunk by chunk;
- fp32 (the default precision of `Predictor` and the CLIs) runs the same
  skeleton with the conv in 3xTF32 on the tensor cores, in chunks of 8 or
  16 (`f32_plan`), from the big and small TF32 planes of
  `pack_head_weights(..., split=True)`. The conv is bound by its operations
  (1.82e9 * C FLOP at B=64: 1.30 ms at C=48 on the CUDA cores' 67 TFLOP/s,
  0.53 ms as three TF32 passes at 495); three passes keep fp32's accuracy,
  since each product is off by about 2^-21 of itself against a 1e-4 bar.

`fused_part_predict.launches` counts the two kernels' launches. The kernels
have no backward (nor had the TPU kernel), so on every device and in every
dtype the result carries a `grad_fn` whose backward raises: a gradient is
never dropped silently.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from danet_densepose2smpl_tpu_torch.kernels.build import build

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MMA_DEPTH = 16   # the bf16 kernel pads C to this (mma.sync m16n8k16)
TF32_DEPTH = 8   # the fp32 kernel pads C to this (mma.sync m16n8k8, TF32)
MMA_WIDTH = 24   # and O to a multiple of this (three n8 tiles a GEMM pass)


def part_crop_head_plain(feats, wy, wx, kernel, bias, out_size: int) -> torch.Tensor:
    """Plain version: the separable crop einsums, then the groups=K conv.

    Rounds where the kernel rounds: the y-interpolated rows and the crop are
    cast to the input dtype; the conv accumulates in (at least) fp32, adds
    the bias there, and the result is cast to the input dtype.
    """
    dt = feats.dtype
    acc = torch.promote_types(torch.float32, dt)
    b, _, _, c = feats.shape
    k, s = wy.shape[1], out_size
    o = kernel.shape[-1] // k
    tmp = torch.einsum("bkoh,bhwc->bkowc", wy.to(acc), feats.to(acc)).to(dt)
    crop = torch.einsum("bkpw,bkowc->bkopc", wx.to(acc), tmp.to(acc)).to(dt)
    x = crop.permute(0, 1, 4, 2, 3).reshape(b, k * c, s, s)
    w = kernel.to(dt).permute(3, 2, 0, 1)                     # (K*O, C, 3, 3)
    out = F.conv2d(x.to(acc), w.to(acc), bias.to(acc), padding=1, groups=k)
    return out.reshape(b, k, o, s, s).permute(0, 1, 3, 4, 2).to(dt)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the card's `cvt.rna.tf32.f32` rounds: the bits
    plus half the dropped part, the 13 low bits cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) = (tf32(x), tf32(x - big)) of fp32 `x`: big + small holds
    x to about 2^-22 of itself (exactly where x has at most 22 significant
    bits), as the fp32 kernel splits both GEMM operands."""
    big = tf32_round(x)
    return big, tf32_round(x.to(torch.float32) - big)


def pack_head_weights(kernel: torch.Tensor, num_parts: int, chunk: int | None = None,
                      split: bool = False) -> torch.Tensor:
    """The GEMM B operand: (3, 3, C, K*O) HWIO grouped-conv weights -> (K,
    Npad, 9 * Cpad), for each part the (dy, dx, c)-ordered GEMM depth of each
    output channel, contiguous. C is padded to a multiple of MMA_DEPTH (the
    bf16 kernel's) and O to a multiple of MMA_WIDTH, with zeros.

    With `chunk` (a multiple of MMA_DEPTH), the channels are packed chunk by
    chunk, as the kernels take them: (K, chunks, Npad, 9 * chunk), each
    chunk's depth in (dy, dx, c) order, C padded with zeros to chunks *
    chunk. A chunk of Cpad gives the bytes of the unchunked layout.

    With `split` (the fp32 kernel's operand; `chunk` a multiple of
    TF32_DEPTH, required), the fp32 weights are packed chunk by chunk and
    split into their TF32 big and small planes (`tf32_split`): (2, K,
    chunks, Npad, 9 * chunk), fp32."""
    c, ko = kernel.shape[2], kernel.shape[3]
    k, o = num_parts, ko // num_parts
    depth = TF32_DEPTH if split else MMA_DEPTH
    if split and not chunk:
        raise ValueError("pack_head_weights: split=True packs chunk by chunk: give `chunk`")
    cpad = -(-c // depth) * depth
    npad = -(-o // MMA_WIDTH) * MMA_WIDTH
    width = chunk or cpad
    if width % depth:
        raise ValueError(f"pack_head_weights: chunk {width} is not a multiple of {depth}")
    n = -(-c // width)
    w = kernel.reshape(3, 3, c, k, o).permute(3, 4, 0, 1, 2)          # (K, O, 3, 3, C)
    w = F.pad(w, (0, n * width - c)).reshape(k, o, 9, n, width)
    w = w.permute(0, 3, 1, 2, 4).reshape(k, n, o, 9 * width)
    w = F.pad(w, (0, 0, 0, npad - o)).contiguous()
    if split:
        return torch.stack(tf32_split(w))
    return w if chunk else w.reshape(k, npad, 9 * cpad)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library. Returns
    (library, compiler report)."""
    lib, log = build("part_crop_head.cu")
    lib.part_crop_head_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.part_crop_head_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.part_crop_head_bf16_bytes.argtypes = lib.part_crop_head_f32_bytes.argtypes = [ctypes.c_int] * 5
    lib.part_crop_head_bf16.restype = lib.part_crop_head_f32.restype = ctypes.c_int
    lib.part_crop_head_bf16_bytes.restype = lib.part_crop_head_f32_bytes.restype = ctypes.c_longlong
    return lib, log


BF16_CHUNKS = (16, 32)          # the bf16 kernel's channel chunks (its template instances)
BF16_MAX_PIXELS = 512           # a tile's pixels: 8 warps x 4 MMA tiles of 16 pixels
SMEM_TWO_BLOCKS = 113 * 1024    # a block's shared memory when two share an SM
# What a chunk of 32 channels costs the bf16 kernel in chunks of 16: their
# times per chunk at B=64, S=56, 8-row tiles on an H100 (PERF.md §6, the
# sweep of `kernels/probe_part_crop_head.py`)
CHUNK32_COST = 1.65


def bf16_chunk(c: int) -> int:
    """The bf16 kernel's channel chunk at C channels: the one whose count of
    chunks costs least (CHUNK32_COST per chunk of 32, 1 per chunk of 16)."""
    return 32 if -(-c // 32) * CHUNK32_COST < -(-c // 16) else 16


def _tallest_rows(smem_bytes, max_pixels: int, w: int, s: int, o: int, chunk: int) -> int:
    """The tallest tile, of at most 8 rows, whose pixels fit `max_pixels`
    and whose shared memory, `smem_bytes(rows, W, S, O, chunk)`, lets two
    blocks share an SM; 0 if none."""
    for rows in range(min(8, max_pixels // s), 0, -1):
        if smem_bytes(rows, w, s, o, chunk) <= SMEM_TWO_BLOCKS:
            return rows
    return 0


@functools.lru_cache(maxsize=None)
def bf16_rows(w: int, s: int, o: int, chunk: int) -> int:
    """The tallest tile, of at most 8 rows, that the bf16 kernel's MMA tiles
    hold and whose shared memory (the library's `part_crop_head_bf16_bytes`)
    lets two blocks share an SM; 0 if none. Builds the library."""
    return _tallest_rows(load_library()[0].part_crop_head_bf16_bytes, BF16_MAX_PIXELS, w, s, o, chunk)


def bf16_plan(h: int, w: int, c: int, s: int, o: int) -> tuple[int, int]:
    """(tile rows, channel chunk) of the bf16 kernel at this shape:
    `bf16_chunk`, then `bf16_rows`."""
    chunk = bf16_chunk(c)
    rows = bf16_rows(w, s, o, chunk)
    if rows == 0:
        raise RuntimeError(f"part_crop_head: no tile of the bf16 kernel fits (H, W, C, S, O) = {(h, w, c, s, o)}")
    return rows, chunk


F32_CHUNKS = (8, 16)            # the fp32 kernel's channel chunks (its template instances)
F32_MAX_PIXELS = 480            # a tile's pixels: 6 warps x 5 MMA tiles of 16 pixels
# What a chunk of 8 channels costs the fp32 kernel in chunks of 16: their
# times per chunk at B=64, S=56, 8-row tiles on an H100 (PERF.md §6, the
# fp32 sweep of `kernels/probe_part_crop_head.py`: 0.57-0.59 at C=48, 64,
# 256)
F32_CHUNK_COST = {8: 0.59, 16: 1.0}


def f32_chunk(c: int) -> int:
    """The fp32 kernel's channel chunk at C channels: the one whose count of
    chunks costs least (F32_CHUNK_COST per chunk), the wider on a tie."""
    return min(F32_CHUNKS, key=lambda ch: (-(-c // ch) * F32_CHUNK_COST[ch], -ch))


@functools.lru_cache(maxsize=None)
def f32_rows(w: int, s: int, o: int, chunk: int) -> int:
    """The tallest tile, of at most 8 rows, that the fp32 kernel's MMA tiles
    hold and whose shared memory (the library's `part_crop_head_f32_bytes`)
    lets two blocks share an SM; 0 if none. Builds the library."""
    return _tallest_rows(load_library()[0].part_crop_head_f32_bytes, F32_MAX_PIXELS, w, s, o, chunk)


def f32_plan(h: int, w: int, c: int, s: int, o: int) -> tuple[int, int]:
    """(tile rows, channel chunk) of the fp32 kernel at this shape:
    `f32_chunk`, then `f32_rows`."""
    chunk = f32_chunk(c)
    rows = f32_rows(w, s, o, chunk)
    if rows == 0:
        raise RuntimeError(f"part_crop_head: no tile of the fp32 kernel fits (H, W, C, S, O) = {(h, w, c, s, o)}")
    return rows, chunk


def _check(feats, wy, wx, kernel, bias, out_size):
    dt = feats.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"fused_part_predict: unsupported dtype {dt}")
    for name, t in (("wy", wy), ("wx", wx), ("kernel", kernel), ("bias", bias)):
        if t.device != feats.device:
            raise ValueError(f"fused_part_predict: {name} on {t.device}, feats on {feats.device}")
        if t.dtype != dt:
            raise TypeError(f"fused_part_predict: {name} is {t.dtype}, feats is {dt}")
    if feats.dim() != 4:
        raise ValueError(f"fused_part_predict: feats must be (B, H, W, C), got {tuple(feats.shape)}")
    b, h, w, c = feats.shape
    k, s = wy.shape[1], out_size
    if kernel.shape[:3] != (3, 3, c) or kernel.shape[3] % k:
        raise ValueError(f"fused_part_predict: kernel {tuple(kernel.shape)} is not (3, 3, {c}, {k}*O)")
    o = kernel.shape[3] // k
    if tuple(wy.shape) != (b, k, s, h) or tuple(wx.shape) != (b, k, s, w):
        raise ValueError(
            f"fused_part_predict: wy {tuple(wy.shape)} / wx {tuple(wx.shape)} do not match "
            f"(B, K, S, H) = {(b, k, s, h)} / (B, K, S, W) = {(b, k, s, w)}")
    if tuple(bias.shape) != (k * o,):
        raise ValueError(f"fused_part_predict: bias {tuple(bias.shape)} is not ({k * o},)")
    for name, t in (("feats", feats), ("wy", wy), ("wx", wx), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"fused_part_predict: {name} must be contiguous")
    return b, h, w, c, k, o


class _ForwardOnly(torch.autograd.Function):
    """Runs the crop + head; its backward refuses instead of returning a
    zero or missing gradient."""

    @staticmethod
    def forward(ctx, feats, wy, wx, kernel, bias, out_size):
        return _fused_part_predict(feats, wy, wx, kernel, bias, out_size)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "fused_part_predict has no backward: train through the separable crop + grouped "
            "conv, or decide on a K1 backward by measuring (ROADMAP.md item 32)")


def fused_part_predict(feats, wy, wx, kernel, bias, out_size: int) -> torch.Tensor:
    """Crop K parts from `feats` and apply the grouped 3x3 head, fused.

    feats: (B, H, W, C); wy: (B, K, S, H), wx: (B, K, S, W) interpolation
    matrices (`ops.imwarp._axis_weights`, any dense values); kernel:
    (3, 3, C, K*O) grouped-conv weights in HWIO, output channel k*O + o
    belonging to part k; bias: (K*O,). Returns (B, K, S, S, O) in feats'
    dtype. Forward only: backward through the result raises.
    """
    return _ForwardOnly.apply(feats, wy, wx, kernel, bias, out_size)


def _fused_part_predict(feats, wy, wx, kernel, bias, out_size: int) -> torch.Tensor:
    if feats.device.type == "cpu" or feats.dtype == torch.float64:
        return part_crop_head_plain(feats, wy, wx, kernel, bias, out_size)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_part_predict: no kernel for device {feats.device}")
    b, h, w, c, k, o = _check(feats, wy, wx, kernel, bias, out_size)
    s = out_size
    lib, _ = load_library()
    out = torch.empty((b, k, s, s, o), dtype=feats.dtype, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (feats.data_ptr(), wy.data_ptr(), wx.data_ptr())
        if feats.dtype == torch.bfloat16:
            rows, chunk = bf16_plan(h, w, c, s, o)
            wpack = pack_head_weights(kernel, k, chunk)
            err = lib.part_crop_head_bf16(*ptrs, wpack.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                          b, h, w, c, s, k, o, rows, chunk, stream)
        else:
            rows, chunk = f32_plan(h, w, c, s, o)
            wpack = pack_head_weights(kernel, k, chunk, split=True)
            err = lib.part_crop_head_f32(*ptrs, wpack.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                         b, h, w, c, s, k, o, rows, chunk, stream)
    if err != 0:
        raise RuntimeError(f"part_crop_head kernel launch failed: cudaError {err}")
    fused_part_predict.launches += 1
    return out


fused_part_predict.launches = 0
