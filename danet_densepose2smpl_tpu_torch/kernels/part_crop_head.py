"""Fused STN part crop + grouped 3x3 partial-IUV head: the CUDA kernel
`csrc/part_crop_head.cu` and its plain PyTorch version.

Replaces the TPU kernel `danet_densepose2smpl_tpu/kernels/part_crop_head.py
::fused_part_predict` and keeps its contract. What bounds the kernel on the
H100 and how its design answers is set out at the top of the CUDA source.

`fused_part_predict` dispatches on the device of `feats`: a CPU tensor goes
to the plain version, a CUDA tensor to a kernel, which launches or raises.
On the card the dtype alone picks the kernel: bf16 runs the conv on the
tensor cores, from the weights `pack_head_weights` lays out (in channel
chunks where the features are too wide for one block's shared memory, as
the ResNet backbone's 256 channels are: `bf16_chunk`); fp32 and f64 run the
scalar kernel, which chunks its channels alike. `fused_part_predict.launches`
counts kernel launches. The kernels have no backward (nor had the TPU kernel), so on
every device the result carries a `grad_fn` whose backward raises: a
gradient is never dropped silently.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from danet_densepose2smpl_tpu_torch.kernels.build import build

_SCALAR_DTYPE_CODE = {torch.float32: 0, torch.float64: 2}   # the scalar kernel's dtypes
MMA_DEPTH = 16   # the bf16 kernel pads C to this (mma.sync m16n8k16)
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


def pack_head_weights(kernel: torch.Tensor, num_parts: int, chunk: int | None = None) -> torch.Tensor:
    """The bf16 kernel's B operand: (3, 3, C, K*O) HWIO grouped-conv weights
    -> (K, Npad, 9 * Cpad), for each part the (dy, dx, c)-ordered GEMM depth
    of each output channel, contiguous. C is padded to a multiple of
    MMA_DEPTH and O to a multiple of MMA_WIDTH, with zeros.

    With `chunk` (a multiple of MMA_DEPTH), the channels are packed chunk by
    chunk, as the kernel takes them where all of C does not fit in shared
    memory: (K, chunks, Npad, 9 * chunk), each chunk's depth in (dy, dx, c)
    order, C padded with zeros to chunks * chunk. A chunk of Cpad gives the
    bytes of the unchunked layout."""
    c, ko = kernel.shape[2], kernel.shape[3]
    k, o = num_parts, ko // num_parts
    cpad = -(-c // MMA_DEPTH) * MMA_DEPTH
    npad = -(-o // MMA_WIDTH) * MMA_WIDTH
    width = chunk or cpad
    if width % MMA_DEPTH:
        raise ValueError(f"pack_head_weights: chunk {width} is not a multiple of {MMA_DEPTH}")
    n = -(-c // width)
    w = kernel.reshape(3, 3, c, k, o).permute(3, 4, 0, 1, 2)          # (K, O, 3, 3, C)
    w = F.pad(w, (0, n * width - c)).reshape(k, o, 9, n, width)
    w = w.permute(0, 3, 1, 2, 4).reshape(k, n, o, 9 * width)
    w = F.pad(w, (0, 0, 0, npad - o)).contiguous()
    return w if chunk else w.reshape(k, npad, 9 * cpad)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library. Returns
    (library, compiler report)."""
    lib, log = build("part_crop_head.cu")
    lib.part_crop_head.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.part_crop_head_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.part_crop_head_bf16_chunk.argtypes = [ctypes.c_int] * 5
    lib.part_crop_head.restype = lib.part_crop_head_bf16.restype = ctypes.c_int
    lib.part_crop_head_bf16_chunk.restype = ctypes.c_int
    return lib, log


def bf16_chunk(h: int, w: int, c: int, s: int, o: int) -> int:
    """The channels the bf16 kernel takes at a time at this shape: all of C
    padded to MMA_DEPTH where its shared memory holds them (C=48 at 56x56),
    else a chunk of 32 (the ResNet backbone's C=256). Asks the library, on
    the card."""
    chunk = load_library()[0].part_crop_head_bf16_chunk(h, w, c, s, o)
    if chunk <= 0:
        raise RuntimeError(f"part_crop_head: no tile of the bf16 kernel fits (H, W, C, S, O) = {(h, w, c, s, o)}")
    return chunk


def _check(feats, wy, wx, kernel, bias, out_size):
    dt = feats.dtype
    if dt not in (torch.bfloat16, *_SCALAR_DTYPE_CODE):
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
            "conv, or decide on a K1 backward by measuring (ROADMAP.md queue 2)")


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
    if feats.device.type == "cpu":
        return part_crop_head_plain(feats, wy, wx, kernel, bias, out_size)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_part_predict: no kernel for device {feats.device}")
    b, h, w, c, k, o = _check(feats, wy, wx, kernel, bias, out_size)
    s = out_size
    lib, _ = load_library()
    out = torch.empty((b, k, s, s, o), dtype=feats.dtype, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        if feats.dtype == torch.bfloat16:
            chunk = bf16_chunk(h, w, c, s, o)
            wpack = pack_head_weights(kernel, k, chunk)
            err = lib.part_crop_head_bf16(
                feats.data_ptr(), wy.data_ptr(), wx.data_ptr(), wpack.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, h, w, c, s, k, o, chunk, stream,
            )
        else:
            kern = kernel.reshape(3, 3, c, k, o).permute(3, 0, 1, 2, 4).contiguous()  # (K,3,3,C,O)
            err = lib.part_crop_head(
                _SCALAR_DTYPE_CODE[feats.dtype], feats.data_ptr(), wy.data_ptr(), wx.data_ptr(),
                kern.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, s, k, o, stream,
            )
    if err != 0:
        raise RuntimeError(f"part_crop_head kernel launch failed: cudaError {err}")
    fused_part_predict.launches += 1
    return out


fused_part_predict.launches = 0
