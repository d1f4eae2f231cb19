"""Eval BatchNorm, residual add and ReLU in one pass: the CUDA kernel
`csrc/bn_act.cu` and its plain PyTorch version.

    y = act((x - mean) * (rsqrt(var + eps) * weight) + bias [+ residual])

in fp32, rounded once to x's dtype; bf16 statistics under fp32 x form the
scale in bf16, as `nn.layers._eval_bn_promoted` does. With `up` = 2^k > 1
(HRNet's fuse rows) x is the low-resolution term, read by nearest index:

    y[n, c, h, w] = act(residual[n, c, h, w] + bn(x)[n, c, h >> k, w >> k])

for channels-last x and residual (`takes_up`). The kernel replaces
no TPU kernel (XLA fused these on the TPU); why it was added, what bounds
it and its design are at the top of the CUDA source. `nn.layers.bn_act`
decides when a BatchNorm takes it and calls `launch`, its one entry;
`launches` counts its launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from danet_densepose2smpl_tpu_torch.kernels.build import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # the C entry's dtype codes
# The per-channel fp32 mean, scale and bias a block keeps in shared memory
# (12 bytes a channel) fit the 48 KB a block has without an opt-in up to
# this C (the port's widest BatchNorm has 2048).
MAX_CHANNELS = 4096
launches = 0   # the kernel's launches in this process


def bn_act_plain(x, mean, var, weight, bias, eps: float, residual=None, relu: bool = False,
                 up: int = 1) -> torch.Tensor:
    """The kernel's arithmetic: in (at least) fp32, rounded once to x's
    dtype; statistics in another dtype than x's (bf16 under fp32 x) form
    the scale in theirs. Channels are dim 1; with `up` > 1 each of x's
    (H, W) pixels repeated up x up times before the residual."""
    acc = torch.promote_types(x.dtype, torch.float32)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if var.dtype != x.dtype:
        scale = (torch.rsqrt(var + eps) * weight).to(acc)
    else:
        scale = torch.rsqrt(var.to(acc) + eps) * weight.to(acc)
    y = (x.to(acc) - mean.to(acc).reshape(shape)) * scale.reshape(shape) + bias.to(acc).reshape(shape)
    if up > 1:
        y = y.repeat_interleave(up, dim=2).repeat_interleave(up, dim=3)
    if residual is not None:
        y = y + residual.to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def run_length(x: torch.Tensor) -> int | None:
    """The run of elements of one channel in x's memory: H*W (the product
    of the dims after C) for a contiguous tensor, 1 for a channels-last
    one, None for any other layout. A tensor that is both (H = W = 1) reads
    the same either way."""
    if x.is_contiguous():
        rows = x.shape[0] * x.shape[1]
        return x.numel() // rows if rows else 1
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return 1
    return None


def in_layout(t: torch.Tensor, inner: int) -> torch.Tensor:
    """t where its run of one channel is `inner` (`run_length`), else a
    copy in that layout: channels-last for a 4-d tensor and a run of 1,
    contiguous otherwise."""
    if run_length(t) == inner:
        return t
    if inner == 1 and t.dim() == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def takes_up(x: torch.Tensor, residual: torch.Tensor) -> bool:
    """Whether the upsampling instance takes x and the residual: both 4-d
    channels-last, C a multiple of the 16-byte vector (8 bf16, 4 fp32)."""
    return (x.dim() == residual.dim() == 4 and run_length(x) == run_length(residual) == 1
            and x.shape[1] % (16 // x.element_size()) == 0)


def prepare(x: torch.Tensor, residual: torch.Tensor | None, up: int = 1) -> tuple:
    """(x, residual, run length) as the kernel takes them: x in another
    layout than contiguous or channels-last copied to channels-last (4-d)
    or contiguous, the residual to x's layout. Raises for more than
    MAX_CHANNELS channels or a residual of another shape or dtype. With
    `up` > 1: as they are, and raises unless `up` is a power of two, the
    residual is (N, C, H * up, W * up) in x's dtype and `takes_up` holds."""
    if x.shape[1] > MAX_CHANNELS:
        raise ValueError(f"bn_act: C={x.shape[1]} over the kernel's {MAX_CHANNELS} channels")
    if up != 1:
        if not (up > 1 and up & (up - 1) == 0 and residual is not None and residual.dtype == x.dtype
                and takes_up(x, residual) and residual.shape == (*x.shape[:2], x.shape[2] * up, x.shape[3] * up)):
            raise ValueError(f"bn_act: up={up} takes x (N, C, H, W) and a residual (N, C, H*up, W*up) of its "
                             f"dtype, both channels-last, C a multiple of the vector; got x {x.dtype} "
                             f"{tuple(x.shape)}, residual "
                             f"{None if residual is None else (residual.dtype, tuple(residual.shape))}")
        return x, residual, 1
    inner = run_length(x)
    if inner is None:
        x = x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x.contiguous()
        inner = run_length(x)
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(f"bn_act: residual {residual.dtype} {tuple(residual.shape)} for x {x.dtype} "
                             f"{tuple(x.shape)}")
        residual = in_layout(residual, inner)
    return x, residual, inner


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library. Returns
    (library, compiler report)."""
    lib, log = build("bn_act.cu")
    lib.bn_act.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                           + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    lib.bn_act.restype = ctypes.c_int
    return lib, log


def launch(x, mean, var, weight, bias, eps: float, residual=None, relu: bool = False, up: int = 1) -> torch.Tensor:
    """act((x - mean) * (rsqrt(var + eps) * weight) + bias [+ residual]) on
    the card, on the current stream: a new tensor of x's shape and dtype.
    x: (N, C, ...) bf16 or fp32 on the card, C up to MAX_CHANNELS; mean,
    var, weight, bias: contiguous (C,) in x's dtype, or bf16 under fp32 x;
    the residual of x's shape and dtype; layouts as `prepare` makes them.
    With `up` > 1 the upsampling instance: x's pixels read by nearest index
    into the residual's shape, y of the residual's shape and strides. The
    caller (`nn.layers.bn_act`, ~350 calls a request) checks the dtypes and
    devices."""
    x, residual, inner = prepare(x, residual, up)
    y = torch.empty_like(x if up == 1 else residual)
    ptrs = (x.data_ptr(), 0 if residual is None else residual.data_ptr(), y.data_ptr())
    vectors = all(p % 16 == 0 for p in ptrs)
    lib, _ = load_library()
    dev = x.get_device()
    with torch.cuda.device(dev) if dev != torch.cuda.current_device() else contextlib.nullcontext():
        err = lib.bn_act(DTYPE_CODE[x.dtype], DTYPE_CODE[var.dtype], vectors, *ptrs, mean.data_ptr(),
                         var.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps, y.numel(), x.shape[1], inner,
                         relu, up.bit_length() - 1, y.shape[-1], torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return y
