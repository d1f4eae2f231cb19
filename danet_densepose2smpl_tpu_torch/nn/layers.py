"""Residual building blocks (port of the JAX `nn/layers.py`).

Module and attribute names follow the reference checkpoint's state_dict
(conv1/bn1/conv2/bn2[/conv3/bn3], downsample.{0,1}, blocks of a layer as
`{i}`), so a released state_dict loads name for name. BatchNorm eps is
1e-5, as flax's default; in train mode its running variance takes the
biased batch variance, as flax's does (see `FlaxRunningVar`), and inside
`parallel.data_parallel(mesh)` its statistics are the global batch's
(`GlobalBatchNorm`). `remat` runs a block under activation
checkpointing; a BatchNorm that its backward recomputes leaves its
running statistics alone.

Every BatchNorm, and the residual add and ReLU after it, goes through
`bn_act` (HRNet's upsampled fuse terms too, the nearest upsample with
them): on the card, in eval with autograd off, one kernel pass
(`kernels/bn_act.py`); elsewhere the module's forward, the upsample, the
add and the ReLU, as separate ops.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from danet_densepose2smpl_tpu_torch.kernels import bn_act as bn_act_kernel
from danet_densepose2smpl_tpu_torch.parallel.mesh import active_mesh, data_parallel
from danet_densepose2smpl_tpu_torch.utils.profiling import count

BN_EPS = 1e-5


class _RecomputeFlag(threading.local):
    active = False


_RECOMPUTE = _RecomputeFlag()


@contextlib.contextmanager
def _recomputing(mesh):
    """The context of a recompute: BatchNorm updates no statistics, and the
    forward's data-parallel mesh is active again (the backward of CUDA
    tensors runs on autograd's device threads, which do not see the
    forward's context)."""
    prev, _RECOMPUTE.active = _RECOMPUTE.active, True
    try:
        with data_parallel(mesh) if mesh is not None else contextlib.nullcontext():
            yield
    finally:
        _RECOMPUTE.active = prev


def remat(fn, *args):
    """fn(*args) with its activations freed after the forward and computed
    again in the backward (`torch.utils.checkpoint`, non-reentrant: `fn`
    may take lists of tensors, and the autocast state of the forward is
    replayed). Train-mode BatchNorm inside `fn` updates its running
    statistics once, in the forward, as flax's `nn.remat` keeps only the
    first forward's `batch_stats`; the recompute normalizes with the batch
    statistics alone. The blocks given here draw no random numbers (the
    step's noise comes from `draw_noise`, outside them), so no RNG state is
    saved per checkpoint (`preserve_rng_state=False`: no CUDA RNG-state
    copy per call)."""
    mesh = active_mesh()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing(mesh)))


def conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """Conv with the 'same' padding kernel // 2 of the JAX `layers.conv`."""
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=bias)


class FlaxRunningVar:
    """BatchNorm mixin: in train mode, update `running_var` with the biased
    batch variance, as flax does (torch's own update takes the unbiased
    one, a factor n/(n-1) that is large at the regressor's 1x1 and 2x2
    maps). The momentum is already flax's: torch 0.1 = flax 0.9.

    F.batch_norm writes (1-m)*rv + m*var*n/(n-1); handing it rv/k,
    k = (n-1)/n, and keeping k times its result turns that into
    (1-m)*rv + m*var without another pass over the activations.

    Inside `parallel.data_parallel(mesh)` of more than one rank, a
    train-mode forward normalizes with the statistics of the global batch
    (`GlobalBatchNorm`), as the JAX step's BatchNorm does on a sharded
    batch, and updates the running statistics with them: the same on every
    rank. At one rank the global batch is this one, and the forward is the
    plain one, bit for bit.

    Under `remat`'s recompute the forward is the same computation and
    leaves `running_mean`, `running_var` and `num_batches_tracked` as they
    are.

    `forward` goes through `bn_act`, which takes the kernel or comes back
    to `plain_forward`."""

    def forward(self, x):
        return bn_act(self, x)

    def plain_forward(self, x):
        if not (self.training and self.track_running_stats):
            if x.dtype != self.weight.dtype and not torch.is_autocast_enabled(x.device.type):
                return _eval_bn_promoted(self, x)
            return super().forward(x)
        mesh = active_mesh()
        if mesh is not None and mesh.size > 1:
            return self._global_forward(x, mesh.size)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(f"BatchNorm in train mode needs more than one value per channel, got {n}")
        k = (n - 1) / n
        # a scaled copy: autograd may save the tensor F.batch_norm updates
        running_var = self.running_var / k
        recompute = _RECOMPUTE.active
        # a recompute updates a copy of the mean, which is dropped
        running_mean = self.running_mean.clone() if recompute else self.running_mean
        y = F.batch_norm(x, running_mean, running_var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        if not recompute:
            with torch.no_grad():
                self.running_var.copy_(running_var * k)
                self.num_batches_tracked.add_(1)
        return y

    def _global_forward(self, x, ranks: int):
        if (x.numel() // x.shape[1]) * ranks < 2:
            raise ValueError("BatchNorm in train mode needs more than one value per channel over the global batch")
        y, mean, var = GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        if _RECOMPUTE.active:
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * mean + (1 - m) * self.running_mean)
            self.running_var.copy_(m * var + (1 - m) * self.running_var)
            self.num_batches_tracked.add_(1)
        return y


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a data-parallel step,
    each rank holding its rows: (y, mean, biased var), with y in x's dtype
    and the statistics in at least fp32 (bf16 activations under autocast
    are reduced in fp32).

    Forward: one all-reduce of the per-channel sums and the row count, then
    one of the squared deviations from the global mean (two passes, so the
    variance does not cancel as E[x^2] - E[x]^2 would). Backward: one
    all-reduce of sum(dy) and sum(dy * xhat), the terms through which every
    rank's rows reach the global statistics. The gradients of the scale and
    shift are this rank's own: the step sums them over the ranks with the
    other parameters' (`parallel.sum_gradients`). Only x is kept for the
    backward, as cuDNN's BatchNorm keeps it."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        acc = torch.promote_types(x.dtype, torch.float32)
        sums = torch.cat([x.sum(dims, dtype=acc), x.new_full((1,), x.numel() // x.shape[1], dtype=acc)])
        dist.all_reduce(sums)
        count = sums[-1]
        mean = sums[:-1] / count
        xc = x.to(acc) - mean.view(shape)
        var = (xc * xc).sum(dims)
        dist.all_reduce(var)
        var = var / count
        invstd = torch.rsqrt(var + eps)
        y = xc * (invstd * weight.to(acc)).view(shape) + bias.to(acc).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        g = gy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        c = mean.numel()
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        grad_bias, grad_weight = local[:c].clone(), local[c:].clone()
        dist.all_reduce(local)
        mean_g, mean_gx = local[:c] / count, local[c:] / count
        gx = (g - mean_g.view(shape) - xhat * mean_gx.view(shape)) * (invstd * weight.to(mean.dtype)).view(shape)
        return gx.to(x.dtype), grad_weight.to(weight.dtype), grad_bias.to(weight.dtype), None


def _eval_bn_promoted(m, x):
    """Eval BatchNorm with flax's dtype flow for mixed inputs (fp32
    activations into bf16 statistics and parameters):
    (x - mean) * (rsqrt(var + eps) * scale) + bias, the rsqrt and scale
    product in the statistics' dtype, the rest promoted."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(m.running_var + m.eps) * m.weight
    return (x - m.running_mean.reshape(shape)) * mul.reshape(shape) + m.bias.reshape(shape)


class FP32Constants(nn.Module):
    """A module whose buffers named in `CONSTANTS` (mean parameters,
    adjacencies) stay at promote(fp32, target dtype) when it is moved or
    cast: `.to(bf16)` moves them but leaves them fp32, `.double()` makes
    them f64, so what reads them computes in fp32 under bf16 serving."""

    CONSTANTS: tuple = ()

    def _apply(self, fn, recurse=True):
        kept = {name: self._buffers[name] for name in self.CONSTANTS}
        super()._apply(fn, recurse)
        for name, t in kept.items():
            moved = self._buffers[name]
            self._buffers[name] = t.to(device=moved.device,
                                       dtype=torch.promote_types(torch.float32, moved.dtype))
        return self


def on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def kernel_dtypes(m, x) -> bool:
    """Whether the kernel computes `m`'s eval forward of x: x and m's
    statistics and affine in one of its dtypes (bf16, fp32), or fp32 x into
    bf16 ones outside autocast (`_eval_bn_promoted`'s flow, which the
    kernel follows). Any other mix (and fp64, fp16) widens the output to
    another dtype than x's: the module's forward computes it."""
    s = m.weight.dtype
    if not (m.bias.dtype == m.running_mean.dtype == m.running_var.dtype == s):
        return False
    if x.dtype == s:
        return s in bn_act_kernel.DTYPE_CODE
    return x.dtype == torch.float32 and s == torch.bfloat16 and not torch.is_autocast_enabled(x.device.type)


def bn_act(m, x, residual=None, relu: bool = False, up: int = 1):
    """BatchNorm `m` of x, nearest-upsampled `up` times where `up` > 1, then
    `+ residual` and ReLU where given.

    One pass of the kernel (`kernels/bn_act.py::launch`) where x is on the
    card, `m` is in eval mode with running statistics and an affine on the
    card, autograd is off and `kernel_dtypes` holds; x and the residual in
    another layout than the kernel's are copied to one there, and a
    residual of another shape or dtype raises. With `up` > 1 (HRNet's fuse
    rows; a residual of x's shape times `up` required) the kernel also
    needs `bn_act_kernel.takes_up`: channels-last x and residual, C a
    multiple of the vector. Every other call (train mode, autograd on, the
    CPU, fp64, other dtype mixes, other layouts) is `m.plain_forward(x)`,
    `F.interpolate(mode="nearest")`, `+ residual`, `F.relu`, in that order.
    Each call on the card is counted into the span recorder's open item
    (`utils.profiling.count`): 'bn_act.fused' or 'bn_act.plain', and with
    `up` > 1 also 'bn_act.up_fused' or 'bn_act.up_plain'."""
    if up > 1 and residual is None:
        raise ValueError(f"bn_act: up={up} needs the residual it is added to")
    if on_card(x):
        fused = (not m.training and m.track_running_stats and m.affine and not torch.is_grad_enabled()
                 and on_card(m.weight) and kernel_dtypes(m, x) and (up == 1 or bn_act_kernel.takes_up(x, residual)))
        count("bn_act.fused" if fused else "bn_act.plain")
        if up > 1:
            count("bn_act.up_fused" if fused else "bn_act.up_plain")
        if fused:
            return bn_act_kernel.launch(x, m.running_mean, m.running_var, m.weight, m.bias, m.eps, residual, relu,
                                        up)
    y = m.plain_forward(x)
    if up > 1:
        y = F.interpolate(y, scale_factor=float(up), mode="nearest")
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


class BatchNorm2d(FlaxRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm1d(FlaxRunningVar, nn.BatchNorm1d):
    pass


def bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS)


class BNReLU(nn.Sequential):
    """Conv -> BN -> ReLU as a Sequential (torch keys `.0`, `.1`); the BN
    and ReLU through `bn_act`."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__(conv(cin, cout, kernel, stride), bn(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        return bn_act(self[1], self[0](x), relu=True)


def _downsample(cin: int, cout: int, stride: int, groups: int) -> nn.Sequential | None:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(conv(cin, cout, 1, stride, groups=groups), bn(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 1):
        super().__init__()
        g = groups
        self.conv1 = conv(inplanes * g, planes * g, 3, stride, groups=g)
        self.bn1 = bn(planes * g)
        self.conv2 = conv(planes * g, planes * g, 3, groups=g)
        self.bn2 = bn(planes * g)
        self.downsample = _downsample(inplanes * g, planes * g, stride, g)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = bn_act(self.bn1, self.conv1(x), relu=True)
        return bn_act(self.bn2, self.conv2(y), residual=r, relu=True)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 1):
        super().__init__()
        g = groups
        self.conv1 = conv(inplanes * g, planes * g, 1, groups=g)
        self.bn1 = bn(planes * g)
        self.conv2 = conv(planes * g, planes * g, 3, stride, groups=g)
        self.bn2 = bn(planes * g)
        self.conv3 = conv(planes * g, planes * 4 * g, 1, groups=g)
        self.bn3 = bn(planes * 4 * g)
        self.downsample = _downsample(inplanes * g, planes * 4 * g, stride, g)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = bn_act(self.bn1, self.conv1(x), relu=True)
        y = bn_act(self.bn2, self.conv2(y), relu=True)
        return bn_act(self.bn3, self.conv3(y), residual=r, relu=True)


class ResLayer(nn.Sequential):
    """`num_blocks` residual blocks; the first carries the stride. `inplanes`
    and `planes` count channels per group."""

    def __init__(self, block, inplanes: int, planes: int, num_blocks: int,
                 stride: int = 1, groups: int = 1):
        blocks = []
        for i in range(num_blocks):
            blocks.append(block(inplanes, planes, stride if i == 0 else 1, groups))
            inplanes = planes * block.expansion
        super().__init__(*blocks)
        self.out_channels = inplanes * groups


# depth -> (block class, per-stage block counts)
RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)
