"""The data-parallel mesh: a process group and this process's place in it
(port of the JAX package's `parallel/mesh.py`).

`make_mesh()` reads `torchrun`'s environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR / MASTER_PORT) and joins its process group;
without that environment it is a world of one rank, as JAX's `make_mesh()`
is on one device. The backend follows the device: NCCL for CUDA, gloo for
the CPU; `backend=` names another explicitly (gloo over CUDA tensors, in
tests).

`shard_batch` keeps this rank's rows of a global batch; inside
`data_parallel(mesh)` the train forward and the losses compute the global
batch's values from them (`active_mesh`, `global_sum`, `world_size`:
BatchNorm in `nn/layers.py`, the noise in `models/danet.py::draw_noise`,
the losses in `models/losses.py`); `sum_gradients` adds the ranks'
gradients; `all_gather_rows` gives every rank the global batch of a
per-row result.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("danet_data_parallel", default=None)


@dataclass(frozen=True)
class Mesh:
    """This process's rank in a 1-D data-parallel process group of `size`
    ranks, on `device`."""
    rank: int
    size: int
    device: torch.device
    backend: str

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch; raises a ValueError unless
        the ranks divide it evenly (as a JAX batch sharding requires)."""
        if global_batch % self.size:
            raise ValueError(f"a global batch of {global_batch} rows does not divide over {self.size} ranks")
        b = global_batch // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def close(self) -> None:
        """Leave the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(device=None, backend: str | None = None) -> Mesh:
    """Join the data-parallel process group (see the module docstring).
    `device` defaults to `cuda:<LOCAL_RANK>` and raises without a card;
    pass "cpu" to run on the CPU."""
    env = os.environ
    distributed = "WORLD_SIZE" in env
    rank, size = (int(env["RANK"]), int(env["WORLD_SIZE"])) if distributed else (0, 1)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (torch.cuda.is_available() is false); "
                               "pass device='cpu' to run on the CPU")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if distributed:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return Mesh(rank, size, device, backend)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every leaf of a global batch: numpy arrays,
    tensors, lists and tuples (per-sample names) cut on their leading axis,
    nested dicts recursed; scalars and 0-d arrays kept whole."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)) or getattr(batch, "ndim", 0) >= 1:
        return batch[mesh.rows(len(batch))]
    return batch


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank (in place)."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


@contextlib.contextmanager
def data_parallel(mesh: Mesh):
    """Within this block the train forward and the losses compute the
    global batch's values from this rank's rows."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Mesh | None:
    """The mesh of the enclosing `data_parallel` block, or None."""
    return _ACTIVE.get()


def world_size() -> int:
    """The number of ranks the enclosing `data_parallel` block spans (1
    outside one)."""
    mesh = _ACTIVE.get()
    return 1 if mesh is None else mesh.size


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks of the enclosing `data_parallel` block;
    `t` itself outside one. For counts and mask sums: `t` carries no
    gradient."""
    if _ACTIVE.get() is None:
        return t
    if t.requires_grad:
        raise ValueError("global_sum sums counts, which carry no gradient")
    out = t.clone()
    dist.all_reduce(out)
    return out


@torch.no_grad()
def sum_gradients(params, mesh: Mesh) -> None:
    """Replace each parameter's gradient by its sum over the ranks: one
    all-reduce per dtype over the flattened gradients. At one rank the sum
    is the gradient itself, and nothing runs (the flatten and the copies
    back are a copy per parameter tensor, 1,072 in the W48 DaNet)."""
    if mesh.size == 1:
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()


@torch.no_grad()
def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch of a per-row tensor whose rows this rank holds:
    each rank writes its rows into a zero buffer of the global batch and
    the buffers are summed, which is exact (every other addend is 0).
    bf16 and fp16 go through fp32 (exactly), for backends without them."""
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    out = wide.new_zeros((t.shape[0] * mesh.size,) + tuple(t.shape[1:]))
    out[mesh.rows(out.shape[0])] = wide
    dist.all_reduce(out)
    return out.to(t.dtype)
