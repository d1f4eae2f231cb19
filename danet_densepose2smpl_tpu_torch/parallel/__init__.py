"""Data parallelism over a process group (port of the JAX package's
`parallel/`).

The JAX package shards the batch over a 1-D device mesh and lets GSPMD
insert the collectives: the sharded step *is* the single-device step on
the global batch. Here each rank is a process (`torchrun`, or a world of
one), holds rows `rank*b:(rank+1)*b` of the global batch, and the step
reproduces the global batch's semantics explicitly: inside
`data_parallel(mesh)` every train-mode BatchNorm normalizes with the
global batch's statistics and every loss is this rank's share of the
global loss; the step sums the ranks' gradients. Parameters are
replicated (`replicate` broadcasts rank 0's).
"""

from danet_densepose2smpl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    active_mesh,
    all_gather_rows,
    data_parallel,
    global_sum,
    make_mesh,
    replicate,
    shard_batch,
    sum_gradients,
    world_size,
)
