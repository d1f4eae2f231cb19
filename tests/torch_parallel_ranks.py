"""The ranks of `tests/test_torch_parallel.py`: processes started by
`torch.multiprocessing` that join a gloo process group on the CPU through
`parallel.make_mesh` (the environment `torchrun` would give them) and run
the port's data-parallel step and eval. This module imports the port
only, never jax, so a rank starts in seconds.

The case: the ResNet-18 DaNet of `configs/danet_tiny_test.yaml` at 64 px
(heatmap 16), f64, seeded random weights, a global batch of 8 synthetic
raw samples whose masks differ between the two ranks' halves (so per-rank
averages differ from the global ones), the synthetic soup atlas.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig, SolverConfig
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
from danet_densepose2smpl_tpu_torch.eval.harness import make_eval_step, synthetic_h36m_regressor
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.parallel import make_mesh, replicate, shard_batch
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

SIZE, GLOBAL_BATCH, NUM_VERTS = 64, 8, 500
QUIET = dict(partdrop_rate=0.0, stn_center_jitter=0.0, stn_scale_jitter=0.0)


def case_cfg(optimizer: str = "adam") -> Config:
    """The tiny config's ResNet-18 at 64 px, PartDrop and the STN jitter
    off (the noise's rows are `test_draw_noise_keeps_this_ranks_rows`'),
    so that the averaging is what the per-rank run gets wrong. The
    references step with SGD: they are compared on the losses, gradients
    and statistics, which the optimizer does not touch, and Adam's moments
    of the 50M f64 parameters cost 0.8 GB and seconds."""
    return Config(danet=DaNetConfig(iuv_regressor="resnet", msres_num_layers=18, img_size=SIZE,
                                    heatmap_size=SIZE // 4, **QUIET), solver=SolverConfig(optimizer=optimizer))


def case_batch(cfg: Config) -> dict:
    """8 raw samples; the masks' counts differ between rows 0-3 and 4-7."""
    raw = synthetic_raw_batch(cfg, GLOBAL_BATCH, seed=6, num_dp_points=32)
    raw["has_smpl"] = np.array([1, 1, 1, 1, 1, 0, 0, 1], np.float32)
    raw["has_dp"] = np.array([0, 1, 0, 0, 1, 1, 0, 1], np.float32)
    raw["is_dp_dataset"] = np.array([0, 0, 0, 0, 1, 0, 1, 0], np.float32)
    raw["has_pose_3d"] = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    return raw


@functools.lru_cache(maxsize=1)
def case_weights(danet: DaNetConfig) -> dict:
    return random_init_(DaNet(danet), seed=0).double().state_dict()


def case_model(cfg: Config) -> DaNet:
    """The seeded random f64 model (its weights drawn once a process)."""
    model = DaNet(cfg.danet).double()
    model.load_state_dict(case_weights(cfg.danet), strict=True)
    return model


def case_smpl():
    return synthetic_smpl_model(NUM_VERTS)


def run_step(cfg: Config, batch: dict, mesh=None) -> dict:
    """One f64 step (from `case_model`) on `batch` (this rank's rows with
    `mesh`): the metrics, the gradients (summed over the ranks with
    `mesh`), the parameters after the step and the BatchNorm statistics,
    as CPU tensors."""
    smpl = case_smpl()
    model = case_model(cfg)
    if mesh is not None:
        replicate(model, mesh)
    state = create_train_state(model, cfg)
    step = make_train_step(model, smpl, cfg, renderer=IUVRenderer(synthetic_densepose_atlas(smpl), SIZE, SIZE // 4),
                           mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    state, metrics = step(state, batch_to_device(batch, "cpu", torch.float64), gen)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "stats": {k: b.clone() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))}}


def eval_inputs():
    rng = np.random.RandomState(3)
    b = GLOBAL_BATCH
    return (rng.rand(b, SIZE, SIZE, 3), rng.randn(b, 72) * 0.2, rng.randn(b, 10) * 0.3, np.zeros(b, np.int32),
            np.concatenate([rng.randn(b, 24, 3) * 0.3, np.ones((b, 24, 1))], -1))


def run_eval(mesh=None):
    """The pose eval step of an eval-mode f64 model on `eval_inputs()` (the
    global batch; with `mesh` each rank runs its rows): (mpjpe, pa, para)."""
    model = case_model(case_cfg())
    smpl = case_smpl()
    mapper = np.arange(14)
    step = make_eval_step(lambda img: model(torch.as_tensor(img))["para"], smpl,
                          synthetic_h36m_regressor(NUM_VERTS, seed=1), mapper, mapper, False, mesh=mesh)
    (mpjpe, pa), para = step(*eval_inputs())
    return mpjpe.clone(), pa.clone(), para.clone()


def rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank: the data-parallel step on its rows of the global batch;
    the single-process step on its rows with the losses and gradients
    averaged over the ranks, as plain DDP would; the data-parallel eval.
    Writes them to `out_dir/rank<rank>.pt`."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    t0 = time.perf_counter()
    mesh = make_mesh("cpu")
    try:
        cfg = case_cfg()
        rows = shard_batch(case_batch(cfg), mesh)
        out = {"dp": run_step(cfg, rows, mesh)}
        local = run_step(case_cfg("sgd"), rows)
        for g in local["grads"].values():
            torch.distributed.all_reduce(g)
            g /= world
        names = list(local["metrics"])
        values = torch.tensor([local["metrics"][k] for k in names], dtype=torch.float64)
        torch.distributed.all_reduce(values)
        local["metrics"] = dict(zip(names, (values / world).tolist()))
        del local["params"]                    # compared on losses, gradients and statistics only
        out["per_rank"] = local
        out["eval"] = run_eval(mesh)
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.close()
