"""The training step: raw batch -> GT preparation -> train-mode forward ->
losses -> backward -> optimizer (port of the JAX `train/step.py`).

`make_train_step(model, smpl, cfg, renderer=..., pretrain_mode=...)`
returns `step(state, batch, generator) -> (state, metrics)`, with the JAX
metric names. PyTorch updates the model's parameters and BatchNorm
statistics in place, so the state holds the model and its optimizer.

Mixed precision (`cfg.danet.compute_dtype == 'bfloat16'`) runs the model
forward under `torch.autocast(<device>, torch.bfloat16)`; master params,
optimizer moments, BatchNorm statistics, GT preparation, SMPL and every
loss stay fp32, as in `step.py:93-99` of the JAX package. The geometry
(SMPL chain, crops, raster) runs in matmuls and the raster kernel, never
in TF32: PyTorch leaves `torch.backends.cuda.matmul.allow_tf32` off, and
nothing here turns it on. A batch of raw uint8 frames (`raw_img`, from
`NpzDataset(return_raw=True)`) is first cropped, flipped, noised and
normalized on the model's device, in fp32 and outside autocast
(`data/pipeline.device_preprocess_train`). The stages carry the port's
spans (`utils.profiling.annotate`): each step is an item, `train.step`,
holding train.ingest, .prepare_targets, .forward, .losses, .backward and
.optimizer; outside a profile they are `record_function` ranges and cost
a few microseconds a step. Autograd launches the backward's
kernels on the forward's stream, so `train.backward`'s device time brackets
them whichever thread launches them.

With `mesh` (`parallel.make_mesh`) the step is data-parallel, as the JAX
step with `mesh=` (a GSPMD `jit`, the single-device step on the global
batch): the batch holds this rank's rows of the global batch
(`parallel.shard_batch`), the forward and the losses run inside
`parallel.data_parallel(mesh)` (global BatchNorm statistics, the global
batch's noise, each loss this rank's share of the global one), the ranks'
gradients are summed (one all-reduce per dtype) before the optimizer, and
the metrics are the global losses, the same on every rank. Parameters
start equal on every rank (`parallel.replicate`) and stay equal.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.config import Config
from danet_densepose2smpl_tpu_torch.data.pipeline import device_preprocess_train
from danet_densepose2smpl_tpu_torch.models.danet import GT_MODES
from danet_densepose2smpl_tpu_torch.parallel.mesh import Mesh, data_parallel, sum_gradients
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel, to_torch
from danet_densepose2smpl_tpu_torch.train.objective import compute_losses
from danet_densepose2smpl_tpu_torch.train.prepare import prepare_targets
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """x0.1 at each SOLVER.STEPS boundary after the first, from the step of
    the boundary on (optax.piecewise_constant_schedule: 1e-4 at 29,999,
    1e-5 at 30,000)."""
    base, boundaries = cfg.solver.base_lr, [int(s) for s in cfg.solver.steps[1:]]

    def schedule(step: int) -> float:
        lr = base
        for boundary in boundaries:
            if step >= boundary:
                lr *= 0.1
        return lr

    return schedule


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam with optax.adam's constants (b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root, bias-corrected moments), or SGD with momentum
    0.9; anything else raises. The learning rate is set every step from
    `make_lr_schedule`."""
    lr = cfg.solver.base_lr
    if cfg.solver.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.solver.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    raise ValueError(f"unsupported solver.optimizer '{cfg.solver.optimizer}' (supported: adam, sgd)")


def create_train_state(model: torch.nn.Module, cfg: Config) -> TrainState:
    """The model (already initialized or loaded) in train mode, and its
    optimizer."""
    model.train()
    return TrainState(model, make_optimizer(cfg, model.parameters()), 0)


def batch_to_device(batch: dict, device, float_dtype: torch.dtype = torch.float32) -> dict:
    """Numpy or tensor batch (nested dicts allowed) -> tensors on `device`,
    floating arrays as `float_dtype`; integer arrays (the uint8 raw frames)
    keep their dtype, so frames cross to the card as bytes."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=device)
        return t.to(float_dtype) if t.is_floating_point() else t

    return {k: conv(v) for k, v in batch.items()}


def _to_fp32(tree):
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_fp32(v) for v in tree)
    if torch.is_tensor(tree) and tree.dtype == torch.bfloat16:
        return tree.float()
    return tree


def make_train_step(model: torch.nn.Module, smpl: SMPLModel, cfg: Config, renderer=None,
                    pretrain_mode: bool = False, is_itw: bool = False, mesh: Mesh | None = None) -> Callable:
    """Build step(state, batch, generator) -> (state, metrics).

    `smpl` holds numpy arrays (moved to the model's device at first use) or
    tensors. A batch with `raw_img` and `pixel_noise` (raw frames) gets its
    `img` from `device_preprocess_train` at `cfg.danet.img_size` first.
    When the batch carries raw GT (`opt_pose`, no `opt_rotmat`), the step
    then runs `prepare_targets`, GT IUV raster included. In the input
    modes 'iuv_gt' and 'iuv_gt_feat' the forward takes that render
    (`uv_image_gt`) and the GT SMPL keypoints (`target_smpl_kps`); a batch
    without the render (a step built without a renderer) raises. In
    `pretrain_mode` the regressor does not run; its parameters still take
    an optimizer step with zero gradients, as optax applies one. With
    `mesh`, the step is data-parallel (see the module docstring) and
    `batch` holds this rank's rows."""
    schedule = make_lr_schedule(cfg)
    mixed = cfg.danet.compute_dtype == "bfloat16"
    mode = cfg.danet.input_mode
    smpl_on = {}

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        with annotate("train.step"):
            return run_step(state, batch, generator)

    def run_step(state: TrainState, batch: dict, generator: torch.Generator | None):
        net, opt = state.model, state.optimizer
        device = next(net.parameters()).device
        if device not in smpl_on:
            smpl_on[device] = smpl if torch.is_tensor(smpl.v_template) else to_torch(smpl, device)
        smpl_t = smpl_on[device]
        if "raw_img" in batch:
            with annotate("train.ingest"):
                batch = dict(batch)
                batch["img"] = device_preprocess_train(
                    batch.pop("raw_img"), batch["center"], batch["scale"], batch["rot_angle"],
                    batch["is_flipped"], batch.pop("pixel_noise"), out_size=cfg.danet.img_size)
        if "opt_pose" in batch and "opt_rotmat" not in batch:
            with annotate("train.prepare_targets"):
                batch = prepare_targets(cfg, smpl_t, batch, renderer=renderer, is_itw=is_itw)

        gt = {}
        if mode in GT_MODES:
            if "uv_image_gt" not in batch:
                raise ValueError(f"input_mode='{mode}' trains on the GT IUV render, and the batch has no "
                                 "uv_image_gt: build the step with a renderer")
            gt = {"uv_image_gt": batch["uv_image_gt"], "smpl_kps_gt": batch["target_smpl_kps"]}
        net.train()
        opt.zero_grad(set_to_none=True)
        autocast = (torch.autocast(device.type, dtype=torch.bfloat16) if mixed
                    else contextlib.nullcontext())
        with data_parallel(mesh) if mesh is not None else contextlib.nullcontext():
            with annotate("train.forward"), autocast:
                out = net(batch["img"], pretrain_mode=pretrain_mode, generator=generator, **gt)
            with annotate("train.losses"):
                total, losses = compute_losses(
                    cfg.danet, smpl_t, _to_fp32(out), batch, pretrain_mode=pretrain_mode,
                    openpose_weight=cfg.train.openpose_train_weight, gt_weight=cfg.train.gt_train_weight)
            with annotate("train.backward"):
                total.backward()
        with annotate("train.optimizer"):
            for group in opt.param_groups:
                group["lr"] = schedule(state.step)
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            if mesh is not None:
                sum_gradients([p for group in opt.param_groups for p in group["params"]], mesh)
            opt.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        if mesh is not None:   # the shares -> the global losses
            values = torch.stack(list(metrics.values()))
            torch.distributed.all_reduce(values)
            metrics = dict(zip(metrics, values.unbind()))
        state.step += 1
        return state, metrics

    return step
