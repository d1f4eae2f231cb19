"""The reference training step, in fp32: a frozen copy of the port's
`train/step.py::make_train_step` on one process, with the model forward
outside autocast whatever `cfg.danet.compute_dtype` says.

raw batch -> `device_preprocess_train` (the ingest) -> `prepare_targets`
(GT raster) -> train-mode forward -> losses -> backward -> Adam (optax's
constants, bias-corrected moments, eps outside the square root), with the
learning rate of `make_lr_schedule` set every step.
"""

from __future__ import annotations

from typing import Callable

import torch

from port_bench.reference.config import Config
from port_bench.reference.data.pipeline import device_preprocess_train
from port_bench.reference.smpl.loader import SMPLModel
from port_bench.reference.train.objective import compute_losses
from port_bench.reference.train.prepare import prepare_targets


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """x0.1 at each SOLVER.STEPS boundary after the first."""
    base, boundaries = cfg.solver.base_lr, [int(s) for s in cfg.solver.steps[1:]]

    def schedule(step: int) -> float:
        lr = base
        for boundary in boundaries:
            if step >= boundary:
                lr *= 0.1
        return lr

    return schedule


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8), one tensor at a time."""
    if cfg.solver.optimizer != "adam":
        raise ValueError(f"the reference trains with adam, not '{cfg.solver.optimizer}'")
    return torch.optim.Adam(params, lr=cfg.solver.base_lr, betas=(0.9, 0.999), eps=1e-8, foreach=False)


def make_train_step(model: torch.nn.Module, smpl: SMPLModel, cfg: Config, renderer=None) -> Callable:
    """step(optimizer, step_index, batch, generator) -> (loss_total, losses).
    `smpl` holds tensors on the model's device; `batch` is a raw batch
    (`raw_img`, `pixel_noise`, the crop parameters and the GT fits)."""
    schedule = make_lr_schedule(cfg)

    def step(opt: torch.optim.Optimizer, index: int, batch: dict, generator: torch.Generator):
        batch = dict(batch)
        batch["img"] = device_preprocess_train(
            batch.pop("raw_img"), batch["center"], batch["scale"], batch["rot_angle"],
            batch["is_flipped"], batch.pop("pixel_noise"), out_size=cfg.danet.img_size)
        batch = prepare_targets(cfg, smpl, batch, renderer=renderer)
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(batch["img"], generator=generator)
        total, losses = compute_losses(
            cfg.danet, smpl, out, batch, openpose_weight=cfg.train.openpose_train_weight,
            gt_weight=cfg.train.gt_train_weight)
        total.backward()
        for group in opt.param_groups:
            group["lr"] = schedule(index)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
        return total.detach(), {k: v.detach() for k, v in losses.items()}

    return step
