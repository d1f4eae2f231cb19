"""Training loop: two-stage schedule, checkpoint and mid-epoch resume,
metric logging (port of the JAX package's `train/trainer.py`, reference
`train/base_trainer.py` + `train/trainer.py`).

An epoch loop with mid-epoch resume; `step < pretr_step` runs the IUV-only
pretrain step, later steps the full one; a checkpoint every
`checkpoint_steps`, scalar summaries every `summary_steps`, and a
wall-clock budget (`time_to_run`) that checkpoints and returns, for
requeue environments. The host runs the input pipeline and the fits
lookup; the step runs on the model's device.

The step's noise (STN jitter, PartDrop) comes from a `torch.Generator` on
the model's device seeded from (train.seed + 1, step), as the JAX step
folds the step into its key: a resumed run draws the same noise with no
generator state in the checkpoint.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.config import Config
from danet_densepose2smpl_tpu_torch.core.checkpoint import CheckpointManager, MetricLogger, ResumePoint
from danet_densepose2smpl_tpu_torch.data.loader import PrefetchLoader, ResumableLoader
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel
from danet_densepose2smpl_tpu_torch.train.fits_dict import FitsDict
from danet_densepose2smpl_tpu_torch.train.step import (
    TrainState,
    batch_to_device,
    create_train_state,
    make_train_step,
)

_HOST_KEYS = ("imgname", "maskname", "partname")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's noise: a pure function of (seed, step)."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + step) % 2**63)


class Trainer:
    def __init__(
        self,
        cfg: Config,
        dataset,                      # MixedDataset or NpzDataset
        smpl: SMPLModel,
        renderer,                     # IUVRenderer or None
        fits: FitsDict,
        workdir: str,
        device="cuda",
        mesh=None,
        time_to_run: float | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel training (mesh=) is not ported to PyTorch yet (ROADMAP.md queue 1, item 19)")
        self.cfg = cfg
        self.dataset = dataset
        self.smpl = smpl
        self.renderer = renderer
        self.fits = fits
        self.workdir = workdir
        self.device = torch.device(device)
        self.time_to_run = time_to_run
        self.start_time = time.time()
        self._vis_said = False

        self.loader = ResumableLoader(dataset, cfg.train.batch_size, seed=cfg.train.seed)
        if cfg.train.prefetch_workers != 0:
            workers = None if cfg.train.prefetch_workers < 0 else cfg.train.prefetch_workers
            self.loader = PrefetchLoader(self.loader, workers=workers)

        model = random_init_(DaNet(cfg.danet), seed=cfg.train.seed)
        self.state: TrainState = create_train_state(
            model.to(self.device, memory_format=torch.channels_last), cfg)
        is_itw = cfg.train.train_data == "h36m_coco_itw"
        common = dict(renderer=renderer, is_itw=is_itw)
        self.step_pretrain = make_train_step(self.state.model, smpl, cfg, pretrain_mode=True, **common)
        self.step_full = make_train_step(self.state.model, smpl, cfg, pretrain_mode=False, **common)

        self.ckpt = CheckpointManager(f"{workdir}/checkpoints")
        self.logger = MetricLogger(f"{workdir}/metrics.jsonl")
        self.resume = ResumePoint(0, 0, 0)

        restored = self.ckpt.restore(self.state)
        if restored is not None:
            self.state, self.resume = restored
            print(f"resumed from step {self.resume.step} (epoch {self.resume.epoch}, batch {self.resume.batch_idx})")

    def _out_of_time(self) -> bool:
        return self.time_to_run is not None and (time.time() - self.start_time) > self.time_to_run

    def _device_batch(self, batch: dict) -> dict:
        names = batch.pop("dataset_name", ["" for _ in range(len(batch["sample_index"]))])
        if isinstance(names, str):
            names = [names]
        for k in _HOST_KEYS:
            batch.pop(k, None)

        opt_pose, opt_betas, opt_valid = self.fits.lookup(
            names, batch["sample_index"], batch["rot_angle"], batch["is_flipped"]
        )
        batch["opt_pose"] = opt_pose
        batch["opt_betas"] = opt_betas
        batch["opt_valid"] = opt_valid
        batch["is_dp_dataset"] = np.array([n == "dp_coco" for n in names], np.float32)
        return batch_to_device(batch, self.device)

    def train(self, num_epochs: int | None = None) -> TrainState:
        cfg = self.cfg
        epochs = num_epochs if num_epochs is not None else cfg.train.num_epochs
        step_count = self.resume.step
        start_epoch, start_batch = self.resume.epoch, self.resume.batch_idx

        # steps run asynchronously on the card; wall time is taken per
        # summary window, after a read of the window's last loss, so timing
        # never serializes the pipeline
        window_start = time.time()
        window_steps = 0
        for epoch in range(start_epoch, epochs):
            for b_idx, batch in self.loader.epoch(epoch, start_batch if epoch == start_epoch else 0):
                pretrain = step_count < cfg.train.pretr_step
                step_fn = self.step_pretrain if pretrain else self.step_full
                batch = self._device_batch(batch)
                gen = step_generator(cfg.train.seed + 1, step_count, self.device)
                self.state, metrics = step_fn(self.state, batch, gen)
                step_count += 1
                window_steps += 1

                if step_count % cfg.train.summary_steps == 0:
                    # the read (one copy to the host, which waits for every
                    # step queued in this window) comes BEFORE the clock
                    names = list(metrics)
                    values = torch.stack([metrics[k].double() for k in names]).tolist()
                    dt = (time.time() - window_start) / max(window_steps, 1)
                    row = dict(zip(names, values))
                    row["step_time_s"] = dt
                    row["imgs_per_sec"] = cfg.train.batch_size / max(dt, 1e-9)
                    self.logger.log(step_count, row)
                    print(f"e{epoch} b{b_idx} step {step_count} "
                          f"loss {row['loss_total']:.3f} ({dt * 1e3:.0f} ms/step)"
                          + (" [pretrain]" if pretrain else ""))
                    window_start = time.time()
                    window_steps = 0

                if step_count % cfg.train.checkpoint_steps == 0:
                    self.ckpt.save(self.state, ResumePoint(epoch, b_idx + 1, step_count))

                if cfg.train.vis_interval and step_count % cfg.train.vis_interval == 0 and not self._vis_said:
                    self._vis_said = True
                    print("training visualization is not ported to PyTorch yet (ROADMAP.md queue 1, "
                          "item 18.3); training goes on without it")

                if self._out_of_time():
                    print("time budget exceeded; checkpointing and exiting")
                    self.ckpt.save(self.state, ResumePoint(epoch, b_idx + 1, step_count))
                    return self.state

        self.ckpt.save(self.state, ResumePoint(epochs, 0, step_count))
        return self.state
