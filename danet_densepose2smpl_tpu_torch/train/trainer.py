"""Training loop: two-stage schedule, checkpoint and mid-epoch resume,
metric logging (port of the JAX package's `train/trainer.py`, reference
`train/base_trainer.py` + `train/trainer.py`).

An epoch loop with mid-epoch resume; `step < pretr_step` runs the IUV-only
pretrain step, later steps the full one; a checkpoint every
`checkpoint_steps`, scalar summaries every `summary_steps`, and a
wall-clock budget (`time_to_run`) that checkpoints and returns, for
requeue environments; every `vis_interval` steps, two PNGs of panels
(`_save_vis`; in the GT input modes, whose eval forward needs a GT render,
one printed line instead). The host runs the input pipeline and the fits lookup; the
step runs on the model's device.

The step's noise (STN jitter, PartDrop) comes from a `torch.Generator` on
the model's device seeded from (train.seed + 1, step), as the JAX step
folds the step into its key: a resumed run draws the same noise with no
generator state in the checkpoint.

With `mesh` (`parallel.make_mesh`; `cli.train --data_parallel`) the run is
data-parallel: `train.batch_size` is the global batch; each rank's loader
assembles only its rows of each global batch (bit for bit those of the
single-process loader), the model starts from rank 0's weights
(`parallel.replicate`) and steps through the data-parallel train step.
Every rank restores the same checkpoint; only rank 0 writes checkpoints,
metrics, vis PNGs and the summary lines. The time budget is checked
collectively, so all ranks stop at the same step.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.config import Config
from danet_densepose2smpl_tpu_torch.core.checkpoint import CheckpointManager, MetricLogger, ResumePoint
from danet_densepose2smpl_tpu_torch.data.loader import PrefetchLoader, ResumableLoader
from danet_densepose2smpl_tpu_torch.models.danet import GT_MODES, DaNet
from danet_densepose2smpl_tpu_torch.parallel.mesh import replicate
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel, to_torch
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
        self.cfg = cfg
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0   # the rank that writes
        self.dataset = dataset
        self.smpl = smpl
        self.renderer = renderer
        self.fits = fits
        self.workdir = workdir
        self.device = torch.device(device) if mesh is None else mesh.device
        self.time_to_run = time_to_run
        self.start_time = time.time()
        self._vis_smpl = {}               # dtype -> the SMPL tables on the device, for the vis step

        rows = None if mesh is None else mesh.rows(cfg.train.batch_size)
        self.loader = ResumableLoader(dataset, cfg.train.batch_size, seed=cfg.train.seed, rows=rows)
        if cfg.train.prefetch_workers != 0:
            workers = None if cfg.train.prefetch_workers < 0 else cfg.train.prefetch_workers
            self.loader = PrefetchLoader(self.loader, workers=workers)

        model = random_init_(DaNet(cfg.danet), seed=cfg.train.seed)
        self.state: TrainState = create_train_state(
            model.to(self.device, memory_format=torch.channels_last), cfg)
        is_itw = cfg.train.train_data == "h36m_coco_itw"
        common = dict(renderer=renderer, is_itw=is_itw, mesh=mesh)
        self.step_pretrain = make_train_step(self.state.model, smpl, cfg, pretrain_mode=True, **common)
        self.step_full = make_train_step(self.state.model, smpl, cfg, pretrain_mode=False, **common)

        self.ckpt = CheckpointManager(f"{workdir}/checkpoints")
        self.logger = MetricLogger(f"{workdir}/metrics.jsonl") if self.lead else None
        self.resume = ResumePoint(0, 0, 0)

        restored = self.ckpt.restore(self.state)
        if restored is not None:
            self.state, self.resume = restored
            self._print(f"resumed from step {self.resume.step} (epoch {self.resume.epoch}, "
                        f"batch {self.resume.batch_idx})")
        elif mesh is not None:
            replicate(self.state.model, mesh)

    def _print(self, line: str) -> None:
        if self.lead:
            print(line)

    def _save(self, resume: ResumePoint) -> None:
        if self.lead:
            self.ckpt.save(self.state, resume)

    def _out_of_time(self) -> bool:
        if self.time_to_run is None:
            return False
        late = (time.time() - self.start_time) > self.time_to_run
        if self.mesh is None:
            return late
        flag = torch.tensor([float(late)], device=self.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

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

                if self.lead and step_count % cfg.train.summary_steps == 0:
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
                    self._save(ResumePoint(epoch, b_idx + 1, step_count))

                if self.lead and cfg.train.vis_interval and step_count % cfg.train.vis_interval == 0:
                    if cfg.danet.input_mode in GT_MODES:
                        # the vis forward runs the eval model, which has no
                        # GT render to take (JAX's vis fails there, and its
                        # Trainer swallows the failure)
                        print(f"step {step_count}: vis skipped: input_mode='{cfg.danet.input_mode}' needs the GT "
                              "IUV render in the forward, and the vis step runs the model without GT")
                    else:
                        self._save_vis(batch, step_count)

                if self._out_of_time():
                    self._print("time budget exceeded; checkpointing and exiting")
                    self._save(ResumePoint(epoch, b_idx + 1, step_count))
                    return self.state

        self._save(ResumePoint(epochs, 0, step_count))
        return self.state

    @torch.no_grad()
    def vis_panels(self, device_batch: dict):
        """The panels of one vis step (JAX `train/trainer.py:160-293`): an
        eval-mode forward of the trainer's model (in the training dtype) on
        the first 4 samples; raw batches (`--device_preprocess`) are cropped
        by `device_preprocess_train` first. Returns (rows, sheets): rows of
        per-sample panels as [(title, [panel per sample])] (the input with
        the GT keypoint skeleton and the STN centres, the predicted IUV, the
        GT IUV when the batch has it, the predicted SMPL's IUV render
        through the trainer's renderer, and the shaded overlay
        0.35 * img + 0.65 * shade), and sample 0's sheets [(title, image)]
        (the 24-part grid, the heatmap grid). The model's train/eval state
        is restored afterwards."""
        from danet_densepose2smpl_tpu_torch.data.pipeline import device_preprocess_train
        from danet_densepose2smpl_tpu_torch.kernels.rasterizer import render_shaded
        from danet_densepose2smpl_tpu_torch.ops.iuvmap import iuv_map2img
        from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward
        from danet_densepose2smpl_tpu_torch.utils.vis import (
            denormalize_image,
            draw_points,
            draw_skeleton,
            heatmap_grid,
            part_grid,
            partial_iuv_images,
        )

        res = self.cfg.danet.img_size
        if "img" in device_batch:
            imgs = device_batch["img"][:4]
        else:
            imgs = device_preprocess_train(
                device_batch["raw_img"][:4], device_batch["center"][:4], device_batch["scale"][:4],
                device_batch["rot_angle"][:4], device_batch["is_flipped"][:4], device_batch["pixel_noise"][:4],
                out_size=res)
        model = self.state.model
        was_training = model.training
        mixed = self.cfg.danet.compute_dtype == "bfloat16"
        autocast = torch.autocast(self.device.type, dtype=torch.bfloat16) if mixed else contextlib.nullcontext()
        model.eval()
        try:
            with autocast:
                out = model(imgs)
        finally:
            model.train(was_training)

        def host(t):
            return t.float().cpu().numpy() if t.dtype in (torch.bfloat16, torch.float16) else t.cpu().numpy()

        pred_iuv = host(iuv_map2img(*out["iuv_clean"]))
        n = pred_iuv.shape[0]
        images = [denormalize_image(host(imgs[k])) for k in range(n)]
        est = out["iuv_raw"]
        centers = host(est["stn_centers"]) if "stn_centers" in est else None
        key = "smpl_2dkps" if "smpl_2dkps" in device_batch else "target_smpl_kps"
        gt_kps = host(device_batch[key][:n]) if key in device_batch else None
        inputs = []
        for k in range(n):
            panel = images[k]
            if gt_kps is not None:
                panel = draw_skeleton(panel, 0.5 * res * (gt_kps[k, :, :2] + 1.0))
            if centers is not None:
                panel = draw_points(panel, 0.5 * res * (centers[k] + 1.0))
            inputs.append(panel)

        rows = [("input / GT kps / STN", inputs), ("pred IUV", [np.clip(pred_iuv[k], 0, 1) for k in range(n)])]
        if "uv_image_gt" in device_batch:
            gt = host(device_batch["uv_image_gt"][:n])
            rows.append(("GT IUV", [np.clip(gt[k], 0, 1) for k in range(n)]))
        if self.renderer is not None and "pred_cam" in out:
            # the predicted mesh, as the reference renders it each vis step
            # (no try/except as in JAX: a failing raster launch raises)
            dt = torch.float64 if out["pred_cam"].dtype == torch.float64 else torch.float32
            if dt not in self._vis_smpl:
                self._vis_smpl[dt] = to_torch(self.smpl, self.device, dt)
            smpl_t = self._vis_smpl[dt]
            cam = out["pred_cam"].to(dt)
            verts = smpl_forward(smpl_t, out["pred_shape"].to(dt), out["pred_rotmat"].to(dt)).vertices
            rendered = host(self.renderer(verts, cam))
            sh = host(render_shaded(verts, smpl_t.faces, cam, out_size=res, orig_size=float(res)))
            rows.append(("rendered IUV (pred)", [np.clip(rendered[k], 0, 1) for k in range(n)]))
            rows.append(("pred mesh overlay", [
                np.where(sh[k][..., None] > 0, 0.35 * images[k] + 0.65 * sh[k][..., None], images[k])
                for k in range(n)]))

        sheets = []
        if "part_iuv_clean" in out:
            sheets.append(("24-part partial IUV (pred)", part_grid(partial_iuv_images(host(out["part_iuv_clean"][0])))))
        if "heatmaps" in est:
            sheets.append(("24 joint heatmaps", np.clip(heatmap_grid(host(est["heatmaps"][0])), 0, 1)))
        return rows, sheets

    def _save_vis(self, device_batch: dict, step_count: int) -> None:
        """Write `vis/step_XXXXXXX.png` (a row of panels per kind, a column
        per sample, each panel scaled to img_size) and
        `vis/step_XXXXXXX_parts.png` (sample 0's sheets side by side) under
        the workdir. Errors raise: unlike the JAX Trainer, a failing vis
        (a kernel launch included) stops training."""
        import os

        from danet_densepose2smpl_tpu_torch.utils.vis import save_rows

        rows, sheets = self.vis_panels(device_batch)
        vis_dir = os.path.join(self.workdir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        save_rows([panels for _, panels in rows], os.path.join(vis_dir, f"step_{step_count:07d}.png"))
        if sheets:
            save_rows([[sheet for _, sheet in sheets]], os.path.join(vis_dir, f"step_{step_count:07d}_parts.png"))
