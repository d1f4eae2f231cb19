"""Training entry point (port of the JAX package's `cli/train.py`;
reference `train.py` + `train/train_options.py`): two-stage DaNet training
with pretr_step IUV pretraining, mixed datasets, checkpoints with
mid-epoch resume (a second run on the same --log_dir/--name resumes), a
per-run config dump, and a wall-clock budget.

Real data:
  python -m danet_densepose2smpl_tpu_torch.cli.train --name run1 \\
      --datasets h36m=labels.npz:imgdir dp_coco=dp.npz:imgdir \\
      --fits_dir data/final_fits
Fixture run on the CPU:
  python -m danet_densepose2smpl_tpu_torch.cli.train --cpu --synthetic-data \\
      --img_size 64 --batch_size 2 --num_samples 4 --pretr_step 1 --num_epochs 1

Runs on cuda:0 unless --cpu is given. With --device_preprocess the host
only decodes the frames (of one size) and augments the labels; the crop,
rotation, flip, channel noise and normalization run on the card inside the
step (`data/pipeline.device_preprocess_train`).

--data_parallel runs the data-parallel step (`parallel/`): launched by
torchrun, one rank per card, the batch size is the global batch:
  torchrun --nproc_per_node 4 -m danet_densepose2smpl_tpu_torch.cli.train \
      --data_parallel --batch_size 128 ...
Launched plainly, it is a world of one rank (NCCL on cuda:0; gloo with
--cpu). Only rank 0 writes checkpoints, metrics and the run config.
"""

from __future__ import annotations

import argparse
import os

from danet_densepose2smpl_tpu_torch.cli.common import (
    add_common_args,
    dump_run_config,
    load_assets,
    refuse_hmr,
    resolve_device,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--name", default="danet_run")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--pretr_step", type=int, default=None)
    p.add_argument("--train_data", default="h36m_dp", choices=["h36m_dp", "h36m_coco_itw", "single"])
    p.add_argument("--datasets", nargs="*", default=[],
                   help="name=labels.npz:img_dir entries")
    p.add_argument("--fits_dir", default=None, help="SPIN final-fits directory")
    p.add_argument("--uv_symmetry_path", default=None,
                   help="official UV_symmetry_transforms.mat (enables DP flip aug; "
                        "also via $DANET_UV_SYMMETRY)")
    p.add_argument("--static_fits_dir", default=None)
    p.add_argument("--time_to_run", type=float, default=None, help="seconds before clean save+exit")
    p.add_argument("--vis_interval", type=int, default=None)
    p.add_argument("--summary_steps", type=int, default=None)
    p.add_argument("--resume", action="store_true", help="(default behavior: auto-resume from workdir)")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the global batch over the ranks of a torchrun launch (one rank without one)")
    p.add_argument("--device_preprocess", action="store_true",
                   help="decode-only host path: raw frames go to the card, where crop, rotation, flip, "
                        "noise and normalization run inside the train step (uniform frame sizes required)")
    # NB: --bf16 comes from add_common_args; for training it means mixed
    # precision (bf16 forward, fp32 master params/BN stats/losses)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the IUV backbone in backward (danet.remat_backbone; the YAML's "
                        "REMAT_SCOPE picks backbone / modules / early)")
    p.add_argument("--raster_cull", action="store_true",
                   help="backface-cull the GT IUV raster (exact on closed meshes like the real "
                        "SMPL; switches itself off with a warning if the atlas mesh is unorientable)")
    p.add_argument("--raster_cull_budget", type=float, default=0.55,
                   help="fraction of faces the culled raster keeps per item")
    return p


def setup(args):
    """Everything a run needs before its Trainer, from parsed flags:
    (device, cfg, train dataset, SMPL model, GT IUV renderer, fits)."""
    refuse_hmr(args, "cli.train")
    device = resolve_device(args)

    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
    from danet_densepose2smpl_tpu_torch.data.mixed import H36M_DP_PARTITION, MixedDataset, itw_partition
    from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
    from danet_densepose2smpl_tpu_torch.smpl.densepose_methods import find_uv_symmetry
    from danet_densepose2smpl_tpu_torch.train.fits_dict import FitsDict

    overrides = {"train.batch_size": args.batch_size, "train.train_data": args.train_data}
    if args.num_epochs is not None:
        overrides["train.num_epochs"] = args.num_epochs
    if args.pretr_step is not None:
        overrides["train.pretr_step"] = args.pretr_step
    if args.img_size is not None:
        overrides["danet.img_size"] = args.img_size
        overrides["danet.heatmap_size"] = max(16, args.img_size // 4)
    if args.vis_interval is not None:
        overrides["train.vis_interval"] = args.vis_interval
    if args.summary_steps is not None:
        overrides["train.summary_steps"] = args.summary_steps
    if args.bf16:
        overrides["danet.compute_dtype"] = "bfloat16"
    if args.remat:
        overrides["danet.remat_backbone"] = True
    cfg = load_config(args.cfg, overrides=overrides)

    if args.synthetic_data:
        args.synthetic_assets = True
    smpl, atlas, _, _, _, _ = load_assets(args)

    # --- datasets ---
    uv_symmetry = find_uv_symmetry(args.uv_symmetry_path)
    datasets = {}
    if args.synthetic_data:
        import tempfile

        from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset

        tmp = tempfile.mkdtemp(prefix="danet_train_")
        npz, img_dir = write_synthetic_dataset(tmp, n=args.num_samples, with_dp=True)
        datasets["h36m"] = NpzDataset(npz, img_dir, name="h36m", is_train=True,
                                      heatmap_size=cfg.danet.heatmap_size, uv_symmetry=uv_symmetry,
                                      return_raw=args.device_preprocess)
        args.train_data = "single"
    else:
        for entry in args.datasets:
            name, rest = entry.split("=", 1)
            npz, _, img_dir = rest.partition(":")
            datasets[name] = NpzDataset(npz, img_dir or None, name=name, is_train=True,
                                        heatmap_size=cfg.danet.heatmap_size, uv_symmetry=uv_symmetry,
                                        return_raw=args.device_preprocess)
        if not datasets:
            raise SystemExit("--datasets required (or --synthetic-data)")

    if args.train_data == "h36m_dp" and len(datasets) > 1:
        train_ds = MixedDataset(datasets, H36M_DP_PARTITION)
    elif args.train_data == "h36m_coco_itw":
        train_ds = MixedDataset(datasets, itw_partition({k: len(v) for k, v in datasets.items()}))
    else:
        train_ds = next(iter(datasets.values()))

    # --- fits ---
    if args.fits_dir:
        fits = FitsDict.from_files(list(datasets), args.fits_dir, args.static_fits_dir)
    else:
        fits = FitsDict.from_datasets(datasets)

    # --- image-size coherence for fixture runs (the dataset crops at 224;
    # the crop on the card emits cfg.danet.img_size crops from the frames) ---
    if args.img_size is not None and args.img_size != 224 and not args.device_preprocess:
        train_ds = _Resize(train_ds, args.img_size)

    renderer = IUVRenderer(
        atlas, orig_size=cfg.danet.img_size, out_size=cfg.danet.heatmap_size,
        cull_verts=smpl.v_template if args.raster_cull else None,
        cull_budget_frac=args.raster_cull_budget)
    return device, cfg, train_ds, smpl, renderer, fits


def main(argv=None):
    """Parse `argv`, train, and return the Trainer."""
    from danet_densepose2smpl_tpu_torch.parallel.mesh import make_mesh
    from danet_densepose2smpl_tpu_torch.train.trainer import Trainer

    args = build_parser().parse_args(argv)
    mesh = make_mesh("cpu" if args.cpu else None) if args.data_parallel else None
    try:
        device, cfg, train_ds, smpl, renderer, fits = setup(args)
        workdir = os.path.join(args.log_dir, args.name)
        if mesh is None or mesh.rank == 0:
            dump_run_config(args, cfg, workdir)
        trainer = Trainer(cfg, train_ds, smpl, renderer, fits, workdir, device=device, mesh=mesh,
                          time_to_run=args.time_to_run)
        state = trainer.train()
    finally:
        if mesh is not None:
            mesh.close()
    if trainer.lead:
        print(f"training done at step {int(state.step)}; checkpoints in {workdir}/checkpoints")
    return trainer


class _Resize:
    """Shrink dataset images to the configured size (fixture mode), as
    `cv2.resize` does (`data/transforms.py::resize_bilinear`)."""

    def __init__(self, ds, size):
        self.ds = ds
        self.size = size

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i, rng=None):
        from danet_densepose2smpl_tpu_torch.data.transforms import resize_bilinear

        item = self.ds.__getitem__(i, rng=rng)
        item["img"] = resize_bilinear(item["img"], (self.size, self.size))
        return item


if __name__ == "__main__":
    main()
