"""3D pose / segmentation evaluation (port of the JAX package's
`cli/eval.py`; reference `eval.py`): datasets h36m-p1 / h36m-p2, 3dpw and
mpi-inf-3dhp (MPJPE and PA-MPJPE in mm; the H36M-P2 per-action table) and
lsp (silhouette and part accuracy and F1 through the part renderer).

Usage:
  python -m danet_densepose2smpl_tpu_torch.cli.eval --dataset h36m-p2 \\
      --npz labels.npz --img_dir images/ [--torch_checkpoint model.pt]
Fixture run on the CPU:
  python -m danet_densepose2smpl_tpu_torch.cli.eval --cpu --dataset h36m-p2 \\
      --synthetic-data --num_samples 8 --batch_size 4 --num_verts 500

Runs on cuda:0 unless --cpu is given. The model runs through
`serve.Predictor` (--bf16: bf16 weights and activations, fp32 `para`).
With --device_preprocess the host only decodes the frames (of one size);
the crop and normalization run on the card (`data/pipeline.py`).
--regressor hmr evaluates the HMR/SPIN baseline instead (pose datasets and
lsp), from the default mean parameters and always in fp32 (without TF32),
whatever --bf16 says, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.cli.common import (
    add_common_args,
    build_model_and_params,
    load_assets,
    resolve_device,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--dataset", default="h36m-p2", choices=["h36m-p1", "h36m-p2", "3dpw", "mpi-inf-3dhp", "lsp"])
    p.add_argument("--npz", default=None, help="SPIN-format labels npz")
    p.add_argument("--img_dir", default=None)
    p.add_argument("--synthetic-data", action="store_true", help="run on a generated fixture dataset")
    p.add_argument("--num_samples", type=int, default=32, help="fixture dataset size")
    p.add_argument("--result_file", default=None, help="npz dump of the per-sample errors")
    p.add_argument("--log_freq", type=int, default=10)
    p.add_argument("--device_preprocess", action="store_true",
                   help="decode-only host path: raw frames go to the card, where crop, resize and "
                        "normalization run before the model (uniform frame sizes required)")
    p.add_argument("--prefetch", type=int, default=0, metavar="N",
                   help="decode batches with N threads ahead of the card (PrefetchLoader; 0 = synchronous)")
    p.add_argument("--annot_dir", default=None,
                   help="upi-s1h annotation root with the maskname/partname GT PNGs for the LSP "
                        "protocol (reference path_config.DATASET_FOLDERS['upi-s1h'])")
    p.add_argument("--vertex_texture", default=None, help="SPIN vertex_texture.npy (per-face render colors)")
    p.add_argument("--cube_parts", default=None, help="SPIN cube_parts.npy (color->part lookup cube)")
    return p


def with_gt_masks(loader, annot_dir: str):
    """Batches of `loader` with the upi-s1h GT label maps of each sample
    (`gt_mask`, `gt_parts`: lists of uint8 (H, W) arrays), read from the
    PNGs its maskname / partname columns name under `annot_dir`, as
    `cv2.imread(path, 0)` reads them (`data/image_io.read_gray`)."""
    from danet_densepose2smpl_tpu_torch.data.image_io import read_gray

    for b, batch in loader:
        batch["gt_mask"] = [read_gray(os.path.join(annot_dir, n)) for n in batch["maskname"]]
        batch["gt_parts"] = [read_gray(os.path.join(annot_dir, n)) for n in batch["partname"]]
        yield b, batch


def hmr_infer_fn(model, device):
    """para (B, 229) = [cam, shape, rotmats] of (B, H, W, 3) normalized
    images (numpy or tensor) through the HMR baseline, from the default
    mean parameters, in fp32 without TF32 (`full_fp32`)."""
    from danet_densepose2smpl_tpu_torch.models.smpl_regressor import default_mean_params
    from danet_densepose2smpl_tpu_torch.ops.procrustes import full_fp32

    model = model.eval().to(device, torch.float32)
    mp = default_mean_params()
    init = [torch.as_tensor(a, device=device)[None] for a in (mp.pose6d, mp.shape, mp.cam)]

    @torch.inference_mode()
    def infer_fn(img):
        x = torch.as_tensor(img).to(device, torch.float32)
        with full_fp32():
            rotmat, betas, cam = model(x, *init)
        return torch.cat([cam, betas, rotmat.reshape(x.shape[0], 216)], dim=1)

    return infer_fn


def main(argv=None) -> dict:
    """Parse `argv`, evaluate, print the reference's summary lines, and
    return the result: {'pose': PoseEvalResult} or {'lsp': {name: value}}."""
    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
    from danet_densepose2smpl_tpu_torch.data.loader import PrefetchLoader, ResumableLoader
    from danet_densepose2smpl_tpu_torch.eval.harness import run_pose_eval
    from danet_densepose2smpl_tpu_torch.eval.lsp import run_lsp_eval
    from danet_densepose2smpl_tpu_torch.kernels.part_renderer import face_parts_from_assets
    from danet_densepose2smpl_tpu_torch.serve import Predictor, refuse_gt_modes

    args = build_parser().parse_args(argv)
    device = resolve_device(args)
    cfg = load_config(args.cfg)
    if args.regressor == "danet":
        refuse_gt_modes(cfg.danet, "cli.eval")
    if args.synthetic_data:
        args.synthetic_assets = True
    smpl, _, jreg, _, smpl_male, smpl_female = load_assets(args)
    model = build_model_and_params(args, cfg, device)

    if args.synthetic_data:
        import tempfile

        from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset

        tmp = tempfile.mkdtemp(prefix="danet_eval_")
        if args.dataset == "lsp":
            args.npz, args.img_dir, args.annot_dir = write_synthetic_dataset(
                tmp, n=args.num_samples, with_lsp_masks=True)
        else:
            args.npz, args.img_dir = write_synthetic_dataset(tmp, n=args.num_samples, gendered=args.dataset == "3dpw")
        print(f"fixture dataset at {tmp}")
    if args.npz is None:
        raise SystemExit("--npz required (or --synthetic-data)")

    ds = NpzDataset(args.npz, args.img_dir, name=args.dataset, is_train=False,
                    heatmap_size=cfg.danet.heatmap_size, return_raw=args.device_preprocess)
    loader = ResumableLoader(ds, args.batch_size, shuffle=False, drop_last=False)
    if args.prefetch > 0:
        loader = PrefetchLoader(loader, workers=args.prefetch)

    if args.regressor == "hmr":
        infer_fn = hmr_infer_fn(model, device)
    else:
        predictor = Predictor(device, torch.bfloat16 if args.bf16 else torch.float32, smpl=smpl, model=model)

        def infer_fn(img):
            return predictor.run_model(img)["para"]

    if args.dataset == "lsp":
        face_parts = None
        if args.vertex_texture and args.cube_parts:
            face_parts = face_parts_from_assets(args.vertex_texture, args.cube_parts)
        batches = loader.epoch(0)
        if args.annot_dir is not None and ds.maskname is not None and ds.partname is not None:
            batches = with_gt_masks(batches, args.annot_dir)
        scores = run_lsp_eval(infer_fn, batches, smpl, img_size=cfg.danet.img_size, face_parts=face_parts,
                              log_every=args.log_freq, device_preprocess=args.device_preprocess, device=device)
        return {"lsp": scores}

    result = run_pose_eval(
        infer_fn, loader.epoch(0), args.dataset, smpl, jreg,
        smpl_male=smpl_male, smpl_female=smpl_female,
        imgnames=ds.imgname, log_every=args.log_freq,
        device_preprocess=args.device_preprocess, device=device,
    )
    print(result.summary(args.dataset))
    if args.result_file:
        np.savez(args.result_file, mpjpe=result.mpjpe, pa_mpjpe=result.pa_mpjpe)
        print(f"saved {args.result_file}")
    return {"pose": result}


if __name__ == "__main__":
    main()
