"""COCO keypoint OKS AP evaluation (port of the JAX package's
`cli/eval_coco.py`; reference `eval_coco.py`): SMPL joints -> COCO-17 ->
perspective projection -> the inverse crop transform -> the OKS AP table.

Usage:
  python -m danet_densepose2smpl_tpu_torch.cli.eval_coco --npz coco_labels.npz \\
      --img_dir images/ [--torch_checkpoint model.pt] [--coco_gt_json person_keypoints_val2014.json]
Fixture run on the CPU:
  python -m danet_densepose2smpl_tpu_torch.cli.eval_coco --cpu --synthetic-data --num_samples 8 \\
      --batch_size 4 --num_verts 500

Runs on cuda:0 unless --cpu is given. The model runs in fp32 whatever
--bf16 says, as the JAX CLI's does: each keypoint's confidence is the
predicted foreground probability (1 - P(background) of the part-index
softmax) at its projected position.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.cli.common import (
    add_common_args,
    build_model_and_params,
    load_assets,
    refuse_hmr,
    resolve_device,
)

AP_NAMES = ("AP", "AP50", "AP75", "APm", "APl", "AR", "AR50", "AR75", "ARm", "ARl")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--npz", default=None)
    p.add_argument("--img_dir", default=None)
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--num_samples", type=int, default=32)
    p.add_argument("--result_file", default=None)
    p.add_argument("--coco_gt_json", default=None,
                   help="person_keypoints_*.json; when given, AP is scored against the full COCO GT "
                        "(crowds and all persons) as pycocotools' COCOeval would")
    return p


def ap_table(regressor: str, ap: dict) -> str:
    """The markdown AP table in the reference's _print_name_value layout
    (eval_coco.py:178-194)."""
    return "\n".join([
        "| Arch " + " ".join(f"| {n}" for n in AP_NAMES) + " |",
        "|---" * (len(AP_NAMES) + 1) + "|",
        "| " + regressor + " " + " ".join(f"| {ap[n]:.3f}" for n in AP_NAMES) + " |",
    ])


def main(argv=None) -> tuple[dict, np.ndarray]:
    """Parse `argv`, evaluate, print the AP table, and return (the AP
    dict, the predictions (N, 17, 3) in original-image coordinates)."""
    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
    from danet_densepose2smpl_tpu_torch.data.loader import ResumableLoader
    from danet_densepose2smpl_tpu_torch.eval.coco_harness import run_coco_eval
    from danet_densepose2smpl_tpu_torch.serve import Predictor, refuse_gt_modes

    args = build_parser().parse_args(argv)
    refuse_hmr(args, "cli.eval_coco")
    device = resolve_device(args)
    cfg = load_config(args.cfg)
    refuse_gt_modes(cfg.danet, "cli.eval_coco")
    if args.synthetic_data:
        args.synthetic_assets = True
    smpl = load_assets(args)[0]
    model = build_model_and_params(args, cfg, device)

    if args.synthetic_data:
        import tempfile

        from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset

        tmp = tempfile.mkdtemp(prefix="danet_coco_")
        args.npz, args.img_dir = write_synthetic_dataset(tmp, n=args.num_samples)
    if args.npz is None:
        raise SystemExit("--npz required (or --synthetic-data)")

    ds = NpzDataset(args.npz, args.img_dir, name="coco", is_train=False, heatmap_size=cfg.danet.heatmap_size)
    loader = ResumableLoader(ds, args.batch_size, shuffle=False, drop_last=False)
    predictor = Predictor(device, torch.float32, smpl=smpl, model=model)

    def infer_fn(img):
        out = predictor.run_model(img)
        # per-keypoint confidence source: the predicted foreground probability
        fg_prob = 1.0 - torch.softmax(out["iuv_raw"]["index"].float(), dim=-1)[..., 0]
        return out["para"], fg_prob

    ap, preds = run_coco_eval(infer_fn, loader.epoch(0), smpl, img_res=cfg.danet.img_size,
                              imgnames=ds.imgname, gt_json=args.coco_gt_json, fg_conf=True)
    print(ap_table(args.regressor, ap))
    if args.result_file:
        np.savez(args.result_file, preds=preds, **ap)
        print(f"saved {args.result_file}")
    return ap, preds


if __name__ == "__main__":
    main()
