"""Single-image inference demo (port of the JAX package's `cli/demo.py`;
reference `demo.py`): per image, DaNet inference and one composite PNG
whose panels are, left to right, the input, the predicted IUV, the IUV
render of the predicted SMPL mesh, the 24-part partial IUV grid, and the
shaded predicted mesh from the front and from the side (`utils/vis.py::
DEMO_PANELS`; no titles), each scaled to the input's height.

Usage:
  python -m danet_densepose2smpl_tpu_torch.cli.demo --img path.jpg [--imglist dir]
      [--checkpoint ckpt_dir | --torch_checkpoint model.pt] [--bf16] --out_dir results/
Fixture run on the CPU:
  python -m danet_densepose2smpl_tpu_torch.cli.demo --cpu --synthetic-assets \\
      --num_verts 500 --img frame.png --out_dir /tmp/demo

Runs on cuda:0 unless --cpu is given. The model runs through
`serve.Predictor` (fp32 without TF32, or bf16 with --bf16); the IUV render
is `IUVRenderer` with the 'xla' backend's contract (`rasterize_flat`) and
the shaded views are `render_shaded`: on the card, the raster kernel.
A frame is padded to a square at the bottom and right and resized to the
config's `img_size` (JAX resizes to 224 px and renders the shaded views at
224 px whatever the config; the two agree at the default 224).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os

import numpy as np
import torch
from torch.profiler import record_function

from danet_densepose2smpl_tpu_torch.cli.common import (
    add_common_args,
    build_model_and_params,
    load_assets,
    refuse_hmr,
    resolve_device,
)
from danet_densepose2smpl_tpu_torch.ops.procrustes import full_fp32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--img", default=None, help="single input image")
    p.add_argument("--imglist", default=None, help="directory of images")
    p.add_argument("--out_dir", default="demo_results")
    p.add_argument("--use_opendr", action="store_true", help="(compat flag; the shaded views are always rendered)")
    return p


def demo_outputs(run_model, smpl, renderer, faces, images: torch.Tensor, img_size: int) -> dict:
    """The body of JAX's jitted `infer` (`cli/demo.py:59-68`) on (B, S, S, 3)
    normalized images: `run_model` (the DaNet forward), the predicted IUV
    image, SMPL on the predicted parameters, its IUV render and its shaded
    views at yaw 0 and 90. Returns tensors: iuv_img (B, h, h, 3), part_iuv
    (B, 24, h, h, 3, 7; None for a model without `decomposed`), rendered
    (B, h, h, 3), para (B, 229), shaded and shaded_side (B, S, S)."""
    from danet_densepose2smpl_tpu_torch.kernels.rasterizer import render_shaded
    from danet_densepose2smpl_tpu_torch.ops.iuvmap import iuv_map2img
    from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward

    with record_function("demo.model"):
        out = run_model(images)
        iuv_img = iuv_map2img(*out["iuv_clean"])
        para = out["para"]
        verts = smpl_forward(smpl, para[:, 3:13], para[:, 13:].reshape(-1, 24, 3, 3)).vertices
    with record_function("demo.render"):
        cam = para[:, :3]
        rendered = renderer(verts, cam)
        shaded = render_shaded(verts, faces, cam, out_size=img_size, orig_size=float(img_size))
        side = render_shaded(verts, faces, cam, out_size=img_size, orig_size=float(img_size), yaw_deg=90.0)
    return {"iuv_img": iuv_img, "part_iuv": out.get("part_iuv_clean"), "rendered": rendered, "para": para,
            "shaded": shaded, "shaded_side": side}


def main(argv=None) -> list:
    """Parse `argv`, write one composite per input image, print the JAX
    line `path -> out  cam=[...]` for each, and return [{path, out_path,
    para, panels}] (panels: `utils/vis.py::demo_panels`)."""
    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.data.image_io import read_rgb
    from danet_densepose2smpl_tpu_torch.data.transforms import demo_frame
    from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
    from danet_densepose2smpl_tpu_torch.serve import Predictor, refuse_gt_modes
    from danet_densepose2smpl_tpu_torch.utils import vis

    args = build_parser().parse_args(argv)
    refuse_hmr(args, "cli.demo")
    device = resolve_device(args)
    cfg = load_config(args.cfg)
    refuse_gt_modes(cfg.danet, "cli.demo")
    smpl, atlas, _, _, _, _ = load_assets(args)
    model = build_model_and_params(args, cfg, device)
    predictor = Predictor(device, torch.bfloat16 if args.bf16 else torch.float32, smpl=smpl, model=model)
    size = cfg.danet.img_size
    renderer = IUVRenderer(atlas, orig_size=size, out_size=cfg.danet.heatmap_size)
    faces = torch.as_tensor(smpl.faces.astype(np.int64), device=device)
    fp32 = contextlib.nullcontext if args.bf16 else full_fp32

    paths = [args.img] if args.img else sorted(glob.glob(os.path.join(args.imglist or "examples", "*")))
    paths = [q for q in paths if q and q.lower().endswith((".jpg", ".jpeg", ".png"))]
    if not paths:
        raise SystemExit("no input images (use --img or --imglist)")
    os.makedirs(args.out_dir, exist_ok=True)

    results = []
    for path in paths:
        with record_function("demo.read"):
            norm = demo_frame(read_rgb(path), size)
            images = torch.from_numpy(norm[None]).to(device)
        with torch.inference_mode(), fp32():
            res = demo_outputs(predictor.run_model, predictor.smpl, renderer, faces, images, size)
        with record_function("demo.write"):
            host = {k: v[0].float().cpu().numpy() for k, v in res.items() if v is not None}
            parts = vis.partial_iuv_images(host["part_iuv"]) if "part_iuv" in host else None
            panels = vis.demo_panels(norm, host["iuv_img"], parts,
                                     host["rendered"], host["shaded"], host["shaded_side"])
            out_path = os.path.join(args.out_dir, os.path.splitext(os.path.basename(path))[0] + "_danet.png")
            vis.save_rows([[p for _, p in panels]], out_path)
        print(f"{path} -> {out_path}  cam={np.round(host['para'][:3], 3)}")
        results.append({"path": path, "out_path": out_path, "para": host["para"], "panels": panels})
    return results


if __name__ == "__main__":
    main()
