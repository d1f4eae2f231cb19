"""LSP silhouette / part segmentation eval (UP-3D protocol).

Port of the body of the JAX package's `cli/eval.py::run_lsp_eval`
(reference eval.py:218-266). Per batch: model inference -> SMPL -> the
224 x 224 [mask, part] render (`PartRenderer`) -> `uncrop` into each
image's original frame -> accuracy and per-class TP/FP/FN, counted on the
device in int64 and read on the log lines and at the end. With
`device_preprocess` the batches carry raw frames, cropped on the model's
device first (`data/pipeline.device_preprocess`).
"""

from __future__ import annotations

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.data.pipeline import device_preprocess as crop_on_device
from danet_densepose2smpl_tpu_torch.data.transforms import uncrop
from danet_densepose2smpl_tpu_torch.eval.metrics import SegmentationScores
from danet_densepose2smpl_tpu_torch.kernels.part_renderer import PartRenderer
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward, smpl_forward_aa
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate

IGNORE = 255   # the part label of pixels the reference leaves out


@torch.inference_mode()
def run_lsp_eval(infer_fn, loader, smpl: SMPLModel, img_size: int = 224, face_parts: np.ndarray | None = None,
                 backend: str = "auto", log_every: int = 10, device_preprocess: bool = False,
                 device=None) -> dict:
    """Score `loader`'s batches: an iterable of (batch index, dict) with img
    (B, H, W, 3) normalized (with `device_preprocess`: raw_img, uint8
    frames of one size, cropped on `device`), center (B, 2), scale (B,),
    orig_shape (B, 2) as (H, W), and either `gt_mask` and `gt_parts` (B
    label maps in original-image coordinates, the upi-s1h annotation PNGs
    as arrays; parts use 255 as ignore) or pose (B, 72) and betas (B, 10),
    whose rendered GT-SMPL masks are the loud fallback.

    `infer_fn(images) -> para (B, 229)` runs the model; everything after it
    runs on `para`'s device. `face_parts` and `backend` go to
    `PartRenderer`. Prints the reference's four "Final Results" lines and
    returns them as {name: value}. The stages of a batch carry spans
    (`utils.profiling.annotate`) lsp.crop / infer / render / uncrop /
    score for torch.profiler; nothing here turns it on."""
    if device_preprocess and device is None:
        raise ValueError("device_preprocess crops on the model's device: pass device=")
    if face_parts is not None:
        print("part labels: original cube_parts lookup")
    else:
        print("WARNING: --vertex_texture/--cube_parts not given; using "
              "LBS-argmax part labels (part boundaries differ from the "
              "reference's cube_parts.npy lookup)")
    renderer = PartRenderer(smpl, img_size=img_size, face_parts=face_parts, backend=backend)
    masks = SegmentationScores(2)
    parts = SegmentationScores(7)            # TP/FP/FN over the pixels not ignored
    parts_correct, parts_total = 0, 0        # accuracy with ignore read as background
    tables, warned = {}, False

    for b, batch in loader:
        if device_preprocess:
            with annotate("lsp.crop"):
                images = crop_on_device(torch.as_tensor(np.asarray(batch["raw_img"])).to(device),
                                        torch.as_tensor(np.asarray(batch["center"])),
                                        torch.as_tensor(np.asarray(batch["scale"])))
        else:
            images = torch.as_tensor(np.asarray(batch["img"]))
        with annotate("lsp.infer"):
            para = infer_fn(images)
        dev = para.device
        key = (str(dev), para.dtype)
        if key not in tables:
            tables[key] = to_torch(smpl, dev, para.dtype)
        body = tables[key]
        have_gt = "gt_mask" in batch and "gt_parts" in batch
        if not have_gt and not warned:
            print("WARNING: no --annot_dir / maskname+partname columns — falling "
                  "back to rendered GT-SMPL masks. This is NOT the reference's "
                  "LSP protocol; numbers are not comparable to eval.py.")
            warned = True

        with annotate("lsp.render"):
            out = smpl_forward(body, para[:, 3:13], para[:, 13:].reshape(-1, 24, 3, 3))
            mask, part = renderer(out.vertices, para[:, :3])
            if not have_gt:
                def gt(a):
                    return torch.as_tensor(np.asarray(a), device=dev).to(para.dtype)

                gt_body = smpl_forward_aa(body, gt(batch["betas"]), gt(batch["pose"]))
                gt_mask_r, gt_parts_r = renderer(gt_body.vertices, para[:, :3])
        with annotate("lsp.uncrop"):
            frame = (batch["center"], batch["scale"], batch["orig_shape"])
            pred_mask = [m > 0 for m in uncrop(mask.to(torch.uint8), *frame)]
            pred_parts = uncrop(part.to(torch.uint8), *frame)
            if have_gt:
                gt_mask = [torch.as_tensor(np.asarray(m), device=dev) > 0 for m in batch["gt_mask"]]
                gt_parts = [torch.as_tensor(np.asarray(p), device=dev) for p in batch["gt_parts"]]
            else:
                gt_mask = [m > 0 for m in uncrop(gt_mask_r.to(torch.uint8), *frame)]
                gt_parts = uncrop(gt_parts_r.to(torch.uint8), *frame)

        with annotate("lsp.score"):
            for pm, gm, pp, gp in zip(pred_mask, gt_mask, pred_parts, gt_parts):
                masks.update(pm, gm)
                gp, pp = gp.long(), pp.long()
                parts.update(pp, gp, keep=gp != IGNORE)
                parts_correct = parts_correct + (gp.masked_fill(gp == IGNORE, 0)
                                                 == pp.masked_fill(pp == IGNORE, 0)).sum()
                parts_total += gp.numel()

        if log_every and b % log_every == log_every - 1:
            print(f"batch {b}: accuracy {masks.accuracy:.4f}  F1 {masks.f1.mean():.4f}")

    results = {
        "Accuracy": masks.accuracy,
        "F1": float(masks.f1.mean()),
        "Parts Accuracy": float(int(parts_correct) / max(parts_total, 1)),
        "Parts F1 (BG)": float(parts.f1.mean()),
    }
    print("*** Final Results ***")
    for name, value in results.items():
        print(f"{name}: {value:.6f}")
    return results
