"""COCO keypoint evaluation harness (port of the JAX package's
`eval/coco_harness.py`; reference `eval_coco.py:46-173`).

Per batch: model inference -> SMPL joints -> the 24-GT-joint block ->
the COCO-17 selection (`J24_TO_JCOCO`) -> perspective projection to crop
pixels -> the inverse crop transform back to original-image coordinates
-> the OKS AP (`eval/metrics.keypoint_oks_ap`, a numpy COCOeval). The step
runs on the device of the `para` that `infer_fn` returns, in full fp32
(`full_fp32`: no TF32 in SMPL or the projection); the AP is host numpy.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.constants import FOCAL_LENGTH, IMG_RES, J24_TO_JCOCO
from danet_densepose2smpl_tpu_torch.data.transforms import get_transform
from danet_densepose2smpl_tpu_torch.eval.metrics import keypoint_oks_ap, rescore_detections
from danet_densepose2smpl_tpu_torch.ops.imwarp import grid_sample_bilinear
from danet_densepose2smpl_tpu_torch.ops.procrustes import full_fp32
from danet_densepose2smpl_tpu_torch.ops.projection import perspective_projection
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate


def transform_preds(coords: np.ndarray, center, scale, res) -> np.ndarray:
    """Crop-space pixel coords -> original-image coords (the float inverse
    of the crop transform; reference `utils/transforms.py:49-54`)."""
    t = np.linalg.inv(get_transform(center, scale, res))
    homo = np.concatenate([coords, np.ones((coords.shape[0], 1))], axis=1)
    return (homo @ t.T)[:, :2]


def make_coco_step(infer_fn, smpl: SMPLModel, img_res: int = IMG_RES, fg_conf: bool = False):
    """Batch step: images -> (COCO-17 crop-pixel keypoints (B, 17, 2),
    per-keypoint confidences (B, 17)).

    With `fg_conf`, `infer_fn` returns `(para, fg_prob)`, fg_prob the
    (B, S, S) predicted foreground probability (1 - P(background) of the
    25-channel part-index softmax); a keypoint's confidence is fg_prob
    sampled bilinearly at its projected position. Without it every
    confidence is 1, and the rescored score is the box score (the
    reference eval_coco.py's behaviour)."""
    on = {}

    @torch.inference_mode()
    def step(images):
        with annotate("coco.infer"):
            if fg_conf:
                para, fg_prob = infer_fn(images)
            else:
                para, fg_prob = infer_fn(images), None
        with annotate("coco.project"), full_fp32():
            key = (str(para.device), para.dtype)
            if key not in on:
                on[key] = (to_torch(smpl, para.device, para.dtype),
                           torch.as_tensor(J24_TO_JCOCO, dtype=torch.long, device=para.device))
            body, jcoco = on[key]
            cam = para[:, :3]
            out = smpl_forward(body, para[:, 3:13], para[:, 13:].reshape(-1, 24, 3, 3))
            j_coco = out.joints[:, 25:][:, jcoco]
            b = j_coco.shape[0]
            tz = 2.0 * FOCAL_LENGTH / (img_res * cam[:, 0] + 1e-9)
            cam_t = torch.stack([cam[:, 1], cam[:, 2], tz], dim=-1)
            eye = torch.eye(3, dtype=para.dtype, device=para.device).expand(b, 3, 3)
            kp = perspective_projection(j_coco, eye, cam_t, FOCAL_LENGTH,
                                        torch.zeros((b, 2), dtype=para.dtype, device=para.device)) + img_res / 2.0
            if fg_prob is None:
                conf = torch.ones(kp.shape[:2], dtype=kp.dtype, device=kp.device)
            else:
                grid = 2.0 * kp / img_res - 1.0                                     # (B, 17, 2)
                conf = grid_sample_bilinear(fg_prob.to(kp.dtype)[..., None], grid[:, :, None, :])[:, :, 0, 0]
            return kp, conf

    return step


def image_id_from_name(imgname: str) -> int:
    """COCO image id from a val2014 path: reference
    `coco_keypoint_dataset.py:312` parses `int(img_path[-16:-4])`; else any
    digits in the basename, else a hash of the basename (Python salts
    `hash` per process, so such ids differ between runs, as in the JAX
    package)."""
    base = os.path.basename(str(imgname))
    tail = str(imgname)[-16:-4]
    if tail.isdigit():
        return int(tail)
    m = re.search(r"(\d+)", base)
    if m:
        return int(m.group(1))
    return abs(hash(base)) % (1 << 31)


def load_coco_gt(gt_json: str) -> list:
    """Ground-truth list for `keypoint_oks_ap` from a COCO person-keypoints
    annotation json: the GT COCOeval sees (crowd and zero-keypoint
    annotations become ignore regions)."""
    with open(gt_json) as f:
        coco = json.load(f)
    person_ids = {c["id"] for c in coco.get("categories", []) if c.get("name", "person") == "person"}
    gts = []
    for ann in coco["annotations"]:
        if person_ids and ann.get("category_id") not in person_ids:
            continue
        kp = np.asarray(ann["keypoints"], dtype=np.float64).reshape(-1, 3)
        gts.append({
            "image_id": int(ann["image_id"]),
            "keypoints": kp,
            "area": float(ann["area"]),
            "bbox": [float(v) for v in ann["bbox"]],
            "iscrowd": int(ann.get("iscrowd", 0)),
        })
    return gts


def run_coco_eval(
    infer_fn,
    loader,
    smpl: SMPLModel,
    img_res: int = IMG_RES,
    log_every: int = 10,
    imgnames=None,
    gt_json: str | None = None,
    fg_conf: bool = False,
):
    """Returns (stats dict, all_preds (N, 17, 3) in original-image coords).

    Detections are grouped per COCO image (multi-person images evaluate
    jointly) and rescored per person by mean keypoint confidence x box
    score (reference `coco_keypoint_dataset.py:287-340`); `fg_conf` as in
    `make_coco_step`. GT comes from `gt_json` when given (the exact
    COCOeval ground truth, crowd regions included); otherwise it is rebuilt
    from the batches' keypoints with the box area from center / scale.

    `loader` yields (batch index, dict) with img (B, H, W, 3) normalized,
    center (B, 2), scale (B,), keypoints (B, 49, 3) in [-1, 1] crop coords
    and sample_index (B,) into `imgnames`."""
    step = make_coco_step(infer_fn, smpl, img_res, fg_conf=fg_conf)

    detections, gts_list = [], []
    all_preds = []
    n_done = 0
    for b, batch in loader:
        coords, confs = step(torch.as_tensor(np.asarray(batch["img"])))
        with annotate("coco.read"):
            coords, confs = coords.cpu().numpy(), confs.cpu().numpy()
        center = np.asarray(batch["center"])
        scale = np.asarray(batch["scale"])
        kp_gt = np.asarray(batch["keypoints"])  # (B, 49, 3) in [-1, 1]
        idxs = np.asarray(batch["sample_index"]) if "sample_index" in batch else np.arange(
            n_done, n_done + coords.shape[0])

        for i in range(coords.shape[0]):
            img_id = image_id_from_name(imgnames[int(idxs[i])]) if imgnames is not None else int(idxs[i])
            pred_orig = transform_preds(coords[i], center[i], float(scale[i]), (img_res, img_res))
            pred = np.concatenate([pred_orig, confs[i][:, None].astype(np.float64)], axis=1)
            all_preds.append(pred)
            detections.append({"image_id": img_id, "keypoints": pred, "box_score": 1.0})

            if gt_json is None:
                gt_coco = kp_gt[i, 25:][J24_TO_JCOCO].copy()
                gt_px = 0.5 * img_res * (gt_coco[:, :2] + 1.0)
                gt_orig = transform_preds(gt_px, center[i], float(scale[i]), (img_res, img_res))
                vis = (gt_coco[:, 2] > 0).astype(np.float64) * 2
                box = float(scale[i]) * 200.0
                gts_list.append({
                    "image_id": img_id,
                    "keypoints": np.concatenate([gt_orig, vis[:, None]], 1),
                    "area": float(box * box),
                    "bbox": [float(center[i][0] - box / 2), float(center[i][1] - box / 2), box, box],
                })

        n_done += coords.shape[0]
        if log_every and b % log_every == 0:
            print(f"coco eval batch {b}")

    if gt_json is not None:
        gts_list = load_coco_gt(gt_json)

    rescore_detections(detections)
    ap = keypoint_oks_ap(detections, gts_list)
    return ap, np.stack(all_preds) if all_preds else np.zeros((0, 17, 3))
